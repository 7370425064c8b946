"""Incremental capacity-probe session: encode once, probe many candidates.

Port of `open_simulator_tpu/simulator/probe.py`. The capacity planner's search
asks one question repeatedly: would this pod batch schedule on base + n copies
of the template node? Successive candidates differ only in how many copies of
ONE identical node exist, so a session pays the expensive work once:

- **Encode once.** One Simulator over base + n0 template copies (n0 sized to
  the node-padding bucket, so the phantom pad columns become real template
  columns); bound pods commit once; the unbound run is encoded once
  (`encode_batch_raw`) and its tables move to the device once.
- **Candidate = mask flip.** Candidate n activates the base nodes and the
  first n template columns. The fan-out kernels (ops/kernels.py
  `probe_*_fanout`) fold the mask into static_mask, which makes an inactive
  node a `pad_batch_tables` phantom.
- **Fan-out.** Up to `fanout` candidates run in one dispatch per segment, one
  lane each (K2-K5 over lanes on the card), and one fetch ends the round.
  On a scenario mesh (parallel/mesh.py; taken by itself when the process
  group has more than one rank, as JAX's `_auto_mesh` takes one over the
  devices) each rank stages and runs its block of the lanes, and the fetch
  gathers `placed` and `requested` once each.
- **Growth.** When the search outgrows the encoded bucket, the template axis
  grows by appending copies of the pre-encoded template column: on the device
  (ops/kernels.py `extend_tables_on_device`, K6) when no hostname-keyed counter or carrier row
  exists, else by re-padding on the host and uploading again.

Equivalence gates (`try_build` returns None, and the planner keeps its
fresh-Simulator probes, when any fails): no topologySpreadConstraints (the
eligible-domain sets depend on which nodes exist), no node-advertised images
(ImageLocality divides by the node count), no Open-Local storage, no pre-bound
pod after an unbound one, and every encoded template column bit-identical
across the copies with zero seeds (`_template_columns_uniform`).

With the flight recorder on (obs/xray.py), each `probe_many` round commits
one probe record per candidate (counts only: a session never materializes
placements).

Not ported: the watchdog, fault sites, rollback transaction and metrics
(A9).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.fakenode import new_fake_nodes
from ..ops import kernels
from ..ops.resources import CPU_I, MEM_I
from .encode import (
    HOSTNAME,
    BatchTables,
    bucket_capped,
    extend_node_axis,
    pad_batch_tables,
    pad_encoder_axes,
    plugin_flags,
)

# [G, N] tables whose template columns must be copy-invariant (and are
# replicated verbatim by extend_node_axis).
_GN_FIELDS = (
    "static_mask", "mask_taint", "mask_unsched", "mask_aff", "mask_extra",
    "simon_raw", "nodeaff_raw", "taint_raw", "avoid_raw", "image_raw",
    "extra_raw",
)
# [N, *] node matrices with the same invariant.
_NROW_FIELDS = ("alloc", "dev_total", "vg_cap", "vg_nameid", "sdev_cap",
                "sdev_media")
# [N, *] seed rows that must be ZERO on template columns (no bound pod can
# name a randomly generated fake node).
_NSEED_FIELDS = ("seed_requested", "seed_nonzero", "seed_port_used",
                 "seed_dev_used", "seed_vg_req", "seed_sdev_alloc")


class ProbeSession:
    """Device-resident incremental prober for one (base, template, pods) search."""

    def __init__(self) -> None:  # built via try_build only
        raise TypeError("use ProbeSession.try_build")

    # ------------------------------------------------------------- build ------

    @classmethod
    def try_build(cls, base_nodes: List[dict], new_node: Optional[dict],
                  pods: List[dict], cluster_objects=None,
                  app_objects: Sequence = (), n_new: int = 2, fanout: int = 8,
                  device=None, mesh=None, sched_config=None) -> Optional["ProbeSession"]:
        """Build a session able to probe up to (at least) n_new template
        copies on `device` ("cuda", the default, or "cpu"), or None when the
        workload fails an equivalence gate. `mesh`: a scenario mesh on that
        device (parallel/mesh.py); None takes one over every rank when the
        process group has more than one (`auto_scenario_mesh`, JAX's
        `_auto_mesh` rule)."""
        from .engine import Simulator

        if new_node is None:
            return None
        t0 = time.perf_counter()
        n_base = len(base_nodes)
        # the phantom pad columns a fresh probe would carry anyway become
        # real, probe-able template columns
        n0 = max(2, int(n_new))
        n0 = bucket_capped(n_base + n0, 1024) - n_base
        sim = Simulator(base_nodes + new_fake_nodes(new_node, n0), device=device, use_mesh=False,
                        sched_config=sched_config)
        if cluster_objects is not None:
            sim.register_cluster_objects(cluster_objects)
        for rt in app_objects:
            sim.register_app_objects(rt)
        if sim.local_host.enabled:
            return None  # open-local envelope accounting (planner gate too)
        if any((n.get("status") or {}).get("images") for n in sim.na.nodes):
            return None  # ImageLocality divides by the TOTAL node count
        if mesh is not None and mesh.device != sim.device:
            raise ValueError(f"the mesh is on {mesh.device}, the session on {sim.device}")
        return cls._try_build_encoded(sim, t0, n_base, n0, pods, fanout, mesh)

    @classmethod
    def _try_build_encoded(cls, sim, t0, n_base, n0, pods, fanout, mesh):
        # Bound pods commit once (cluster state every candidate shares); the
        # unbound remainder becomes the one encoded run.
        from ..parallel.mesh import auto_scenario_mesh
        from ..utils.objutil import pod_resource_requests

        run: List[dict] = []
        bound_scheduled = 0
        bound_cpu = bound_mem = 0.0
        homeless = 0
        for pod in pods:
            node_name = (pod.get("spec") or {}).get("nodeName")
            if not node_name:
                run.append(pod)
                continue
            if run:
                return None  # bound-after-unbound: probe order-inequivalent
            ni = sim.na.index.get(node_name)
            if ni is None:
                homeless += 1
                sim.homeless.append(pod)
            else:
                sim._commit_pod(pod, ni, scheduled=False)
                bound_scheduled += 1
                req = pod_resource_requests(pod)
                bound_cpu += req.get("cpu", 0.0)
                bound_mem += req.get("memory", 0.0)

        self = object.__new__(cls)
        self._sim = sim
        self.device = sim.device
        self.fanout = int(fanout)
        self.n_base = n_base
        self.n_new = n0
        self.bound_scheduled = bound_scheduled
        self._bound_cpu = bound_cpu
        self._bound_mem = bound_mem
        self.total_known = len(pods) - homeless
        self._run_len = len(run)
        self.encodes = 0
        self.extensions = 0
        self.device_extensions = 0  # extensions that grew the tables on the device
        self.uploads = 0
        self._alloc = np.array(sim.na.alloc, np.float64)
        # any rank count works: a round pads its lanes to a multiple of it
        self._mesh = mesh if mesh is not None else auto_scenario_mesh(sim.device)

        if not run:
            # trivial probes: host arithmetic only (probe_utilization reads
            # a missing carry as zeros)
            self._bt_raw = None
            self._segs = []
            self.encode_s = time.perf_counter() - t0
            return self

        # the census gate BEFORE the (dominant) batch encode: spread
        # constraints reject the session anyway
        if any((p.get("spec") or {}).get("topologySpreadConstraints") for p in run):
            return None

        bt_raw = sim.encode_batch_raw(run)
        self.encodes = 1
        P = len(run)
        for gi in set(np.asarray(bt_raw.pod_group[:P]).tolist()):
            g = sim.encoder.group_list[gi]
            if g.spread_dns or g.spread_sa:
                return None  # eligible-domain sets depend on the node census
        enc = sim.encoder
        self._host_counters = [t for t, cs in enumerate(enc.counter_list)
                               if cs.topo_key == HOSTNAME]
        self._host_carriers = [t for t, cs in enumerate(enc.carrier_list)
                               if cs.topo_key == HOSTNAME]
        if not _template_columns_uniform(bt_raw, n_base, self._host_counters,
                                         self._host_carriers):
            return None
        self._bt_raw = bt_raw
        self._segs = sim._segments(bt_raw, P) if sim.use_waves else [("serial", 0, P)]
        self._upload()
        self.encode_s = time.perf_counter() - t0
        return self

    # ------------------------------------------------------------ upload ------

    def _upload(self) -> None:
        """(Re-)pad the tables and move them to the device."""
        bt = pad_encoder_axes(self._bt_raw)
        bt = pad_batch_tables(bt, bucket_capped(self.n_base + self.n_new, 1024))
        self._set_host_mirror(bt)
        self._tables = kernels.tables_from_batch(bt, self.device)
        self.uploads += 1

    def _set_host_mirror(self, bt: BatchTables) -> None:
        """The padded host tables (dispatch dims, pod arrays), the seed carry
        on the device (each dispatch broadcasts it over S lanes) and the
        plugin flags."""
        self._bt = bt
        self._n_pad = bt.alloc.shape[0]
        self._seed = kernels.carry_from_batch(bt, self.device)
        self._flags = plugin_flags(bt)

    # ---------------------------------------------------------- extension -----

    def ensure_capacity(self, n: int) -> None:
        """Grow the template axis to cover candidate n by appending
        pre-encoded template columns (no re-encode). Without hostname-keyed
        counter or carrier rows the tables grow on the device (K6); with
        them, the domain axis widens and the tables upload again."""
        if n <= self.n_new:
            return
        target = bucket_capped(self.n_base + n, 1024)
        k = target - (self.n_base + self.n_new)
        n_real_old = self.n_base + self.n_new
        if self._bt_raw is not None:
            self._bt_raw = extend_node_axis(
                self._bt_raw, k, self.n_base,
                self._host_counters, self._host_carriers)
        self._alloc = np.concatenate(
            [self._alloc,
             np.repeat(self._alloc[self.n_base:self.n_base + 1], k, axis=0)])
        self.n_new += k
        self.extensions += 1
        if self._bt_raw is None:
            return
        if not self._host_counters and not self._host_carriers:
            self._extend_device(k, n_real_old)
        else:
            self._upload()

    def _extend_device(self, k: int, n_real_old: int) -> None:
        """Growth without a table upload: re-pad the host mirror (seeds and
        dispatch dims read it) and extend the device tables from their own
        template column."""
        bt = pad_encoder_axes(self._bt_raw)
        bt = pad_batch_tables(bt, bucket_capped(self.n_base + self.n_new, 1024))
        sentinel = bt.seed_counter.shape[1] - 1
        if sentinel != self._bt.seed_counter.shape[1] - 1:
            # the no-hostname gate makes this unreachable (the domain axis
            # cannot widen); should an encoder change break that, re-upload
            # rather than corrupt the resident tables
            self._upload()
            return
        self._set_host_mirror(bt)
        self._tables = kernels.extend_tables_on_device(
            self._tables, n_real=n_real_old, k=k, template_col=self.n_base,
            n_pad_new=self._n_pad, sentinel=sentinel)
        self.device_extensions += 1

    # ------------------------------------------------------------ probing -----

    def batch_totals(self) -> Tuple[float, float, int]:
        """(cpu_used, mem_used, n_pods) over the pods the simulation accounts
        (known-bound + unbound; homeless excluded): the planner's lower-bound
        inputs, from one f64 template-request lookup per encoded GROUP scaled
        by its pod count (requests within a group are identical)."""
        from ..utils.objutil import pod_resource_requests

        cpu, mem = self._bound_cpu, self._bound_mem
        if self._bt_raw is not None and self._run_len:
            groups = self._sim.encoder.group_list
            counts = np.bincount(
                np.asarray(self._bt_raw.pod_group[:self._run_len]),
                minlength=len(groups))
            for gi, c in enumerate(counts.tolist()):
                if not c:
                    continue
                req = pod_resource_requests(groups[gi].template)
                cpu += c * req.get("cpu", 0.0)
                mem += c * req.get("memory", 0.0)
        return cpu, mem, self.total_known

    def probe_many(self, ns: Sequence[int]) -> Dict[int, Tuple[int, int, Dict[str, float]]]:
        """Evaluate candidate node counts in ONE round of dispatches. Returns
        {n: (scheduled, total, utilization)} with the semantics of
        Simulator.probe_pods + probe_utilization on a fresh simulator at n.
        len(set(ns)) must be <= fanout and every n <= current capacity."""
        order: List[int] = []
        for n in ns:
            if n not in order:
                order.append(n)
        if not order:
            return {}
        if len(order) > self.fanout:
            raise ValueError(f"{len(order)} candidates > fanout {self.fanout}")
        bad = [n for n in order if n > self.n_new]
        if bad:
            raise ValueError(f"candidates {bad} exceed capacity {self.n_new}")
        if not self._segs:  # no unbound pods: host arithmetic only
            return {n: (self.bound_scheduled, self.total_known,
                        self._utilization(n, None)) for n in order}
        # lane counts quantize to powers of two (1, 2, 4, 8), as in the JAX
        # session (whose every distinct S is a compile): surplus lanes repeat
        # the last candidate and are sliced off
        S = 1
        while S < len(order):
            S *= 2
        lanes = order + [order[-1]] * (S - len(order))
        active_s = np.zeros((S, self._n_pad), bool)
        for i, n in enumerate(lanes):
            active_s[i, :self.n_base + n] = True
        placed_s, requested_s = self._dispatch_round(active_s)
        out: Dict[int, Tuple[int, int, Dict[str, float]]] = {}
        for i, n in enumerate(order):
            scheduled = self.bound_scheduled + int(placed_s[i])
            out[n] = (scheduled, self.total_known, self._utilization(n, requested_s[i]))
        self._xray_probes(out)
        return out

    def _xray_probes(self, out) -> None:
        """simonxray ride-along: one probe record per candidate evaluated by
        this round (counts only), tagged with the session's device."""
        from ..obs import xray

        run = xray.begin_run("probe_session")
        if run is None:
            return
        for n, (scheduled, total, _) in sorted(out.items()):
            run.add_probe(scheduled, total, candidate=n)
        xray.commit_run(run, [self.device.type])

    def _dispatch_round(self, active_s: np.ndarray):
        """One fan-out per segment, chained from the seed carry broadcast
        over the lanes, and ONE fetch: (placed [S], requested [S, N, R]) as
        numpy. On a scenario mesh the lanes pad to a multiple of the
        scenario axis (repeating the last candidate, as JAX's session), this
        rank stages and runs its block of them, and the fetch gathers every
        lane; the padding is sliced off."""
        from ..parallel.mesh import fanout_namespace, fetch_lanes, lane_block

        mesh = self._mesh
        S = active_s.shape[0]
        if mesh is not None and S % mesh.scenarios:
            extra = mesh.padded_lanes(S) - S
            active_s = np.concatenate([active_s, np.repeat(active_s[-1:], extra, axis=0)])
        blk = lane_block(mesh, active_s.shape[0])
        carry_s = kernels.carry_lanes(self._seed, blk.stop - blk.start)
        active = torch.from_numpy(np.ascontiguousarray(active_s[blk])).to(self.device)
        kns = fanout_namespace(mesh)
        placed_parts = []
        for seg in self._segs:
            name, args, kwargs = self.fanout_call(seg)
            carry_s, placed = getattr(kns, name)(self._tables, carry_s, active, *args, **kwargs)
            placed_parts.append(placed)
        placed_s, requested_s = fetch_lanes(mesh, torch.stack(placed_parts).sum(dim=0),
                                            carry_s.requested)
        return placed_s[:S], requested_s[:S]

    def fanout_call(self, seg: tuple) -> Tuple[str, tuple, dict]:
        """(fan-out name, arguments after (tables, carry_s, active_s), keyword
        arguments) of one segment's dispatch: every input is shared by the
        lanes (the candidates differ only in their active rows)."""
        sim, bt = self._sim, self._bt
        enable_gpu, enable_storage = self._flags
        n_real = self.n_base + self.n_new
        kw = dict(w=sim.score_w, filters=sim.filter_flags)
        kind, start, length = seg[:3]
        if kind == "serial":
            pad = bucket_capped(length, 2048)
            pg = np.zeros(pad, np.int32)
            pg[:length] = bt.pod_group[start:start + length]
            fn = np.full(pad, -1, np.int32)
            fn[:length] = bt.forced_node[start:start + length]
            vd = np.zeros(pad, bool)
            vd[:length] = True
            return ("probe_serial_fanout",
                    (torch.from_numpy(pg), torch.from_numpy(fn), torch.from_numpy(vd)),
                    dict(kw, n_zones=bt.n_zones, enable_gpu=enable_gpu,
                         enable_storage=enable_storage))
        g, cap1 = seg[3], bool(seg[4])
        if kind == "spread":
            # dns/sa groups are gated out at build: only a live
            # SelectorSpread counter routes here
            ss_live, sa_live = seg[5], seg[6]
            vd = np.zeros(bucket_capped(length, 2048), bool)
            vd[:length] = True
            return ("probe_group_serial_fanout", (g, torch.from_numpy(vd), cap1),
                    dict(kw, ss_live=ss_live, sa_live=sa_live,
                         n_zones=bt.n_zones if ss_live else 2))
        block = kernels.wave_block_for(length, n_real)
        if kind == "affinity":
            ss_live = seg[5]
            return ("probe_affinity_wave_fanout", (g, length, cap1),
                    dict(kw, ss_live=ss_live, block=block, n_zones=bt.n_zones if ss_live else 2))
        return ("probe_wave_fanout", (g, length, cap1),
                dict(kw, gpu_live=seg[5], block=block,
                     kmax=kernels.wave_kmax(length, n_real, block)))

    def _utilization(self, n: int, requested_row: Optional[np.ndarray]) -> Dict[str, float]:
        """probe_utilization's aggregate totals for candidate n: f64 host sums
        over the per-node values a fresh probe would fetch (inactive and
        phantom columns hold zero and are sliced off anyway)."""
        m = self.n_base + n
        if requested_row is None:
            used = np.zeros((m, self._alloc.shape[1]), np.float64)
        else:
            used = requested_row[:m].astype(np.float64)
        alloc = self._alloc[:m]
        return {
            "cpu_used": float(used[:, CPU_I].sum()),
            "cpu_alloc": float(alloc[:, CPU_I].sum()),
            "mem_used": float(used[:, MEM_I].sum()),
            "mem_alloc": float(alloc[:, MEM_I].sum()),
        }


def _template_columns_uniform(bt: BatchTables, n_base: int,
                              host_counters: Sequence[int],
                              host_carriers: Sequence[int]) -> bool:
    """Verify every encoded table treats the template copies identically:
    columns n_base.. of each [G, N]/[N, *] table equal the first template
    column (hostname-keyed domain rows excepted: those are per-node by
    construction), and template seed rows are zero."""
    b = n_base
    for f in _GN_FIELDS:
        a = getattr(bt, f)
        if not (a[:, b + 1:] == a[:, b:b + 1]).all():
            return False
    for f in _NROW_FIELDS:
        a = getattr(bt, f)
        if not (a[b + 1:] == a[b:b + 1]).all():
            return False
    if not (bt.node_zone[b + 1:] == bt.node_zone[b]).all():
        return False
    for dom, host_rows in ((bt.counter_dom, host_counters),
                           (bt.carr_dom, host_carriers)):
        rest = np.ones(dom.shape[0], bool)
        rest[list(host_rows)] = False
        if not (dom[rest][:, b + 1:] == dom[rest][:, b:b + 1]).all():
            return False
    for f in _NSEED_FIELDS:
        if getattr(bt, f)[b:].any():
            return False
    return True
