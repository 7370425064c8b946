"""The resident cluster image and its what-if sessions, on one device.

Port of `open_simulator_tpu/serve/image.py`. The reference's server mode
rebuilds and re-simulates the whole cluster for every request; this module
keeps ONE encoded image of the live cluster resident on the device:

- **Stage once.** One Simulator owns the cluster; bound pods commit once; the
  node-side tables encode once and move to the device once
  (`_upload_tables`). The host keeps the carry SEEDS (small [N, *] and
  [T, D+1] arrays); every what-if dispatch broadcasts them over its request
  lanes, so the image itself is never an input a dispatch writes.
- **Delta ingest, not re-encode.** `apply_events`: a `pod_add` /
  `pod_delete` touches the placed-pod registry and re-aggregates the seeds
  (the [G, N] tables do not depend on placed pods); a `node_add` extends the
  NodeArrays in place and re-derives the node-axis tables; a `node_drain`
  flips one bit of the live-node mask and evicts the node's pods from the
  seeds. An event the delta path cannot express re-encodes from scratch.
- **Epoch.** Every applied event batch bumps `seq`; a from-scratch re-encode
  bumps `generation`, which invalidates the encoded group ids of older
  sessions (they re-encode, or `run()` refuses them).
- **Read-only tables.** The lane kernels clone the carry they write and only
  read the tables; `assert_image_alive` checks after every dispatch that no
  image table nor cached base carry was written in place (its `data_ptr()`
  and `_version` are unchanged), the torch counterpart of the JAX package's
  guard against buffer donation.

Equivalence gates (as in the JAX package): the image declines clusters with
node-advertised images (ImageLocality divides by the total node count),
Open-Local storage or GPU-share state (host-mirrored ledgers the delta path
does not replay); per-request gates (`eligible`) route census-dependent
workloads (topology spread, live SelectorSpread, gpu/storage requests,
pre-bound pods) to the fresh-simulation path. Within those gates a
masked-inactive node is exactly a pad_batch_tables phantom, so a resident
lane equals a fresh encode of the final cluster state.

A dispatch partitions its sessions into the wave lane (one group, no pin:
`kernels.serve_wave_fanout`, K3 and K3c over lanes on the card) and the
serial lane (`kernels.serve_whatif_fanout` over the union batch, K2 over
lanes). The image lives on the device named at `try_build` (the card by
default; "cpu" runs the plain versions). On a scenario mesh
(parallel/mesh.py; taken by itself when the process group has more than
one rank, as JAX's `_auto_mesh` takes one over the devices) every rank holds
the whole image and stages and runs only its block of each dispatch's
lanes; the fetch gathers `placed` and `requested` once each, so every rank
returns the same responses.

With the flight recorder on (obs/xray.py), each `dispatch_sessions` call
commits one probe record per session (counts only).

Not ported: the watchdog, fault sites, scope spans and metrics (ROADMAP A9),
and the micro-batching service, HA state and watch sync built on this image
(A10b). A `sched_config` (api/schedconfig.py) reaches the image's Simulator,
its rebuilds and the fresh Simulators of `fresh_simulator`. The port donates no carry on a mesh
or off it (the lane kernels clone the carry they write), so the base carry
is cached on every mesh, where JAX caches it only where it does not donate.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.resources import CPU_I, MEM_I
from ..simulator.encode import (
    BatchTables,
    bucket_capped,
    build_node_axis_tables,
    build_pod_axis_tables,
    pad_batch_tables,
    pad_encoder_axes,
)
from ..utils.objutil import name_of, namespaced_name as pod_key


class StaleImageError(RuntimeError):
    """A session encoded against an image generation that no longer exists
    (the image re-encoded from scratch underneath it)."""


class ImageDonatedError(AssertionError):
    """A dispatch wrote a shared cluster-image table or the cached base
    carry in place."""


class WhatIfSession:
    """One copy-on-write what-if overlay on a shared ResidentImage: the
    request's pods (encoded to group ids) and request-local node drains,
    captured at an image epoch. Sessions never change the image: the overlay
    is an active-mask row plus a per-lane valid mask plus (for drains) a
    privately adjusted seed copy, all assembled at dispatch time."""

    def __init__(self, image: "ResidentImage", pods, drains: Sequence[str]) -> None:
        self.image = image
        self.pods = list(pods)
        self.drains = tuple(drains)
        self.generation = image.generation
        self.seq = image.seq
        self.batch = image.encode_request(self.pods)

    def ensure_current(self) -> None:
        """Re-encode after a generation move (group ids mean something only
        within one generation); seq moves are fine: a dispatch reads the
        image's current staged tables, and group ids are append-only."""
        if self.generation != self.image.generation:
            self.generation = self.image.generation
            self.seq = self.image.seq
            self.batch = self.image.encode_request(self.pods)

    def run(self) -> dict:
        """Probe this session alone (one lane). It refuses a stale generation
        instead of re-encoding silently."""
        if self.generation != self.image.generation:
            raise StaleImageError(
                f"image re-encoded (generation {self.image.generation} != "
                f"session {self.generation}); rebuild the session")
        return self.image.dispatch_sessions([self])[0]


class ResidentImage:
    """Device-resident encoded cluster state + delta ingest. Build via
    try_build; None means an equivalence gate declined the cluster."""

    def __init__(self) -> None:  # built via try_build only
        raise TypeError("use ResidentImage.try_build")

    # ------------------------------------------------------------- build ------

    @classmethod
    def try_build(cls, nodes: List[dict], cluster_objects=None, pods: Sequence[dict] = (),
                  sched_config=None, mesh=None, device=None) -> Optional["ResidentImage"]:
        """The image of `nodes` with the bound pods of `pods` committed, on
        `device` ("cuda", the default, or "cpu"); None when a gate declines.
        `mesh`: a scenario mesh on that device (parallel/mesh.py); None
        takes one over every rank when the process group has more than one
        (`auto_scenario_mesh`, JAX's `_auto_mesh` rule)."""
        from ..parallel.mesh import auto_scenario_mesh
        from ..simulator.engine import Simulator

        sim = Simulator(list(nodes), device=device, use_mesh=False, sched_config=sched_config)
        if mesh is not None and mesh.device != sim.device:
            raise ValueError(f"the mesh is on {mesh.device}, the image on {sim.device}")
        if cluster_objects is not None:
            sim.register_cluster_objects(cluster_objects)
        if sim.local_host.enabled or sim.gpu_host.enabled:
            return None  # host-mirrored storage/gpu ledgers: the delta path
            # does not replay reserve()/seed_pod() bookkeeping
        if any((n.get("status") or {}).get("images") for n in sim.na.nodes):
            return None  # ImageLocality divides by the TOTAL node count

        self = object.__new__(cls)
        self._sim = sim
        self.device = sim.device
        self._mesh = mesh if mesh is not None else auto_scenario_mesh(sim.device)
        self._lock = threading.RLock()
        self.generation = 1
        self.seq = 0
        self._pod_index: Dict[str, Tuple[dict, int]] = {}
        self.drained: set = set()
        for pod in pods:
            node_name = (pod.get("spec") or {}).get("nodeName")
            if not node_name:
                # unbound snapshot pods are request material, not cluster state
                continue
            ni = sim.na.index.get(node_name)
            if ni is None:
                sim.homeless.append(pod)
            else:
                sim._commit_pod(pod, ni, scheduled=False)
                self._pod_index[pod_key(pod)] = (pod, ni)
        self._restage()
        return self

    # ------------------------------------------------------------ staging -----

    def _stage_sig(self) -> tuple:
        enc = self._sim.encoder
        return (len(enc.group_list), len(enc.counter_list), len(enc.carrier_list),
                len(enc.ports), self._sim.na.D, self._sim.na.N)

    def _unpadded_bt(self) -> BatchTables:
        sim = self._sim
        return BatchTables(
            **build_pod_axis_tables(sim.encoder, [], pad_to=8),
            **build_node_axis_tables(sim.encoder, sim.placed, sim.match_cache))

    def _restage(self) -> None:
        """Rebuild the host mirror and upload the device tables again."""
        sim = self._sim
        btp = pad_batch_tables(pad_encoder_axes(self._unpadded_bt()),
                               bucket_capped(sim.na.N, 1024))
        self._bt = btp
        self._n_pad = btp.alloc.shape[0]
        self._staged_sig = self._stage_sig()
        self._upload_tables(btp)
        self._set_seeds(btp)
        self._carry_devcache: Dict[int, kernels.Carry] = {}
        self._alloc = np.array(sim.na.alloc, np.float64)
        active = np.zeros(self._n_pad, bool)
        active[:sim.na.N] = True
        for name in self.drained:
            ni = sim.na.index.get(name)
            if ni is not None:
                active[ni] = False
        self.active = active

    def _upload_tables(self, btp: BatchTables) -> None:
        self._tables = kernels.tables_from_batch(btp, self.device)
        self._table_stamps = _stamps(self._tables)

    def _set_seeds(self, btp: BatchTables) -> None:
        self._seeds = tuple(getattr(btp, "seed_" + f) for f in kernels.Carry._fields)

    def _refresh_seeds(self) -> None:
        """Pod-churn refresh: the [G, N] tables do not depend on placed pods
        (build_node_axis_tables derives them from the group statics alone),
        so only the carry seeds re-aggregate from the placed registry; no
        table moves to the device."""
        sim = self._sim
        btp = pad_batch_tables(pad_encoder_axes(self._unpadded_bt()),
                               bucket_capped(sim.na.N, 1024))
        self._bt = btp
        self._set_seeds(btp)
        self._carry_devcache = {}

    def ensure_staged(self) -> None:
        """Upload the tables again when the encoder axes moved since the
        stage (a request interned a new group, counter or port)."""
        with self._lock:
            if self._stage_sig() != self._staged_sig:
                self._restage()

    # -------------------------------------------------------------- epoch -----

    @property
    def epoch(self) -> str:
        return f"{self.generation}.{self.seq}"

    @property
    def n_nodes(self) -> int:
        """Live (non-drained) node count."""
        return int(self.active[:self._sim.na.N].sum())

    # ------------------------------------------------------------- ingest -----

    def apply_events(self, events: Sequence[dict]) -> dict:
        """Apply one batch of live watch-event deltas; bumps the epoch once.
        Event kinds (each a dict with "type"):

        - pod_add:    {"pod": {... spec.nodeName set}}: commits into the seeds;
        - pod_delete: {"namespace": ..., "name": ...} (or "key");
        - node_add:   {"node": {...}}: NodeArrays extension, node-table
                      re-derive, device re-stage;
        - node_drain: {"name": ...} (or node_delete): the node leaves the
                      schedulable set and its pods leave the seeds.

        Returns {"epoch", "applied", "skipped", "restaged"}. Events the
        delta path cannot express (a new resource axis, a duplicate node
        name) force a from-scratch re-encode (generation bump)."""
        applied = skipped = 0
        with self._lock:
            seeds_dirty = False
            restage_cause: Optional[str] = None
            rebuild = False
            try:
                for ev in events:
                    ok, sd, rc, rb = self._apply_one(ev.get("type", ""), ev)
                    applied += 1 if ok else 0
                    skipped += 0 if ok else 1
                    seeds_dirty |= sd
                    rebuild |= rb
                    if rc:
                        restage_cause = rc
                self.seq += 1
                if rebuild:
                    self._rebuild()
                elif restage_cause is not None:
                    self._restage()
                elif seeds_dirty:
                    self._refresh_seeds()
            except BaseException:
                # never leave a half-applied image: re-encode from the host
                # truth before propagating
                self.seq += 1
                self._rebuild()
                raise
            return {"epoch": self.epoch, "applied": applied, "skipped": skipped,
                    "restaged": rebuild or restage_cause is not None}

    def _apply_one(self, kind: str, ev: dict):
        """(applied, seeds_dirty, restage_cause, rebuild)"""
        sim = self._sim
        if kind == "pod_add":
            pod = ev.get("pod") or {}
            node_name = (pod.get("spec") or {}).get("nodeName")
            ni = sim.na.index.get(node_name) if node_name else None
            if ni is None or not self.active[ni]:
                sim.homeless.append(pod)
                return False, False, None, False
            sim._commit_pod(pod, ni, scheduled=False)
            self._pod_index[pod_key(pod)] = (pod, ni)
            return True, True, None, False
        if kind == "pod_delete":
            key = ev.get("key") or f"{ev.get('namespace', 'default')}/{ev.get('name', '')}"
            got = self._pod_index.pop(key, None)
            if got is None:
                return False, False, None, False
            self._remove_pod(*got)
            return True, True, None, False
        if kind == "node_add":
            node = ev.get("node") or {}
            name = name_of(node)
            if not name or name in sim.na.index:
                return True, False, None, True  # duplicate/unnamed: rebuild
            alloc = ((node.get("status") or {}).get("allocatable") or {})
            if any(k not in sim.axis.names for k in alloc):
                return True, False, None, True  # new resource axis: rebuild
            self._extend_nodes([node])
            # keep the live mask current within the batch: a later event of
            # this batch (pod_add onto / drain of the new node) sees it live
            ni = sim.na.index[name]
            if ni < self.active.shape[0]:
                self.active[ni] = True
            else:
                self.active = np.append(self.active, True)
            return True, False, "nodes", False
        if kind in ("node_drain", "node_delete"):
            name = ev.get("name", "")
            ni = sim.na.index.get(name)
            if ni is None or not self.active[ni]:
                return False, False, None, False
            self.active[ni] = False
            self.drained.add(name)
            for pod in list(sim.pods_on_node[ni]):
                self._pod_index.pop(pod_key(pod), None)
                self._remove_pod(pod, ni)
            return True, True, None, False
        return False, False, None, False

    def _remove_pod(self, pod: dict, node_i: int) -> None:
        sim = self._sim
        got = sim._sig_of.pop(id(pod), None)
        if got is None:
            return
        sig, _, _ = got  # (signature, node, commit order)
        pg = sim.placed.get(sig)
        if pg is not None:
            c = pg.node_counts.get(node_i, 0)
            if c <= 1:
                pg.node_counts.pop(node_i, None)
            else:
                pg.node_counts[node_i] = c - 1
        try:
            sim.pods_on_node[node_i].remove(pod)
        except ValueError:
            pass

    def _extend_nodes(self, nodes: List[dict]) -> None:
        """Delta node-add: extend the node arrays in place and re-derive
        every group's node-axis statics; the following _restage rebuilds the
        [*, N] tables from them (one node dict parsed, not the cluster)."""
        sim = self._sim
        sim.na.extend(copy.deepcopy(nodes))
        sim.encoder.rebuild_group_axes()
        sim.pods_on_node.extend([] for _ in nodes)

    def _rebuild(self) -> None:
        """From-scratch re-encode (generation bump): the delta path declined
        an event. Sessions of the old generation re-encode on next use."""
        from ..simulator.engine import Simulator

        old = self._sim
        nodes = [copy.deepcopy(n) for i, n in enumerate(old.na.nodes) if self.active[i]]
        sim = Simulator(nodes, device=self.device, use_mesh=False, sched_config=old.sched_config)
        sim.register_cluster_objects(_cluster_objects(old.model))
        self._sim = sim
        index: Dict[str, Tuple[dict, int]] = {}
        for key, (pod, _) in self._pod_index.items():
            ni = sim.na.index.get((pod.get("spec") or {}).get("nodeName"))
            if ni is None:
                sim.homeless.append(pod)
                continue
            sim._commit_pod(pod, ni, scheduled=False)
            index[key] = (pod, ni)
        self._pod_index = index
        self.drained = set()
        self.generation += 1
        self._restage()

    # ----------------------------------------------------------- requests -----

    def encode_request(self, pods: List[dict]) -> List[Tuple[int, int]]:
        """Pod-axis encode of one request against the shared encoder:
        (group_id, forced_node) per pod. A new group is staged at the next
        dispatch (ensure_staged)."""
        with self._lock:
            return self._sim.encode_batch_ids(pods)

    def session(self, pods, drains: Sequence[str] = ()) -> WhatIfSession:
        return WhatIfSession(self, pods, drains)

    def eligible(self, batch: List[Tuple[int, int]], pods: List[dict]) -> Optional[str]:
        """None when the request can ride the resident path; otherwise the
        gate that routes it to the fresh-simulation path. Census-dependent
        inputs (topology spread eligible-domain sets, live SelectorSpread)
        are computed over the node census at encode time, so a masked node
        is not an absent one for them; gpu/storage groups carry
        host-mirrored state the image declines."""
        for pod in pods:
            if (pod.get("spec") or {}).get("nodeName"):
                return "pre-bound pod"
        with self._lock:
            enc = self._sim.encoder
            for gi, _ in batch:
                if gi >= len(enc.group_list):
                    return "stale image generation"
                g = enc.group_list[gi]
                if g.spread_dns or g.spread_sa:
                    return "topology spread (census-dependent eligible domains)"
                if g.ss_counter >= 0:
                    return "live SelectorSpread (census-dependent)"
                if g.gpu_mem > 0 or g.lvm_sizes or g.sdev_sizes:
                    return "gpu/local-storage request"
        return None

    def lane_overlay(self, session: WhatIfSession, activate: Sequence[str] = ()):
        """One sweep lane's copy-on-write overlay: lane_inputs' (active row,
        seeds) plus ACTIVATION of currently-drained nodes by name (the
        nodepool-mix family builds its pool nodes into the image drained and
        each lane turns k of them live). A pool node has no pods, so its
        seed rows are zero and activation never touches the seeds."""
        active, seeds = self.lane_inputs(session)
        for name in activate:
            ni = self._sim.na.index.get(name)
            if ni is not None:
                active[ni] = True
        return active, seeds

    def lane_inputs(self, session: WhatIfSession):
        """(active_row [n_pad] bool, seeds tuple) for one session's overlay:
        the image's live mask minus the request's drains, and, when drains
        are present, a private seed copy with the drained nodes' pods evicted
        (per-node rows zeroed, their counter/carrier domain contributions
        subtracted), so the lane equals a fresh encode of the cluster without
        those nodes and their pods."""
        active = self.active.copy()
        if not session.drains:
            return active, self._seeds
        sim = self._sim
        drain_idx = []
        for name in session.drains:
            ni = sim.na.index.get(name)
            if ni is not None and active[ni]:
                active[ni] = False
                drain_idx.append(ni)
        if not drain_idx:
            return active, self._seeds
        (requested, nonzero, port_used, counter, carrier,
         dev_used, vg_req, sdev_alloc) = (v.copy() for v in self._seeds)
        requested[drain_idx] = 0.0
        nonzero[drain_idx] = 0.0
        port_used[drain_idx] = False
        bt = self._bt
        for pg in sim.placed.values():
            nis = [ni for ni in drain_idx if ni in pg.node_counts]
            for ni in nis:
                cnt = float(pg.node_counts[ni])
                for t, cs in enumerate(sim.encoder.counter_list):
                    m = sim.match_cache.get((t, pg.sig))
                    if m is None:
                        m = sim.match_cache[(t, pg.sig)] = cs.matches_pod(pg.pod)
                    if m:
                        d = int(bt.counter_dom[t, ni])
                        if d < counter.shape[1] - 1:
                            counter[t, d] -= cnt
                for cid in pg.carrier_ids:
                    d = int(bt.carr_dom[cid, ni])
                    if d < carrier.shape[1] - 1:
                        carrier[cid, d] -= cnt
        return active, (requested, nonzero, port_used, counter, carrier, dev_used, vg_req,
                        sdev_alloc)

    # ----------------------------------------------------------- dispatch -----

    def assert_image_alive(self) -> None:
        """No dispatch may write a shared image table or the cached base
        carry in place: each tensor's storage and version counter must be
        what they were when it was staged."""
        for name, now, then in zip(kernels.Tables._fields, _stamps(self._tables),
                                   self._table_stamps):
            if now != then:
                raise ImageDonatedError(f"shared cluster-image table '{name}' was written in "
                                        f"place by a dispatch")
        for (S, _, _), (carry, stamps) in self._carry_devcache.items():
            if _stamps(carry) != stamps:
                raise ImageDonatedError(f"the cached {S}-lane base carry was written in place "
                                        f"by a dispatch")

    def dispatch_sessions(self, sessions: List[WhatIfSession]) -> List[dict]:
        """One dispatch per lane kind over the sessions; returns one response
        dict per session, in order. The WAVE lane takes uniform-replica
        requests (one group, no pin: serve_wave_fanout, provably identical to
        the serial placements) and the SERIAL lane the mixed-pod requests
        (the union-batch serve_whatif_fanout scan). The caller owns
        eligibility; every session must be non-empty."""
        with self._lock:
            for s in sessions:
                s.ensure_current()
            self.ensure_staged()
            wave: List[Tuple[int, WhatIfSession, tuple]] = []
            serial: List[Tuple[int, WhatIfSession]] = []
            for i, s in enumerate(sessions):
                route = self._wave_route(s)
                if route is not None:
                    wave.append((i, s, route))
                else:
                    serial.append((i, s))
            out: List[Optional[dict]] = [None] * len(sessions)
            lanes = len(sessions)
            if wave:
                for (i, _, _), resp in zip(wave, self._dispatch_wave(
                        [s for _, s, _ in wave], [r for _, _, r in wave], lanes)):
                    out[i] = resp
            if serial:
                for (i, _), resp in zip(serial, self._dispatch_serial(
                        [s for _, s in serial], lanes)):
                    out[i] = resp
            self._xray_sessions(out)
            return out

    def _xray_sessions(self, responses: List[dict]) -> None:
        """simonxray ride-along: one probe record per dispatched session
        (counts only: serving never materializes placements)."""
        from ..obs import xray

        run = xray.begin_run("serve")
        if run is None:
            return
        for r in responses:
            run.add_probe(r["scheduled"], r["total"])
        xray.commit_run(run, [self.device.type])

    def _wave_route(self, session: WhatIfSession):
        """(g, m, cap1) when the whole request is m unpinned replicas of ONE
        wave-eligible group (the engine's own routing decides)."""
        batch = session.batch
        g0, f0 = batch[0]
        if f0 >= 0 or any(b != (g0, -1) for b in batch):
            return None
        route = self._sim._wave_eligibility(g0)
        if route.kind != "wave" or route.gpu_live:
            return None
        return (g0, len(batch), route.cap1)

    def _lane_arrays(self, sessions: List[WhatIfSession],
                     activates: Optional[Sequence[Sequence[str]]] = None):
        """(S, active_s [S, n_pad], carry_np): S is the session count rounded
        up to a power of two, then to a multiple of the mesh's scenario axis
        (surplus lanes repeat lane 0 and are sliced off), plus each lane's
        active overlay and seed copy. carry_np is None when every lane uses
        the unmodified base seeds: the dispatch then reuses the cached
        device-resident base carry (_base_carry). `activates` (aligned with
        sessions) routes through lane_overlay (the sweep runner's nodepool
        lanes)."""
        S = 1
        while S < len(sessions):
            S *= 2
        if self._mesh is not None:
            S = self._mesh.padded_lanes(S)
        active_s = np.zeros((S, self._n_pad), bool)
        lane_seeds = []
        all_base = True
        for li, s in enumerate(sessions):
            if activates is None:
                active, seeds = self.lane_inputs(s)
            else:
                active, seeds = self.lane_overlay(s, activates[li])
            active_s[li] = active
            lane_seeds.append(seeds)
            all_base &= seeds is self._seeds
        for li in range(len(sessions), S):
            active_s[li] = active_s[0]
            lane_seeds.append(lane_seeds[0])
        if all_base:
            return S, active_s, None
        carry_np = tuple(np.ascontiguousarray(np.stack([lane_seeds[li][k] for li in range(S)]))
                         for k in range(len(lane_seeds[0])))
        return S, active_s, carry_np

    def _base_carry(self, S: int) -> kernels.Carry:
        """Device-resident broadcast of the base seeds over this rank's
        block of S lanes (all S without a mesh), cached per (S, block) and
        dropped by every ingest and restage (the caller holds the image
        lock). The lane kernels clone it before they write."""
        blk = self.lane_block(S)
        key = (S, blk.start, blk.stop)
        got = self._carry_devcache.get(key)
        if got is not None:
            return got[0]
        b = blk.stop - blk.start
        carry = kernels.Carry(*(torch.tensor(np.ascontiguousarray(
            np.broadcast_to(v, (b,) + v.shape)), device=self.device) for v in self._seeds))
        self._carry_devcache[key] = (carry, _stamps(carry))
        return carry

    def lane_block(self, S: int) -> slice:
        """The lanes of an S-lane dispatch this rank stages and runs."""
        from ..parallel.mesh import lane_block

        return lane_block(self._mesh, S)

    def fanouts(self):
        """The namespace the dispatches call: `kernels`, or the mesh's
        ShardedKernels."""
        from ..parallel.mesh import fanout_namespace

        return fanout_namespace(self._mesh)

    def fetch(self, *outputs: torch.Tensor) -> list:
        """One fetch of a dispatch's outputs, every lane on every rank."""
        from ..parallel.mesh import fetch_lanes

        return fetch_lanes(self._mesh, *outputs)

    def _stage_lane_inputs(self, carry_np, active_s):
        """(carry_s, active) on the device for one fan-out round, this rank's
        block of lanes only; carry_np None = every lane rides the cached
        base carry."""
        S = active_s.shape[0]
        blk = self.lane_block(S)
        if carry_np is None:
            carry_s = self._base_carry(S)
        else:
            carry_s = kernels.Carry(*(torch.tensor(np.ascontiguousarray(v[blk]),
                                                   device=self.device) for v in carry_np))
        return carry_s, torch.tensor(np.ascontiguousarray(active_s[blk]), device=self.device)

    def _dispatch_wave(self, sessions: List[WhatIfSession], routes: List[tuple],
                       lanes: int) -> List[dict]:
        S, active_s, carry_np = self._lane_arrays(sessions)
        g_s = np.zeros(S, np.int32)
        m_s = np.zeros(S, np.int32)
        cap1_s = np.zeros(S, bool)
        for li, (g, m, cap1) in enumerate(routes):
            g_s[li], m_s[li], cap1_s[li] = g, m, cap1
        g_s[len(routes):], m_s[len(routes):], cap1_s[len(routes):] = g_s[0], m_s[0], cap1_s[0]
        max_m = int(m_s.max())
        block = kernels.wave_block_for(max_m, self._sim.na.N)
        kmax = kernels.wave_kmax(max_m, self._sim.na.N, block)
        sim = self._sim
        blk = self.lane_block(S)
        carry_s, active = self._stage_lane_inputs(carry_np, active_s)
        carry_s, placed = self.fanouts().serve_wave_fanout(
            self._tables, carry_s, active, g_s[blk], m_s[blk], cap1_s[blk], w=sim.score_w,
            filters=sim.filter_flags, block=block, kmax=kmax)
        placed_s, requested_s = self.fetch(placed, carry_s.requested)
        self.assert_image_alive()
        return self._responses(sessions, [m for _, m, _ in routes], placed_s, requested_s,
                               active_s, lanes)

    def _dispatch_serial(self, sessions: List[WhatIfSession], lanes: int) -> List[dict]:
        S, active_s, carry_np = self._lane_arrays(sessions)
        # union pod batch: each session's rows stay contiguous and in order
        union: List[Tuple[int, int]] = []
        spans: List[Tuple[int, int]] = []
        for s in sessions:
            spans.append((len(union), len(s.batch)))
            union.extend(s.batch)
        P_pad = bucket_capped(max(1, len(union)), 2048)
        pod_group = np.zeros(P_pad, np.int32)
        forced_node = np.full(P_pad, -1, np.int32)
        if union:
            pod_group[:len(union)], forced_node[:len(union)] = np.asarray(union, np.int32).T
        valid_s = np.zeros((S, P_pad), bool)
        for li, (start, length) in enumerate(spans):
            valid_s[li, start:start + length] = True
        valid_s[len(sessions):] = valid_s[0]
        sim, btp = self._sim, self._bt
        carry_s, active = self._stage_lane_inputs(carry_np, active_s)
        # gpu/storage pinned off: the image gates decline those clusters and
        # requests
        carry_s, placed = self.fanouts().serve_whatif_fanout(
            self._tables, carry_s, active, pod_group, forced_node, valid_s[self.lane_block(S)],
            n_zones=btp.n_zones, enable_gpu=False, enable_storage=False, w=sim.score_w,
            filters=sim.filter_flags)
        placed_s, requested_s = self.fetch(placed, carry_s.requested)
        self.assert_image_alive()
        return self._responses(sessions, [n for _, n in spans], placed_s, requested_s,
                               active_s, lanes)

    def _responses(self, sessions, totals, placed_s, requested_s, active_s,
                   lanes: int) -> List[dict]:
        out = []
        for li, (s, total) in enumerate(zip(sessions, totals)):
            placed = int(placed_s[li])
            out.append({
                "scheduled": placed,
                "total": total,
                "unscheduled": total - placed,
                "utilization": self._utilization(active_s[li], requested_s[li]),
                "epoch": f"{s.generation}.{self.seq}",
                "lanes": lanes,
                "path": "batched",
            })
        return out

    def _utilization(self, active_row: np.ndarray, requested_row: np.ndarray) -> Dict[str, float]:
        """probe_utilization's totals for one lane: f64 host sums over the
        lane's live nodes. Masked rows (drained nodes, phantom padding) are
        left out, so the compacted sequence is the fresh encode's node order
        and the sums are bit-identical."""
        N = self._sim.na.N
        mask = active_row[:N]
        used = requested_row[:N][mask].astype(np.float64)
        alloc = self._alloc[:N][mask]
        return {
            "cpu_used": float(used[:, CPU_I].sum()),
            "cpu_alloc": float(alloc[:, CPU_I].sum()),
            "mem_used": float(used[:, MEM_I].sum()),
            "mem_alloc": float(alloc[:, MEM_I].sum()),
        }

    # ---------------------------------------------------------- slow path -----

    def current_nodes(self, extra_drains: Sequence[str] = (),
                      include: Sequence[str] = ()) -> List[dict]:
        """Deep copies of the live (non-drained) nodes, order preserved.
        `include` names currently-drained nodes to treat as live (the sweep
        nodepool activation overlay)."""
        skip, add = set(extra_drains), set(include)
        return [copy.deepcopy(n) for i, n in enumerate(self._sim.na.nodes)
                if (self.active[i] or name_of(n) in add) and name_of(n) not in skip]

    def cluster_pods(self, extra_drains: Sequence[str] = ()) -> List[dict]:
        """Deep copies of the committed (bound) pods on live nodes, in commit
        order: the prebound prefix a fresh probe replays."""
        skip = set(extra_drains)
        return [copy.deepcopy(pod) for pod, ni in self._pod_index.values()
                if self.active[ni] and self._sim.na.names[ni] not in skip]

    def fresh_simulator(self, drains: Sequence[str] = (), include: Sequence[str] = ()):
        """(sim, bound_pods, epoch): a fresh Simulator, on the image's device,
        over the current live cluster minus `drains` (and their pods) plus
        the named drained nodes of `include`, with the image's cluster
        objects registered. `bound_pods` are deep copies of the committed
        pods in commit order. Shared by fresh_probe and the sweep runner's
        serial oracle."""
        from ..simulator.engine import Simulator

        with self._lock:
            nodes = self.current_nodes(drains, include)
            bound = self.cluster_pods(drains)
            rt = _cluster_objects(self._sim.model)
            sched_config = self._sim.sched_config
            epoch = self.epoch
        sim = Simulator(nodes, device=self.device, sched_config=sched_config)
        sim.register_cluster_objects(rt)
        return sim, bound, epoch

    def fresh_probe(self, pods: List[dict], drains: Sequence[str] = ()) -> dict:
        """The from-scratch oracle and the fresh-path route: a fresh
        Simulator over the current cluster (minus request drains and their
        pods), the bound pods replayed, the request probed. The resident
        path must reproduce it byte for byte."""
        sim, bound, epoch = self.fresh_simulator(drains)
        request = [copy.deepcopy(p) for p in pods]
        scheduled, total = sim.probe_pods(bound + request)
        return {
            "scheduled": scheduled - len(bound),
            "total": total - len(bound),
            "unscheduled": total - scheduled,
            "utilization": sim.probe_utilization(),
            "epoch": epoch,
            "lanes": 1,
            "path": "fresh",
        }


def _stamps(tensors) -> Tuple[Tuple[int, int], ...]:
    """(data_ptr, version counter) of each tensor: an in-place write moves
    the version, a replaced storage the pointer."""
    return tuple((t.data_ptr(), t._version) for t in tensors)


def _cluster_objects(model):
    from ..core.types import ResourceTypes

    return ResourceTypes(
        services=list(model.services),
        replication_controllers=list(model.replication_controllers),
        replica_sets=list(model.replica_sets),
        stateful_sets=list(model.stateful_sets),
        storage_classes=list(model.storage_classes),
        config_maps=list(model.config_maps),
        pod_disruption_budgets=list(model.pdbs),
        persistent_volume_claims=list(model.pvcs),
    )
