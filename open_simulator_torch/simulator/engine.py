"""The Simulator engine: owns cluster state and drives the device scheduler.

Port of `open_simulator_tpu/simulator/engine.py`. Every run of unbound pods
is encoded into numpy `BatchTables`, staged as torch tensors on the
simulator's device, and cut into segments (`_segments`, the JAX segment
router): runs of at least WAVE_MIN identical pods go to the route their group
allows, the rest coalesce into serial chunks. Each segment is one kernel
dispatch from the previous segment's end carry:

- "serial": `kernels.schedule_batch` (K2), per-pod choices;
- "wave": `kernels.schedule_wave` (K3, then K3c `aggregate_commit`; a
  shared-GPU group runs with `gpu_live`: GPU units clamp the capacity and K3c
  replays the device allocator);
- "spread": `kernels.schedule_group_serial` (K4, then K3c);
- "affinity": `kernels.schedule_affinity_wave` (K5, then K3c).

The results are fetched once (`torch.cat` and `.cpu()`); pods of a counted
segment are handed out in node order, as in the JAX engine. Failed pods get
their FitError reasons from `kernels.feasibility_jit` (K1 on the card)
against the end carry of their segment. `use_waves = False` sends every pod
through K2 (the serial route). A batch with GPU-share or Open-Local demand
turns on those branches of K1 and K2 (`plugin_flags`); groups with volumes,
with a pre-assigned gpu-index, or sharing GPUs under live counters take the
serial route, and the host ledgers (`GpuShareHost`, `OpenLocalHost`) write
the gpu-index annotations and the storage state as each pod commits.

Behavioral parity notes (as in the JAX engine):
- Pods arriving with spec.nodeName are committed directly without any
  filter/capacity check (simulator.go:326-331); a pre-bound pod flushes the
  run of unbound pods before it.
- Failed pods leave no trace on cluster state.
- ScheduleApp registers only ConfigMaps/StorageClasses/PDBs from the app.
- Unschedulable reasons are rebuilt from per-stage masks in the k8s FitError
  format.

Capacity probing (`probe_pods`, `probe_utilization`) counts how many pods
would schedule without materializing placements: the capacity planner's
fresh-probe search (apply/applier.py) calls it.

Left out of this port so far, each with the ROADMAP item it waits for:
- preemption (mixed pod priorities raise): A6;
- custom scheduler configs and out-of-tree plugins: A7;
- the watchdog, CPU failover, fault injection and transactional rollback
  (resilience/): A9;
- metrics, pulse and xray instrumentation (obs/): A9;
- the columnar PodStore/NodeStore batches: A14;
- the node-axis mesh: A12.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..algo.queues import sort_affinity, sort_toleration
from ..core import constants as C
from ..core.types import AppResource, NodeStatus, ResourceTypes, SimulateResult, UnscheduledPod
from ..models.workloads import generate_valid_pods_from_app
from ..ops import kernels
from ..ops.resources import ResourceAxis, pod_nonzero_cpu_mem
from ..utils.objutil import (
    find_untolerated_taint,
    labels_of,
    match_label_selector,
    name_of,
    namespace_of,
    pod_host_ports,
    selector_from_set,
)
from .encode import (
    HOSTNAME,
    SIG_MEMO_KEY,
    BatchTables,
    Encoder,
    NodeArrays,
    PlacedGroup,
    bucket_capped,
    build_batch_tables,
    carried_specs_of_pod,
    pad_batch_tables,
    pad_encoder_axes,
    plugin_flags,
    scheduling_signature,
    strip_daemon_pin,
)

# Minimum run length of identical pods worth dispatching as a wave segment;
# shorter runs ride the serial scan.
WAVE_MIN = 8


class GroupRoute(NamedTuple):
    """One group's kernel routing decision (see Simulator._wave_eligibility):
    kind "wave" -> schedule_wave, "affinity" -> schedule_affinity_wave, "spread"
    -> schedule_group_serial, None -> the serial scan."""

    kind: Optional[str]
    cap1: bool
    gpu_live: bool
    ss_live: bool
    sa_live: bool


_SERIAL = GroupRoute(None, False, False, False, False)

# Runs longer than this many pods schedule as consecutive chunks, each an
# ordinary run whose commits seed the next chunk's encode: the JAX engine's
# default OPEN_SIMULATOR_STREAM_PODS, read from the environment as it reads
# it (Simulator._stream_chunk; 0 turns chunking off). The chunk size is part
# of the result: a chunk boundary ends the wave segments and serial chunks
# that cross it, so another size puts pods of one group on other nodes (the
# per-node census stays the same). Both packages must chunk alike.
STREAM_PODS = 131072


def resolve_device(device=None) -> torch.device:
    """The device the simulator runs on: CUDA unless the caller asks for the
    CPU. Without a CUDA device, only an explicit `device="cpu"` runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


class ClusterModel:
    """Host registry of non-pod objects that influence scheduling."""

    def __init__(self) -> None:
        self.services: List[dict] = []
        self.replication_controllers: List[dict] = []
        self.replica_sets: List[dict] = []
        self.stateful_sets: List[dict] = []
        self.storage_classes: List[dict] = []
        self.config_maps: List[dict] = []
        self.pdbs: List[dict] = []
        self.pvcs: List[dict] = []

    def default_spread_selector(self, pod: dict) -> Optional[dict]:
        """helper.DefaultSelector (plugins/helper/spread.go:22-57): merge the selectors
        of every Service/RC (map-style) and RS/STS (set-based) selecting this pod.
        Returns a LabelSelector dict, or None when empty (SelectorSpread inert)."""
        ns, lbls = namespace_of(pod), labels_of(pod)
        merged: Dict[str, str] = {}
        exprs: List[dict] = []
        for svc in self.services:
            sel = (svc.get("spec") or {}).get("selector")
            if sel and namespace_of(svc) == ns and selector_from_set(sel, lbls):
                merged.update(sel)
        for rc in self.replication_controllers:
            sel = (rc.get("spec") or {}).get("selector")
            if sel and namespace_of(rc) == ns and selector_from_set(sel, lbls):
                merged.update(sel)
        for coll in (self.replica_sets, self.stateful_sets):
            for obj in coll:
                sel = (obj.get("spec") or {}).get("selector")
                if sel and namespace_of(obj) == ns and match_label_selector(sel, lbls):
                    merged.update(sel.get("matchLabels") or {})
                    exprs.extend(sel.get("matchExpressions") or [])
        if not merged and not exprs:
            return None
        out: dict = {}
        if merged:
            out["matchLabels"] = merged
        if exprs:
            out["matchExpressions"] = exprs
        return out


class Simulator:
    """One simulation run over a fixed node set, on one device."""

    def __init__(
        self,
        nodes: List[dict],
        disable_progress: bool = True,
        patch_pod_funcs: Optional[List[Callable]] = None,
        device=None,
    ) -> None:
        """device: "cuda" (the default, None) or "cpu". Without a CUDA device
        only an explicit "cpu" runs; nothing falls back quietly."""
        self.device = resolve_device(device)
        # the simulator owns its node objects (the plugins write annotations
        # back into them), like the reference's fakeclient Create
        nodes = copy.deepcopy(list(nodes))
        self.score_w = kernels.DEFAULT_WEIGHTS
        self.filter_flags = kernels.DEFAULT_FILTERS
        self.axis = ResourceAxis()
        self.axis.discover(nodes, [])
        self.model = ClusterModel()
        self.na = NodeArrays(nodes, self.axis)
        self.encoder = Encoder(self.na, self.axis, self.model)
        from ..plugins.gpushare import GpuShareHost
        from ..plugins.openlocal import OpenLocalHost

        self.gpu_host = GpuShareHost(self.na.nodes)
        self.encoder.gpu_host = self.gpu_host
        self.local_host = OpenLocalHost(self.na.nodes)
        self.encoder.local_host = self.local_host
        self.placed: Dict[object, PlacedGroup] = {}  # signature → aggregated commits
        self.pods_on_node: List[List[dict]] = [[] for _ in range(self.na.N)]
        self.homeless: List[dict] = []  # bound to a node name we don't know
        # id(pod) -> (sig, node_i) of every committed pod: pod deletion
        # (serve/image.py) decrements the right signature's placed counts
        # from it (the part of JAX's preemption bookkeeping it needs)
        self._sig_of: Dict[int, tuple] = {}
        self._priority_seen: set = set()
        self.match_cache: Dict[Tuple[int, object], bool] = {}  # (counter id, sched signature)
        self.disable_progress = disable_progress
        self.patch_pod_funcs = patch_pod_funcs or []
        self._progress = None
        # The segment router: runs of identical pods go to the wave kernels.
        # False sends every pod through the serial scan.
        self.use_waves = True
        # routing cache, keyed by a flags/weights digest so that changing
        # filter_flags/score_w on a reused Simulator re-routes (_route_digest)
        self._wave_elig_cache: Dict[int, GroupRoute] = {}
        self._wave_elig_key: tuple = ()
        self._domain_count_cache: Dict[str, int] = {}  # topo key -> #domains
        self.segment_census: Dict[str, List[int]] = {}  # kind -> [segments, pods]
        self._last_carry: Optional[kernels.Carry] = None  # end carry of the last batch
        # Live-DNS groups whose every self topology has fewer domains than
        # this ride the group-serial scan instead of the affinity route (the
        # JAX engine's break-even knob, read the same way so that both
        # packages route alike; placements are exact on either route).
        try:
            self._spread_wave_min_domains = int(
                os.environ.get("OPEN_SIMULATOR_SPREAD_WAVE_MIN_DOMAINS", "0"))
        except ValueError:
            self._spread_wave_min_domains = 0
        # the streaming chunk (JAX engine.py:293-302): runs longer than this
        # schedule as consecutive chunks; 0 turns chunking off. JAX's
        # explicit-versus-default rule raises the default to 2,097,152 for
        # columnar PodStore batches only, which this port does not take
        # (ROADMAP A14), so for the dict batches it runs the value applies
        # as it is.
        try:
            self._stream_chunk = max(0, int(os.environ.get("OPEN_SIMULATOR_STREAM_PODS",
                                                           str(STREAM_PODS))))
        except ValueError:
            self._stream_chunk = STREAM_PODS

    # ------------------------------------------------------------- state ----------

    def _commit_pod(self, pod: dict, node_i: int, scheduled: bool = True) -> None:
        spec = pod.get("spec")
        if spec is None:
            spec = pod["spec"] = {}
        spec["nodeName"] = self.na.names[node_i]
        pod["status"] = {"phase": "Running"}
        # signature BEFORE reserve() writes gpu-index/assume-time annotations,
        # so identical pods keep one signature (match-cache key)
        sig = pod.get(SIG_MEMO_KEY)
        if sig is None:
            sig = scheduling_signature(pod)
        self._sig_of[id(pod)] = (sig, node_i)
        if scheduled:
            if self.gpu_host.enabled:
                self.gpu_host.reserve(pod, node_i)
            if self.local_host.enabled:
                self.local_host.reserve(pod, node_i, self.model.storage_classes)
        elif self.gpu_host.enabled:
            # pre-bound pod with an existing gpu-index (live snapshot): account it
            self.gpu_host.seed_pod(pod, node_i)
        pg = self.placed.get(sig)
        if pg is None:
            pg = self.placed[sig] = PlacedGroup(
                pod=pod,
                sig=sig,
                req_vec=self.axis.pod_vector(pod).astype(np.float32),
                nonzero=pod_nonzero_cpu_mem(pod).astype(np.float32),
                port_ids=self.encoder.port_ids(pod_host_ports(pod)),
                carrier_ids=[self.encoder.carrier_id(cs)
                             for cs in carried_specs_of_pod(pod)],
            )
        nc = pg.node_counts
        nc[node_i] = nc.get(node_i, 0) + 1
        pod.pop(SIG_MEMO_KEY, None)  # internal marker; keep result objects clean
        self.pods_on_node[node_i].append(pod)

    def register_cluster_objects(self, rt: ResourceTypes) -> None:
        m = self.model
        m.services.extend(rt.services)
        m.replication_controllers.extend(rt.replication_controllers)
        m.replica_sets.extend(rt.replica_sets)
        m.stateful_sets.extend(rt.stateful_sets)
        m.storage_classes.extend(rt.storage_classes)
        m.config_maps.extend(rt.config_maps)
        m.pdbs.extend(rt.pod_disruption_budgets)
        m.pvcs.extend(rt.persistent_volume_claims)

    def register_app_objects(self, rt: ResourceTypes) -> None:
        """ScheduleApp only materializes CM/SC/PDB from apps (simulator.go:252-267)."""
        self.model.config_maps.extend(rt.config_maps)
        self.model.storage_classes.extend(rt.storage_classes)
        self.model.pdbs.extend(rt.pod_disruption_budgets)

    # --------------------------------------------------------- scheduling ---------

    def schedule_pods(self, pods: List[dict]) -> List[UnscheduledPod]:
        """The schedulePods loop (simulator.go:309-348), batched while keeping
        the reference's strictly serial order: runs of unbound pods become one
        kernel dispatch; a pre-bound pod (spec.nodeName) flushes the run first,
        then commits directly."""
        self._check_priorities(pods)
        return self._schedule_pods_inner(pods)

    def _check_priorities(self, pods: List[dict]) -> None:
        """More than one distinct spec.priority across all calls would arm
        the DefaultPreemption PostFilter, which this port does not have yet."""
        seen = self._priority_seen | {(p.get("spec") or {}).get("priority") or 0
                                      for p in pods}
        if len(seen) > 1:
            raise NotImplementedError(
                "mixed pod priorities arm preemption, which the PyTorch port does not "
                "implement yet (ROADMAP A6)")
        self._priority_seen = seen

    def _schedule_pods_inner(self, pods: List[dict]) -> List[UnscheduledPod]:
        from ..utils.trace import Progress

        failed: List[UnscheduledPod] = []
        run: List[dict] = []
        progress = Progress("Scheduling pods", len(pods), enabled=not self.disable_progress)
        self._progress = progress if progress.enabled else None
        for pod in pods:
            node_name = (pod.get("spec") or {}).get("nodeName")
            if not node_name:
                run.append(pod)
                continue
            failed.extend(self._schedule_run(run))
            run = []
            if self._progress is not None:
                self._progress.advance(1)
            ni = self.na.index.get(node_name)
            if ni is None:
                # the reference's fakeclient accepts pods bound to unknown nodes
                # and drops them from every report; keep them on self.homeless
                pod.pop(SIG_MEMO_KEY, None)
                self.homeless.append(pod)
            else:
                self._commit_pod(pod, ni, scheduled=False)
        failed.extend(self._schedule_run(run))
        progress.close()
        if self.gpu_host.enabled:
            self.gpu_host.flush()
        return failed

    def encode_batch(self, to_schedule: List[dict]) -> BatchTables:
        """Encode a pod batch into padded tables (no scheduling): encoder axes
        to pow2 buckets, the node axis to bucket_capped(N, 1024)."""
        bt = pad_encoder_axes(self.encode_batch_raw(to_schedule))
        return pad_batch_tables(bt, bucket_capped(self.na.N, 1024))

    def encode_batch_raw(self, to_schedule: List[dict]) -> BatchTables:
        batch = self.encode_batch_ids(to_schedule)
        pad = bucket_capped(len(batch), 2048)
        return build_batch_tables(self.encoder, batch, self.placed, self.match_cache, pad_to=pad)

    def encode_batch_ids(self, to_schedule: List[dict]) -> List[Tuple[int, int]]:
        """(group_id, forced_node) per pod, in order, interning new groups."""
        batch: List[Tuple[int, int]] = []
        for pod in to_schedule:
            if ((pod.get("spec") or {}).get("affinity")) is not None:
                stripped, target = strip_daemon_pin(pod)
            else:
                stripped, target = pod, None
            if target is None:
                forced, enc_pod = -1, pod
                if SIG_MEMO_KEY not in pod:
                    pod[SIG_MEMO_KEY] = scheduling_signature(pod)
            elif target in self.na.index:
                forced, enc_pod = self.na.index[target], stripped
            else:
                # pinned to a node this simulator doesn't know: the unpinned
                # memo must not merge this pod into the unconstrained group
                forced, enc_pod = -1, pod
                pod.pop(SIG_MEMO_KEY, None)
            batch.append((self.encoder.group_of(enc_pod), forced))
        return batch

    def _schedule_run(self, to_schedule: List[dict]) -> List[UnscheduledPod]:
        if not to_schedule:
            return []
        if self.na.N == 0:
            return [UnscheduledPod(pod, self._format_reason(pod, {}, 0)) for pod in to_schedule]
        chunk = self._stream_chunk
        if not chunk or len(to_schedule) <= chunk:
            return self._schedule_run_once(to_schedule)
        failed: List[UnscheduledPod] = []
        for off in range(0, len(to_schedule), chunk):
            failed.extend(self._schedule_run_once(to_schedule[off:off + chunk]))
        return failed

    def _to_device(self, bt: BatchTables):
        return (kernels.tables_from_batch(bt, self.device),
                kernels.carry_from_batch(bt, self.device))

    # ------------------------------------------------------------ routing ---------

    def _route_digest(self) -> tuple:
        """Everything _wave_eligibility reads besides the (immutable) group:
        score weights, filter flags and the break-even knob."""
        return (self.score_w, self.filter_flags, self._spread_wave_min_domains)

    def _wave_eligibility(self, gi: int) -> GroupRoute:
        """Route group gi to its scheduling kernel (the JAX engine's rules).

        kind="wave": the group's placements change no predicate or score
        input it reads itself, so schedule_wave commits whole score-table
        prefixes. Hostname-topology required self-anti-affinity and host
        ports (with NodePorts on) are per-node capacity-1 clamps (cap1).

        kind="affinity": counter-live hard predicates (self-matching
        DoNotSchedule terms, required self-affinity, non-hostname required
        self-anti-affinity in either direction, live SelectorSpread on an
        unzoned cluster), at most one budget-consuming live term.

        kind="spread": the group-serial scan: ScheduleAnyway terms
        (sa_live), zoned live SelectorSpread, and several self-matching
        DoNotSchedule terms (or live-DNS groups below
        OPEN_SIMULATOR_SPREAD_WAVE_MIN_DOMAINS domains).

        kind=None: the serial scan: storage state, self-matching preferred
        affinity, GPU with counter liveness, ScheduleAnyway mixed with
        affinity liveness."""
        digest = self._route_digest()
        if digest != self._wave_elig_key:
            self._wave_elig_cache.clear()
            self._wave_elig_key = digest
        got = self._wave_elig_cache.get(gi)
        if got is not None:
            return got
        enc = self.encoder
        g = enc.group_list[gi]
        tmpl = g.template
        cap1 = False
        spread_live = (any(selfm for _, _, selfm in g.spread_dns)
                       and self.filter_flags.spread)
        gpu_live = g.gpu_mem > 0 and g.gpu_pre_ids is None
        # the default spread selector always matches the group's own pods; a
        # zero SelectorSpread weight makes the term inert
        ss_live = g.ss_counter >= 0 and self.score_w.ss != 0
        sa_live = bool(g.spread_sa) and self.score_w.pts != 0
        if (g.gpu_mem > 0 and not gpu_live) or g.lvm_sizes or g.sdev_sizes:
            got = _SERIAL  # host-mirrored gpu/storage state
        else:
            if g.ports and self.filter_flags.ports:
                cap1 = True  # the first copy claims the port on its node
            aff_live = anti_live = pref_live = False
            budget_terms = (sum(1 for _, _, selfm in g.spread_dns if selfm)
                            if spread_live else 0)
            if self.filter_flags.interpod:
                for cid in g.req_aff:
                    if enc.counter_list[cid].matches_pod(tmpl):
                        aff_live = True
                for cid in g.req_anti:
                    cs = enc.counter_list[cid]
                    if cs.matches_pod(tmpl):
                        if cs.topo_key == HOSTNAME:
                            cap1 = True
                        else:
                            anti_live = True
                            budget_terms += 1
                for cs in g.carried:
                    if cs.use == "anti" and cs.matches_pod(tmpl):
                        if cs.topo_key == HOSTNAME:
                            cap1 = True
                        else:
                            anti_live = True
                            budget_terms += 1
            for cid, _ in g.pref:
                if enc.counter_list[cid].matches_pod(tmpl):
                    pref_live = True  # a live interpod SCORE term
            counter_live = spread_live or ss_live or aff_live or anti_live
            ss_zoned = ss_live and len(self.na.zones) > 0
            low_domains = spread_live and not all(
                not selfm or self._domain_count(cid) >= self._spread_wave_min_domains
                for cid, _, selfm in g.spread_dns)
            if pref_live or (gpu_live and (counter_live or sa_live)):
                got = _SERIAL
            elif aff_live or anti_live:
                got = (_SERIAL if sa_live
                       else GroupRoute("affinity", cap1, False, ss_live, False))
            elif sa_live or ss_zoned or budget_terms > 1 or (spread_live and low_domains):
                got = GroupRoute("spread", cap1, False, ss_live, sa_live)
            elif spread_live or ss_live:
                got = GroupRoute("affinity", cap1, False, ss_live, False)
            else:
                got = GroupRoute("wave", cap1, gpu_live, False, False)
        self._wave_elig_cache[gi] = got
        return got

    def _domain_count(self, cid: int) -> int:
        """Number of distinct domains a counter's topology key has on this
        cluster (cached per topology key)."""
        key = self.encoder.counter_list[cid].topo_key
        got = self._domain_count_cache.get(key)
        if got is None:
            dom = self.na.domain_of(key)
            got = self._domain_count_cache[key] = int(len(np.unique(dom[dom >= 0])))
        return got

    def _segments(self, bt: BatchTables, P: int) -> List[tuple]:
        """Split the batch into maximal runs of one (group, forced) pair;
        routed runs of >= WAVE_MIN become ('wave', start, len, g, cap1,
        gpu_live), ('affinity', start, len, g, cap1, ss_live) or ('spread',
        start, len, g, cap1, ss_live, sa_live) segments, the rest coalesce
        into ('serial', start, len) chunks."""
        pg = np.asarray(bt.pod_group[:P])
        fn = np.asarray(bt.forced_node[:P])
        change = np.flatnonzero((np.diff(pg) != 0) | (np.diff(fn) != 0)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [P]])
        segs: List[tuple] = []
        ser_start: Optional[int] = None
        for i, j in zip(starts.tolist(), ends.tolist()):
            g, f = int(pg[i]), int(fn[i])
            run = j - i
            route = self._wave_eligibility(g) if f < 0 else _SERIAL
            if route.kind is not None and run >= WAVE_MIN:
                if ser_start is not None:
                    segs.append(("serial", ser_start, i - ser_start))
                    ser_start = None
                if route.kind == "spread":
                    segs.append(("spread", i, run, g, route.cap1, route.ss_live, route.sa_live))
                elif route.kind == "affinity":
                    segs.append(("affinity", i, run, g, route.cap1, route.ss_live))
                else:
                    segs.append(("wave", i, run, g, route.cap1, route.gpu_live))
            elif ser_start is None:
                ser_start = i
        if ser_start is not None:
            segs.append(("serial", ser_start, P - ser_start))
        return segs

    def _dispatch(self, seg: tuple, bt: BatchTables, tables, carry, flags: Tuple[bool, bool]):
        """One segment's kernel dispatch from `carry` (its start carry):
        returns (end carry, i32 result on the device): per-pod choices of a
        serial segment, per-node counts of every other kind. `flags`:
        (enable_gpu, enable_storage) of the batch, for the serial scan."""
        kind, start, length = seg[:3]
        w, filters = self.score_w, self.filter_flags
        if kind == "serial":
            pad = bucket_capped(length, 2048)
            pg = np.zeros(pad, np.int32)
            pg[:length] = bt.pod_group[start:start + length]
            fn = np.full(pad, -1, np.int32)
            fn[:length] = bt.forced_node[start:start + length]
            vd = np.zeros(pad, bool)
            vd[:length] = True
            return kernels.schedule_batch(
                tables, carry, torch.from_numpy(pg), torch.from_numpy(fn),
                torch.from_numpy(vd), n_zones=bt.n_zones, w=w, filters=filters,
                enable_gpu=flags[0], enable_storage=flags[1])
        g, cap1 = seg[3], bool(seg[4])
        if kind == "wave":
            block = kernels.wave_block_for(length, self.na.N)
            kmax = kernels.wave_kmax(length, self.na.N, block)
            carry, counts, _ = kernels.schedule_wave(tables, carry, g, length, cap1, w=w,
                                                     filters=filters, block=block, kmax=kmax,
                                                     gpu_live=bool(seg[5]))
            return carry, counts
        if kind == "spread":
            ss_live, sa_live = bool(seg[5]), bool(seg[6])
            vd = np.zeros(bucket_capped(length, 2048), bool)
            vd[:length] = True
            carry, counts, _ = kernels.schedule_group_serial(
                tables, carry, g, torch.from_numpy(vd), cap1, w=w, filters=filters,
                ss_live=ss_live, sa_live=sa_live, n_zones=bt.n_zones if ss_live else 2)
            return carry, counts
        # "affinity": counter-live hard predicates, the epoch-batched wave
        ss_live = bool(seg[5])
        block = kernels.wave_block_for(length, self.na.N)
        carry, counts, _ = kernels.schedule_affinity_wave(
            tables, carry, g, length, cap1, ss_live=ss_live, w=w, filters=filters, block=block,
            n_zones=bt.n_zones if ss_live else 2)
        return carry, counts

    def _schedule_run_once(self, to_schedule: List[dict]) -> List[UnscheduledPod]:
        bt = self.encode_batch(to_schedule)
        flags = plugin_flags(bt)  # (enable_gpu, enable_storage)
        tables, carry = self._to_device(bt)
        P = len(to_schedule)
        segs = self._segments(bt, P) if self.use_waves else [("serial", 0, P)]
        # every segment chains from the previous one's end carry; the results
        # come back in ONE fetch
        outs: List[tuple] = []  # (seg, i32 device result, carry after the segment)
        for seg in segs:
            carry, res = self._dispatch(seg, bt, tables, carry, flags)
            outs.append((seg, res, carry))
        self._last_carry = carry
        flat = torch.cat([res for _, res, _ in outs]).cpu().numpy()
        choices = np.full(P, -1, np.int32)
        seg_of = np.zeros(P, np.int32)
        off = 0
        for k, (seg, res, _) in enumerate(outs):
            part = flat[off:off + res.shape[0]]
            off += res.shape[0]
            start, length = seg[1], seg[2]
            seg_of[start:start + length] = k
            if seg[0] == "serial":
                choices[start:start + length] = part[:length]
            else:
                # pods of one group are interchangeable: hand them out in node
                # order; the (length - placed) unschedulable pods stay -1
                placed = int(part.sum())
                choices[start:start + placed] = np.repeat(np.arange(part.shape[0]), part)[:placed]
        for seg in segs:
            n = self.segment_census.setdefault(seg[0], [0, 0])
            n[0] += 1
            n[1] += seg[2]

        failed: List[UnscheduledPod] = []
        reason_cache: Dict[Tuple[int, int, int], Dict[str, int]] = {}
        progress = self._progress
        for i, pod in enumerate(to_schedule):
            if progress is not None:
                progress.advance(1)
            node_i = int(choices[i])
            if node_i >= 0:
                self._commit_pod(pod, node_i)
                continue
            # pods of one group share tolerations/requests: diagnose once per
            # (group, forced, segment) against the end carry of the segment
            key = (int(bt.pod_group[i]), int(bt.forced_node[i]), int(seg_of[i]))
            reasons = reason_cache.get(key)
            if reasons is None:
                reasons = reason_cache[key] = self._explain_reasons(
                    pod, key[0], key[1], tables, outs[key[2]][2], flags)
            pod.pop(SIG_MEMO_KEY, None)
            failed.append(UnscheduledPod(pod, self._format_reason(pod, reasons, self.na.N)))
        return failed

    # ------------------------------------------------------------ probing ---------

    def probe_pods(self, pods: List[dict]) -> Tuple[int, int]:
        """Capacity-probe scheduling (JAX engine :1663): how many of `pods`
        would schedule, without materializing placements. Pre-bound pods
        commit normally (cluster state the probe must account); every unbound
        pod joins ONE device run whose results are counted and never written
        back: no pod mutation, no placed records, no failure diagnosis.
        Returns (scheduled, total).

        The caller owns two caveats (CapacityPlanner.try_build guards both):
        pre-bound pods all commit BEFORE the unbound run, whatever their list
        position, and pods bound to unknown nodes drop out of the totals as
        schedule_pods drops them from every report. Like the JAX probe, it
        runs no preemption, so mixed priorities do not raise here."""
        return self._probe_pods_inner(pods)

    def _probe_pods_inner(self, pods: List[dict]) -> Tuple[int, int]:
        run: List[dict] = []
        scheduled = 0
        homeless = 0
        for pod in pods:
            node_name = (pod.get("spec") or {}).get("nodeName")
            if not node_name:
                run.append(pod)
                continue
            ni = self.na.index.get(node_name)
            if ni is None:
                homeless += 1
                self.homeless.append(pod)
            else:
                self._commit_pod(pod, ni, scheduled=False)
                scheduled += 1
        total_known = len(pods) - homeless
        if not run or self.na.N == 0:
            return scheduled, total_known
        bt = self.encode_batch(run)
        tables, carry = self._to_device(bt)
        flags = plugin_flags(bt)
        P = len(run)
        segs = self._segments(bt, P) if self.use_waves else [("serial", 0, P)]
        placed_parts = []
        for seg in segs:
            carry, res = self._dispatch(seg, bt, tables, carry, flags)
            # a serial segment returns per-pod choices, the others per-node counts
            placed_parts.append((res >= 0).sum(dtype=torch.int32) if seg[0] == "serial"
                                else res.sum(dtype=torch.int32))
        self._last_carry = carry
        total = int(torch.stack(placed_parts).sum().cpu())  # one fetch
        return scheduled + total, total_known

    def probe_utilization(self) -> Dict[str, float]:
        """Aggregate used/allocatable totals after a probe_pods run (JAX
        engine :1834), read from the end carry in one fetch: the inputs of
        satisfyResourceSetting (apply.go:689-775). CPU in milli, memory in
        bytes; the sums are taken in f64 on the host (byte quantities over
        thousands of nodes overflow f32 precision)."""
        from ..ops.resources import CPU_I, MEM_I

        N = self.na.N
        if self._last_carry is None:
            used = np.zeros((N, self.axis.R), np.float64)
        else:
            used = self._last_carry.requested.cpu().numpy()[:N].astype(np.float64)
        alloc = self.na.alloc
        return {
            "cpu_used": float(used[:, CPU_I].sum()),
            "cpu_alloc": float(alloc[:, CPU_I].sum()),
            "mem_used": float(used[:, MEM_I].sum()),
            "mem_alloc": float(alloc[:, MEM_I].sum()),
        }

    # ------------------------------------------------- unschedulable reasons ------

    _STAGE_ORDER = (
        ("unsched", "node(s) were unschedulable"),
        ("taint", None),  # expanded per-taint below
        ("affinity", "node(s) didn't match node selector"),
        ("extra", "node(s) were filtered out by an out-of-tree plugin"),
        ("ports", "node(s) didn't have free ports for the requested pod ports"),
        ("fit", None),  # expanded per-resource below
        ("spread", "node(s) didn't match pod topology spread constraints"),
        ("pod_affinity", "node(s) didn't match pod affinity rules"),
        ("pod_anti", "node(s) didn't match pod anti-affinity rules"),
        ("gpu", None),  # expanded per-node below (gpu-share Filter says "Node:<name>")
        ("storage", "node(s) didn't have enough local storage"),
    )

    def _explain_reasons(self, pod: dict, g: int, forced: int, tables, carry,
                         flags: Tuple[bool, bool]) -> Dict[str, int]:
        """FitError reason counts from the per-stage masks of
        kernels.feasibility_jit with the batch's (enable_gpu, enable_storage)
        (findNodesThatFitPod failure accounting, first-failing plugin per
        node)."""
        _, stages = kernels.feasibility_jit(tables, carry, g, forced, True, self.filter_flags,
                                            enable_gpu=flags[0], enable_storage=flags[1])
        N = self.na.N  # stages carry phantom node padding; slice it off
        stages = {k: v.cpu().numpy()[:N] for k, v in stages.items()}
        return self._reasons_from_stages(pod, forced, stages)

    def _reasons_from_stages(self, pod: dict, forced: int,
                             stages: Dict[str, np.ndarray]) -> Dict[str, int]:
        N = self.na.N
        remaining = np.ones(N, bool)
        if forced >= 0:
            only = np.zeros(N, bool)
            only[forced] = True
            remaining &= only
        reasons: Dict[str, int] = {}

        for stage, label in self._STAGE_ORDER:
            if stage == "taint":
                fail = remaining & ~stages["taint"]
                for i in np.nonzero(fail)[0]:
                    taint = find_untolerated_taint(self.na.nodes[i], pod, ("NoSchedule", "NoExecute"))
                    if taint is None:
                        lbl = "node(s) had taints that the pod didn't tolerate"
                    else:
                        lbl = "node(s) had taint {%s: %s}, that the pod didn't tolerate" % (
                            taint.get("key", ""), taint.get("value") or "")
                    reasons[lbl] = reasons.get(lbl, 0) + 1
            elif stage == "gpu":
                fail = remaining & ~stages["gpu"]
                for i in np.nonzero(fail)[0]:
                    lbl = f"Node:{self.na.names[i]}"
                    reasons[lbl] = reasons.get(lbl, 0) + 1
            elif stage == "fit":
                fit_each = stages["fit_each"]  # [N, R]
                fail = remaining & ~stages["fit"]
                for i in np.nonzero(fail)[0]:
                    bad = np.nonzero(~fit_each[i])[0]
                    res = self.axis.names[bad[0]] if len(bad) else "resources"
                    lbl = "Too many pods" if res == "pods" else f"Insufficient {res}"
                    reasons[lbl] = reasons.get(lbl, 0) + 1
            else:
                n = int((remaining & ~stages[stage]).sum())
                if n:
                    reasons[label] = reasons.get(label, 0) + n
            remaining &= stages[stage]
        return reasons

    def _format_reason(self, pod: dict, reasons: Dict[str, int], n_nodes: int) -> str:
        detail = ", ".join(f"{v} {k}" for k, v in sorted(reasons.items()))
        if not detail:
            detail = "no nodes available to schedule pods"
        msg = f"0/{n_nodes} nodes are available: {detail}."
        return (
            f"failed to schedule pod ({namespace_of(pod)}/{name_of(pod)}): "
            f"{C.PodReasonUnschedulable}: {msg}"
        )

    # ----------------------------------------------------------- results ----------

    def get_cluster_node_status(self) -> List[NodeStatus]:
        return [NodeStatus(node=self.na.nodes[i], pods=list(self.pods_on_node[i]))
                for i in range(self.na.N)]

    def _result(self, failed: List[UnscheduledPod]) -> SimulateResult:
        return SimulateResult(unscheduled_pods=failed,
                              node_status=self.get_cluster_node_status(),
                              backend_path=[self.device.type])

    def schedule_app(self, app: AppResource) -> SimulateResult:
        """ScheduleApp (simulator.go:232-275): expand app, order, register CM/SC/PDB,
        schedule."""
        pods = generate_valid_pods_from_app(app.name, app.resource, self.na.nodes)
        pods = sort_toleration(sort_affinity(pods))
        for patch in self.patch_pod_funcs:
            patch(pods)
        self.register_app_objects(app.resource)
        return self._result(self.schedule_pods(pods))

    def run_cluster(self, cluster: ResourceTypes) -> SimulateResult:
        """RunCluster + syncClusterResourceList (simulator.go:225-230,365-447)."""
        self.register_cluster_objects(cluster)
        return self._result(self.schedule_pods(cluster.pods))
