"""The Simulator engine: owns cluster state and drives the device scheduler.

Port of `open_simulator_tpu/simulator/engine.py`, serial route only: every run
of unbound pods is encoded into numpy `BatchTables`, staged as torch tensors
on the simulator's device, scheduled by ONE `kernels.schedule_batch` dispatch
(the CUDA kernel K2 on the card, the plain PyTorch scan on the CPU), fetched
once with `.cpu()`, and committed on the host pod by pod. Failed pods get their
FitError reasons from `kernels.feasibility_jit` (K1 on the card).

Behavioral parity notes (as in the JAX engine):
- Pods arriving with spec.nodeName are committed directly without any
  filter/capacity check (simulator.go:326-331); a pre-bound pod flushes the
  run of unbound pods before it.
- Failed pods leave no trace on cluster state.
- ScheduleApp registers only ConfigMaps/StorageClasses/PDBs from the app.
- Unschedulable reasons are rebuilt from per-stage masks in the k8s FitError
  format, against the end state of the failing pod's run.

Left out of this port so far, each with the ROADMAP item it waits for:
- wave, group-serial and affinity-wave segments (the JAX segment router):
  B6-B8; the serial route places every pod identically;
- GPU-share and Open-Local kernel branches: B9 (such batches raise);
- preemption (mixed pod priorities raise): A6;
- capacity probing (probe_pods / probe_utilization): A7;
- custom scheduler configs and out-of-tree plugins: A7;
- the watchdog, CPU failover, fault injection and transactional rollback
  (resilience/): A9;
- metrics, pulse and xray instrumentation (obs/): A9;
- the columnar PodStore/NodeStore batches: A14;
- the node-axis mesh: A12.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

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

# Runs longer than this many pods schedule as consecutive chunks (the JAX
# engine's default OPEN_SIMULATOR_STREAM_PODS): chunk k's commits seed chunk
# k+1's encode, so placements equal one monolithic run.
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
        self._priority_seen: set = set()
        self.match_cache: Dict[Tuple[int, object], bool] = {}  # (counter id, sched signature)
        self.disable_progress = disable_progress
        self.patch_pod_funcs = patch_pod_funcs or []
        self._progress = None

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
        failed: List[UnscheduledPod] = []
        for off in range(0, len(to_schedule), STREAM_PODS):
            failed.extend(self._schedule_run_once(to_schedule[off:off + STREAM_PODS]))
        return failed

    def _to_device(self, bt: BatchTables):
        return (kernels.tables_from_batch(bt, self.device),
                kernels.carry_from_batch(bt, self.device))

    def _schedule_run_once(self, to_schedule: List[dict]) -> List[UnscheduledPod]:
        bt = self.encode_batch(to_schedule)
        enable_gpu, enable_storage = plugin_flags(bt)
        if enable_gpu or enable_storage:
            raise NotImplementedError(
                "pods with GPU-share or Open-Local demand need kernel branches the "
                "PyTorch port does not have yet (ROADMAP B9)")
        tables, carry = self._to_device(bt)
        P = len(to_schedule)
        pad = bucket_capped(P, 2048)
        pg = np.zeros(pad, np.int32)
        pg[:P] = bt.pod_group[:P]
        fn = np.full(pad, -1, np.int32)
        fn[:P] = bt.forced_node[:P]
        vd = np.zeros(pad, bool)
        vd[:P] = True
        final_carry, ch = kernels.schedule_batch(
            tables, carry, torch.from_numpy(pg), torch.from_numpy(fn), torch.from_numpy(vd),
            n_zones=bt.n_zones, w=self.score_w, filters=self.filter_flags)
        choices = ch.cpu().numpy()[:P]  # the run's one fetch

        failed: List[UnscheduledPod] = []
        reason_cache: Dict[Tuple[int, int], Dict[str, int]] = {}
        progress = self._progress
        for i, pod in enumerate(to_schedule):
            if progress is not None:
                progress.advance(1)
            node_i = int(choices[i])
            if node_i >= 0:
                self._commit_pod(pod, node_i)
                continue
            # pods of one group share tolerations/requests: diagnose once per
            # (group, forced) against the run's end state
            key = (int(bt.pod_group[i]), int(bt.forced_node[i]))
            reasons = reason_cache.get(key)
            if reasons is None:
                reasons = reason_cache[key] = self._explain_reasons(
                    pod, key[0], key[1], tables, final_carry)
            pod.pop(SIG_MEMO_KEY, None)
            failed.append(UnscheduledPod(pod, self._format_reason(pod, reasons, self.na.N)))
        return failed

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

    def _explain_reasons(self, pod: dict, g: int, forced: int, tables, carry) -> Dict[str, int]:
        """FitError reason counts from the per-stage masks of
        kernels.feasibility_jit (findNodesThatFitPod failure accounting,
        first-failing plugin per node)."""
        _, stages = kernels.feasibility_jit(tables, carry, g, forced, True, self.filter_flags)
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
