"""GPU-share: GPU-memory-sharing simulation (the Open-Gpu-Share plugin).

Mirrors reference pkg/simulator/plugin/open-gpu-share.go and
pkg/type/open-gpu-share/{cache,utils}: pods request `alibabacloud.com/gpu-mem`
(memory PER GPU) + `alibabacloud.com/gpu-count` via annotations; nodes advertise
total sharable GPU memory and whole-GPU count in status.capacity.

Split of responsibilities in the TPU build:
- The FILTER (node has enough total + per-device memory, open-gpu-share.go:51-81)
  runs inside the batched kernel as dense [N, MAXDEV] tensor math (ops/kernels.py).
- The ALLOCATOR (device-id assignment: tightest-fit for 1 GPU, two-pointer greedy
  for multi-GPU — gpunodeinfo.go:232-290) is replayed here on the host for each
  committed pod, producing the `gpu-index` annotation, the `simon/node-gpu-share`
  node annotation, and the whole-GPU allocatable update exactly like Reserve
  (open-gpu-share.go:147-188). Device-side dev_used and the host ledger follow the
  same deterministic algorithm, so they never diverge.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import constants as C
from ..utils.objutil import annotations_of, name_of, namespace_of
from ..utils.quantity import format_quantity, parse_quantity


# --------------------------------------------------------------- pod annotations ----


def pod_gpu_mem(pod: dict) -> int:
    """GetGpuMemoryFromPodAnnotation: per-GPU memory request, 0 when absent."""
    raw = annotations_of(pod).get(C.AnnoGpuMem)
    if raw is None:
        return 0
    try:
        return int(parse_quantity(raw))
    except ValueError:
        return 0


def pod_gpu_count(pod: dict) -> int:
    """GetGpuCountFromPodAnnotation: number of GPUs, 0 when absent/invalid."""
    raw = annotations_of(pod).get(C.AnnoGpuCount)
    try:
        v = int(str(raw))
    except (TypeError, ValueError):
        return 0
    return v if v >= 0 else 0


def pod_gpu_index(pod: dict) -> str:
    return annotations_of(pod).get(C.AnnoGpuIndex, "")


def gpu_id_str_to_list(id_str: str) -> List[int]:
    """GpuIdStrToIntList: "2-3-4" -> [2, 3, 4]; raises ValueError on junk."""
    if not id_str:
        return []
    return [int(tok) for tok in id_str.split("-")]


# ----------------------------------------------------------------- node capacity ----


def node_total_gpu_memory(node: dict) -> int:
    """GetTotalGpuMemory reads status.CAPACITY (not allocatable)."""
    cap = (node.get("status") or {}).get("capacity") or {}
    raw = cap.get(C.ResourceGpuMem)
    if raw is None:
        return 0
    try:
        return int(parse_quantity(raw))
    except ValueError:
        return 0


def node_gpu_count(node: dict) -> int:
    cap = (node.get("status") or {}).get("capacity") or {}
    raw = cap.get(C.ResourceGpuCount)
    if raw is None:
        return 0
    try:
        return int(parse_quantity(raw))
    except ValueError:
        return 0


def node_gpu_model(node: dict) -> str:
    lbls = ((node.get("metadata") or {}).get("labels")) or {}
    return lbls.get(C.AnnoGpuModel, "N/A")


# -------------------------------------------------------------------- allocator -----


def allocate_gpu_ids(
    dev_total: List[int], dev_used: List[int], mem: int, num: int,
    preassigned: str = "",
) -> Tuple[str, bool]:
    """AllocateGpuId (gpunodeinfo.go:232-290). Returns ("i-j-k", found)."""
    if mem <= 0 or num <= 0:
        return "", False
    n_devs = len(dev_total)
    idle = [dev_total[i] - dev_used[i] for i in range(n_devs)]
    if n_devs <= 0:
        return "", False

    if preassigned:
        try:
            if gpu_id_str_to_list(preassigned):
                return preassigned, True
        except ValueError:
            pass

    if num == 1:
        cand, cand_mem = -1, 0
        for dev in range(n_devs):
            if idle[dev] >= mem and (cand < 0 or idle[dev] < cand_mem):
                cand, cand_mem = dev, idle[dev]
        return (str(cand), True) if cand >= 0 else ("", False)

    ids: List[int] = []
    dev = 0
    while dev < n_devs and len(ids) < num:
        if idle[dev] >= mem:
            ids.append(dev)
            idle[dev] -= mem
        else:
            dev += 1
    if len(ids) == num:
        return "-".join(str(i) for i in ids), True
    return "", False


# ------------------------------------------------------------------ host ledger -----


class GpuNodeState:
    """Per-node device ledger (GpuNodeInfo + DeviceInfo)."""

    def __init__(self, node: dict) -> None:
        self.node = node
        self.model = node_gpu_model(node)
        self.gpu_count = node_gpu_count(node)
        self.total_mem = node_total_gpu_memory(node)
        per_dev = self.total_mem // self.gpu_count if self.gpu_count else 0
        self.dev_total = [per_dev] * self.gpu_count
        self.dev_used = [0] * self.gpu_count
        self.dev_pods: List[List[dict]] = [[] for _ in range(self.gpu_count)]

    def add_pod(self, pod: dict) -> None:
        """addOrUpdatePod: account the pod's gpu-index against its devices."""
        mem = pod_gpu_mem(pod)
        try:
            idl = gpu_id_str_to_list(pod_gpu_index(pod))
        except ValueError:
            return
        for idx in idl:
            if 0 <= idx < self.gpu_count:
                if all(p is not pod for p in self.dev_pods[idx]):
                    self.dev_pods[idx].append(pod)
                self.dev_used[idx] += mem

    def export_info(self) -> dict:
        """ExportGpuNodeInfoAsNodeGpuInfo → the ffjson field layout the reference
        writes into the simon/node-gpu-share annotation (gpunodeinfo.go:345-368).
        Quantities are Mi-truncated strings, like the Go code's %dMi round-trip."""
        gpu_allocatable = self.gpu_count
        devs_brief: Dict[str, dict] = {}
        num_pods = 0
        for idx in range(self.gpu_count):
            used = self.dev_used[idx]
            total = self.dev_total[idx]
            if used >= total and total > 0:
                gpu_allocatable -= 1
            pod_list = [
                f"{namespace_of(p)}:{name_of(p)}" for p in sorted(
                    self.dev_pods[idx], key=lambda p: (namespace_of(p), name_of(p))
                )
            ]
            devs_brief[str(idx)] = {
                "PodList": pod_list,
                "GpuTotalMemory": _mi(total),
                "GpuUsedMemory": _mi(used),
            }
            num_pods += len(pod_list)
        return {
            "DevsBrief": devs_brief,
            "GpuCount": self.gpu_count,
            "GpuAllocatable": gpu_allocatable,
            "GpuModel": self.model,
            "GpuTotalMemory": _mi(self.total_mem),
            "NumPods": num_pods,
        }


def _mi(v: int) -> str:
    return f"{v // (1 << 20)}Mi"


class GpuShareHost:
    """The host half of the plugin: replays allocations for committed pods."""

    def __init__(self, nodes: List[dict]) -> None:
        store = getattr(nodes, "store", None)  # simulator/store.py LazyNodeSeq
        if store is not None and not store.may_have_gpu:
            # columnar fast path: no block template advertises GPU memory, so
            # the per-node dict scan would materialize N dicts to learn that
            self.states: List[Optional[GpuNodeState]] = [None] * len(nodes)
        else:
            self.states = [
                GpuNodeState(n) if node_total_gpu_memory(n) > 0 else None
                for n in nodes
            ]
        self.max_devs = max((s.gpu_count for s in self.states if s), default=0)
        self._assume_seq = 0
        # nodes whose annotation/allocatable writeback is pending: the ledger
        # updates per pod, but the JSON rewrite happens once per node per
        # schedule_pods call (engine flushes) instead of once per commit
        self._dirty: set = set()

    @property
    def enabled(self) -> bool:
        return self.max_devs > 0

    def dev_total_matrix(self, max_devs: int) -> np.ndarray:
        """[N, max_devs] per-device total memory (0 = absent device)."""
        out = np.zeros((len(self.states), max_devs), np.float32)
        for i, s in enumerate(self.states):
            if s:
                out[i, : s.gpu_count] = s.dev_total
        return out

    def dev_used_matrix(self, max_devs: int) -> np.ndarray:
        out = np.zeros((len(self.states), max_devs), np.float32)
        for i, s in enumerate(self.states):
            if s:
                out[i, : s.gpu_count] = s.dev_used
        return out

    def reserve(self, pod: dict, node_i: int) -> bool:
        """The Reserve path for one committed pod: allocate ids, annotate the pod,
        refresh the node annotation + whole-GPU allocatable. Returns False when the
        pod needs no GPU."""
        mem = pod_gpu_mem(pod)
        if mem <= 0:
            return False
        state = self.states[node_i]
        if state is None:
            return False  # kernel filter should prevent this
        ids, found = allocate_gpu_ids(
            state.dev_total, list(state.dev_used), mem, pod_gpu_count(pod),
            pod_gpu_index(pod),
        )
        if not found:
            return False
        anns = pod.setdefault("metadata", {}).setdefault("annotations", {})
        anns[C.AnnoGpuIndex] = ids
        self._assume_seq += 1
        anns[C.AnnoGpuAssumeTime] = str(self._assume_seq)
        state.add_pod(pod)
        self._dirty.add(node_i)
        return True

    def _refresh_node(self, state: GpuNodeState) -> None:
        import json

        info = state.export_info()
        md = state.node.setdefault("metadata", {})
        md.setdefault("annotations", {})[C.AnnoNodeGpuShare] = json.dumps(info)
        alloc = state.node.setdefault("status", {}).setdefault("allocatable", {})
        alloc[C.ResourceGpuCount] = str(info["GpuAllocatable"])

    def release(self, pod: dict, node_i: int) -> None:
        """Undo one committed pod's allocation (preemption eviction): subtract
        its memory from the devices named by its gpu-index annotation and drop
        it from the per-device pod lists. The reference has no release path —
        a deleted pod's share lingers in its cache — but leaving it here would
        desync the ledger from pods_on_node, which this build treats as the
        single source of truth (see simulator/preemption.py)."""
        mem = pod_gpu_mem(pod)
        state = self.states[node_i]
        if mem <= 0 or state is None:
            return
        try:
            idl = gpu_id_str_to_list(pod_gpu_index(pod))
        except ValueError:
            return
        for idx in idl:
            if 0 <= idx < state.gpu_count:
                state.dev_used[idx] -= mem
                state.dev_pods[idx] = [p for p in state.dev_pods[idx] if p is not pod]
        self._dirty.add(node_i)

    def snapshot(self):
        """Copy of all mutable ledger state + the node fields this plugin owns
        (annotation + whole-GPU allocatable), for preemption rewind."""
        states = []
        for s in self.states:
            if s is None:
                states.append(None)
                continue
            anns = (s.node.get("metadata") or {}).get("annotations") or {}
            alloc = (s.node.get("status") or {}).get("allocatable") or {}
            states.append((
                list(s.dev_used), [list(dp) for dp in s.dev_pods],
                anns.get(C.AnnoNodeGpuShare), alloc.get(C.ResourceGpuCount),
            ))
        return states, self._assume_seq, set(self._dirty)

    def restore(self, snap) -> None:
        states, self._assume_seq, self._dirty = snap[0], snap[1], set(snap[2])
        for s, rec in zip(self.states, states):
            if s is None or rec is None:
                continue
            s.dev_used = list(rec[0])
            s.dev_pods = [list(dp) for dp in rec[1]]
            anns = s.node.setdefault("metadata", {}).setdefault("annotations", {})
            if rec[2] is None:
                anns.pop(C.AnnoNodeGpuShare, None)
            else:
                anns[C.AnnoNodeGpuShare] = rec[2]
            alloc = s.node.setdefault("status", {}).setdefault("allocatable", {})
            if rec[3] is None:
                alloc.pop(C.ResourceGpuCount, None)
            else:
                alloc[C.ResourceGpuCount] = rec[3]

    def seed_pod(self, pod: dict, node_i: int) -> None:
        """Account one already-bound pod carrying a gpu-index annotation
        (live-cluster snapshots); O(1) per pod."""
        state = self.states[node_i]
        if state is None:
            return
        if pod_gpu_index(pod) and pod_gpu_mem(pod) > 0:
            state.add_pod(pod)
            self._dirty.add(node_i)

    def flush(self) -> None:
        """Write the pending node annotations + whole-GPU allocatable (the
        writeback half of Reserve, open-gpu-share.go:147-188) for every node
        touched since the last flush."""
        for node_i in self._dirty:
            self._refresh_node(self.states[node_i])
        self._dirty.clear()

    def seed_from_pods(self, pods_on_node: List[List[dict]]) -> None:
        """Account already-bound pods carrying gpu-index annotations."""
        for node_i, pods in enumerate(pods_on_node):
            for pod in pods:
                self.seed_pod(pod, node_i)


def gpu_report_rows(node: dict, pods: List[dict]) -> List[List[str]]:
    """Rows for the applier's 'GPU Node Resource' table, reading the node
    annotation the way reportClusterInfo does (apply.go:445-500)."""
    import json

    raw = annotations_of(node).get(C.AnnoNodeGpuShare)
    if not raw:
        return []
    try:
        info = json.loads(raw)
    except json.JSONDecodeError:
        return []
    total = parse_quantity(info.get("GpuTotalMemory", "0"))
    used = sum(pod_gpu_mem(p) * pod_gpu_count(p) for p in pods)
    pct = int(used / total * 100) if total else 0
    rows = [[
        f"{name_of(node)} ({info.get('GpuModel', '')})",
        f"{info.get('GpuCount', 0)} GPUs",
        f"{format_quantity(used, binary=True)}/{format_quantity(total, binary=True)}({pct}%)",
        f"{info.get('NumPods', 0)} Pods",
    ]]
    devs = info.get("DevsBrief") or {}
    for idx in sorted(devs, key=lambda k: (0, int(k)) if str(k).isdigit() else (1, str(k))):
        dev = devs[idx]
        dcap = parse_quantity(dev.get("GpuTotalMemory", "0"))
        if dcap <= 0:
            continue
        duse = parse_quantity(dev.get("GpuUsedMemory", "0"))
        dpct = int(duse / dcap * 100) if dcap else 0
        rows.append([
            f"{name_of(node)} ({info.get('GpuModel', '')})",
            str(idx),
            f"{format_quantity(duse, binary=True)}/{format_quantity(dcap, binary=True)}({dpct}%)",
            ", ".join(dev.get("PodList") or []),
        ])
    return rows
