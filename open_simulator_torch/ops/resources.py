"""Resource-axis registry: maps k8s resource names to columns of the [N, R] / [P, R]
tensors.

The first four columns are fixed (cpu in milli-cores, memory/ephemeral in bytes, pod
count); extended resources (nvidia.com/gpu, alibabacloud.com/gpu-mem, hugepages-*) get
columns in discovery order. Mirrors the Resource struct of the vendored scheduler
(framework/types.go: MilliCPU, Memory, EphemeralStorage, AllowedPodNumber, ScalarResources).
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

from ..utils.objutil import CPU, EPHEMERAL, MEMORY, PODS, node_allocatable, pod_resource_requests
from .contracts import shaped

# DEVICE-BOUNDARY NOTE: every vector built here is float64 ON PURPOSE — k8s
# memory quantities (e.g. 16Ti = 2**44 bytes) lose integer precision in f32,
# so staging/accumulation stays 64-bit on the host. The encoder owns the one
# sanctioned narrowing to f32 when rows enter the device tables; each f64
# allocation below carries a simonlint dtype-drift waiver pointing here.

# NonZero defaults (vendored util/non_zero.go:34-37): used by LeastAllocated /
# BalancedAllocation scoring only, never by the Fit filter.
DEFAULT_MILLI_CPU = 100.0
DEFAULT_MEMORY = 200.0 * 1024 * 1024

FIXED = (CPU, MEMORY, EPHEMERAL, PODS)
CPU_I, MEM_I, EPH_I, PODS_I = 0, 1, 2, 3


class ResourceAxis:
    """Stable resource-name → column mapping for one simulation."""

    def __init__(self) -> None:
        self.names: List[str] = list(FIXED)
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}

    def intern(self, name: str) -> int:
        i = self.index.get(name)
        if i is None:
            i = len(self.names)
            self.names.append(name)
            self.index[name] = i
        return i

    def discover(self, nodes: Iterable[dict], pods: Iterable[dict]) -> None:
        for node in nodes:
            for k in node_allocatable(node):
                self.intern(k)
        for pod in pods:
            for k in pod_resource_requests(pod):
                self.intern(k)

    @property
    def R(self) -> int:
        return len(self.names)

    @shaped(ret="[R] f64")
    def node_vector(self, node: dict) -> np.ndarray:
        """Allocatable as a dense row (absent resources = 0)."""
        v = np.zeros(self.R, np.float64)  # simonlint: ignore[dtype-drift] -- host staging, see device-boundary note
        for k, q in node_allocatable(node).items():
            v[self.index[k]] = q
        return v

    @shaped(ret="[R] f64")
    def pod_vector(self, pod: dict) -> np.ndarray:
        """Pod request row; the pods-count column is always 1 (one scheduling slot)."""
        v = np.zeros(self.R, np.float64)  # simonlint: ignore[dtype-drift] -- host staging, see device-boundary note
        for k, q in pod_resource_requests(pod).items():
            if k in self.index:
                v[self.index[k]] = q
            # a resource absent from every node can't be in the axis; the Fit kernel
            # treats it as unsatisfiable via the request_unknown flag set by the encoder
        v[PODS_I] = 1.0
        return v


@shaped(ret="[2] f64")
def pod_nonzero_cpu_mem(pod: dict) -> np.ndarray:
    """Scoring-side request: per-container max(request, default) summed, init containers
    taken as a per-resource max — the NonZeroRequested accumulation of the vendored
    scheduler (framework/types.go calculateResource + non_zero.go)."""
    from ..utils.quantity import parse_milli, parse_quantity

    spec = pod.get("spec") or {}
    cpu = mem = 0.0
    for c in spec.get("containers") or []:
        req = (c.get("resources") or {}).get("requests") or {}
        cpu += max(parse_milli(req["cpu"]), DEFAULT_MILLI_CPU) if "cpu" in req else DEFAULT_MILLI_CPU
        mem += max(parse_quantity(req["memory"]), DEFAULT_MEMORY) if "memory" in req else DEFAULT_MEMORY
    for c in spec.get("initContainers") or []:
        req = (c.get("resources") or {}).get("requests") or {}
        icpu = max(parse_milli(req["cpu"]), DEFAULT_MILLI_CPU) if "cpu" in req else DEFAULT_MILLI_CPU
        imem = max(parse_quantity(req["memory"]), DEFAULT_MEMORY) if "memory" in req else DEFAULT_MEMORY
        cpu = max(cpu, icpu)
        mem = max(mem, imem)
    return np.array([cpu, mem], np.float64)  # simonlint: ignore[dtype-drift] -- host staging, see device-boundary note


def pod_has_unknown_resource(pod: dict, axis: ResourceAxis) -> bool:
    """True when the pod requests a resource no node advertises — always infeasible."""
    return any(k not in axis.index for k in pod_resource_requests(pod))
