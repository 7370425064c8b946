"""Pre-scheduler pod-ordering heuristics (reference pkg/algo).

The reference's AffinityQueue/TolerationQueue Less functions ignore their second argument
(affinity.go:21-23, toleration.go:19-21), so Go's unstable sort produces an
implementation-defined permutation whose *intent* is "pods with nodeSelector (resp.
tolerations) first". We implement that intent with stable partitions — deterministic and
order-preserving within each class (documented deviation).

GreedQueue (greed.go:10-83) orders by descending max-share of cluster-total cpu/memory
(DRF-style), pods with a pre-set nodeName first.
"""

from __future__ import annotations

from typing import List

from ..utils.objutil import pod_resource_requests
from ..utils.quantity import parse_milli, parse_quantity


def sort_affinity(pods: List[dict]) -> List[dict]:
    """Pods with a nodeSelector first (stable)."""
    return sorted(pods, key=lambda p: 0 if (p.get("spec") or {}).get("nodeSelector") else 1)


def sort_toleration(pods: List[dict]) -> List[dict]:
    """Pods with tolerations first (stable)."""
    return sorted(pods, key=lambda p: 0 if (p.get("spec") or {}).get("tolerations") else 1)


def share(alloc: float, total: float) -> float:
    """algo.Share (greed.go:70-83)."""
    if total == 0:
        return 0.0 if alloc == 0 else 1.0
    return alloc / total


def pod_share(pod: dict, total_cpu_milli: float, total_mem: float) -> float:
    """Max of cpu/memory share of cluster totals (greed.go calculatePodShare)."""
    req = pod_resource_requests(pod)
    if not req:
        return 0.0
    return max(
        share(req.get("cpu", 0.0), total_cpu_milli),
        share(req.get("memory", 0.0), total_mem),
    )


def sort_greed(pods: List[dict], nodes: List[dict]) -> List[dict]:
    """Descending max-share; pods with nodeName first (stable within classes)."""
    total_cpu = sum(parse_milli(((n.get("status") or {}).get("allocatable") or {}).get("cpu", 0)) for n in nodes)
    total_mem = sum(parse_quantity(((n.get("status") or {}).get("allocatable") or {}).get("memory", 0)) for n in nodes)

    def key(p):
        bound = 0 if (p.get("spec") or {}).get("nodeName") else 1
        return (bound, -pod_share(p, total_cpu, total_mem))

    return sorted(pods, key=key)
