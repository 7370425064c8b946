"""Placement-parity tooling: dump placements, compare two dumps.

The port's own copy of `open_simulator_tpu/parity.py`: a dump of either
package's result compares against the other's, and against
`tests/golden/demo1_placements.json`.

BASELINE.md's quality metric is "placement-match-rate vs serial kube-scheduler
>= 99%". Pods of one workload are interchangeable (the reference's selectHost
tie-break is uniformly random among max-score nodes, generic_scheduler.go:188),
and the simulator's fake nodes get randomized names (NewFakeNode,
utils.go:903-915) — so the comparable unit is the COUNT of pods per
(namespace, workload, node), with new nodes normalized to their sorted
per-node placement profile rather than their random names.

A dump is JSON:
  {"placements": {"<ns>/<workload>|<node>": count, ...},
   "new_nodes": <int>, "unscheduled": {"<ns>/<workload>": count}}

match_rate(a, b) = sum over keys of min(a[k], b[k]) / max(total_a, total_b).
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

from .core.types import SimulateResult
from .core import constants as C
from .utils.objutil import annotations_of, labels_of, name_of, namespace_of


def _workload_key(pod: dict) -> str:
    """Stable workload identity: strip the random suffix the controller
    expansion appends to generated names (utils.go's simpleNameGenerator)."""
    anns = annotations_of(pod)
    kind = anns.get(C.AnnoWorkloadKind) or "Pod"
    name = anns.get(C.AnnoWorkloadName) or name_of(pod)
    labs = labels_of(pod)
    app = labs.get("app") or labs.get("k8s-app")
    if kind in ("ReplicaSet", "Job") and app:
        # Deployment->synthetic RS and Job pods carry generated suffixes;
        # the app label is the stable identity
        name = app
    return f"{namespace_of(pod)}/{kind}/{name}"


def placement_dump(result: SimulateResult) -> dict:
    placements: Dict[str, int] = {}
    new_nodes = 0
    for ns in result.node_status:
        node_name = name_of(ns.node)
        # membership, not truthiness: the marker label's value is "" (NewFakeNode
        # sets an empty-valued simon/new-node label, utils.go:903-915)
        if C.LabelNewNode in (labels_of(ns.node) or {}):
            new_nodes += 1
            node_name = "<new>"  # random names; profile-compared below
        for pod in ns.pods:
            key = f"{_workload_key(pod)}|{node_name}"
            placements[key] = placements.get(key, 0) + 1
    unscheduled: Dict[str, int] = {}
    for up in result.unscheduled_pods:
        k = _workload_key(up.pod)
        unscheduled[k] = unscheduled.get(k, 0) + 1
    # per-new-node profiles, order-normalized
    profiles = []
    for ns in result.node_status:
        if C.LabelNewNode not in (labels_of(ns.node) or {}):
            continue
        cnt: Dict[str, int] = {}
        for pod in ns.pods:
            k = _workload_key(pod)
            cnt[k] = cnt.get(k, 0) + 1
        # lists, not tuples: dumps must survive a JSON round-trip unchanged
        profiles.append(sorted([k, v] for k, v in cnt.items()))
    profiles.sort()
    return {
        "placements": placements,
        "new_nodes": new_nodes,
        "new_node_profiles": profiles,
        "unscheduled": unscheduled,
    }


def match_rate(a: dict, b: dict) -> Tuple[float, dict]:
    """(rate, detail). Rate over aggregated (workload, node) placement counts;
    detail lists the disagreeing keys."""
    pa, pb = a.get("placements") or {}, b.get("placements") or {}
    if not pa and not pb:
        return 1.0, {}  # two empty dumps agree vacuously, not 0%
    keys = set(pa) | set(pb)
    agree = sum(min(pa.get(k, 0), pb.get(k, 0)) for k in keys)
    total = max(sum(pa.values()), sum(pb.values())) or 1
    detail = {
        k: (pa.get(k, 0), pb.get(k, 0))
        for k in sorted(keys)
        if pa.get(k, 0) != pb.get(k, 0)
    }
    return agree / total, detail


def load_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save_dump(dump: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dump, f, indent=1, sort_keys=True)

