"""Core result/resource types of the simulator's public API.

Mirrors reference pkg/simulator/core.go:19-57 (`SimulateResult`, `UnscheduledPod`,
`NodeStatus`, `ResourceTypes`, `AppResource`) — but objects are plain Python dicts parsed
from YAML (the k8s JSON shape), not generated client types. Accessors in
`open_simulator_torch.utils.objutil` provide the typed views.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class ResourceTypes:
    """Bucketed k8s objects making up a cluster or an app (core.go:36-50)."""

    pods: List[dict] = field(default_factory=list)
    nodes: List[dict] = field(default_factory=list)
    deployments: List[dict] = field(default_factory=list)
    replica_sets: List[dict] = field(default_factory=list)
    replication_controllers: List[dict] = field(default_factory=list)
    stateful_sets: List[dict] = field(default_factory=list)
    daemon_sets: List[dict] = field(default_factory=list)
    jobs: List[dict] = field(default_factory=list)
    cron_jobs: List[dict] = field(default_factory=list)
    services: List[dict] = field(default_factory=list)
    pod_disruption_budgets: List[dict] = field(default_factory=list)
    storage_classes: List[dict] = field(default_factory=list)
    persistent_volume_claims: List[dict] = field(default_factory=list)
    config_maps: List[dict] = field(default_factory=list)

    def extend(self, other: "ResourceTypes") -> None:
        for f in self.__dataclass_fields__:
            getattr(self, f).extend(getattr(other, f))

    def copy(self) -> "ResourceTypes":
        out = ResourceTypes()
        for f in self.__dataclass_fields__:
            setattr(out, f, list(getattr(self, f)))
        return out


@dataclass
class AppResource:
    """One application to deploy, in order (core.go:52-57)."""

    name: str
    resource: ResourceTypes


@dataclass
class UnscheduledPod:
    """A pod the scheduler could not place, with a k8s-style reason message (core.go:25-29)."""

    pod: dict
    reason: str


@dataclass
class NodeStatus:
    """Per-node placement: the node object and every pod bound to it (core.go:31-34)."""

    node: dict
    pods: List[dict] = field(default_factory=list)


@dataclass
class SimulateResult:
    """Outcome of one simulation (core.go:19-23).

    `backend_path` (extension, simonguard): the JAX backends the run executed
    on, in order — `["tpu"]` for a clean run, `["tpu", "cpu"]` after a
    mid-run device-failure failover. A degraded run changes this field and
    the guard metrics, never silently just the numbers."""

    unscheduled_pods: List[UnscheduledPod] = field(default_factory=list)
    node_status: List[NodeStatus] = field(default_factory=list)
    backend_path: List[str] = field(default_factory=list)

    @property
    def all_scheduled(self) -> bool:
        return not self.unscheduled_pods

    def node_map(self) -> Dict[str, NodeStatus]:
        return {ns.node["metadata"]["name"]: ns for ns in self.node_status}


# Kind string → ResourceTypes field name (yamlio uses this to bucket decoded docs).
KIND_TO_FIELD = {
    "Pod": "pods",
    "Node": "nodes",
    "Deployment": "deployments",
    "ReplicaSet": "replica_sets",
    "ReplicationController": "replication_controllers",
    "StatefulSet": "stateful_sets",
    "DaemonSet": "daemon_sets",
    "Job": "jobs",
    "CronJob": "cron_jobs",
    "Service": "services",
    "PodDisruptionBudget": "pod_disruption_budgets",
    "StorageClass": "storage_classes",
    "PersistentVolumeClaim": "persistent_volume_claims",
    "ConfigMap": "config_maps",
}
