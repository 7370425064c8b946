"""The Simulate() facade — the stable programmatic surface of the port.

Mirrors reference pkg/simulator/core.go:67-119: expand the cluster's workloads
into pods, run the cluster sync (placing bound pods and scheduling pending ones), then
deploy each app in order, accumulating unschedulable pods.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..core.types import AppResource, ResourceTypes, SimulateResult
from ..models.workloads import (
    expand_workloads_excluding_daemonsets,
    pods_from_daemonset,
)
from .engine import Simulator


def simulate(
    cluster: ResourceTypes,
    apps: List[AppResource],
    disable_progress: bool = True,
    patch_pod_funcs: Optional[List[Callable]] = None,
    device=None,
    sched_config=None,
) -> SimulateResult:
    """Run one full simulation; returns placements + unschedulable pods.

    `cluster.pods` is replaced by the expansion of all cluster workloads (raw pods,
    Deployments/RS/RC/STS/Jobs/CronJobs, then DaemonSets against the node list), exactly
    like Simulate (core.go:85-96). `device` is "cuda" (the default, None) or
    "cpu"; without a CUDA device only an explicit "cpu" runs. `sched_config`:
    an api/schedconfig.py SchedulerConfig (None = the default profile).
    """
    from ..utils.trace import Span

    with Span("Simulate", log_if_longer=1.0) as span:  # core.go:67-73 LogIfLong
        cluster = cluster.copy()
        pods = expand_workloads_excluding_daemonsets(cluster)
        for ds in cluster.daemon_sets:
            pods.extend(pods_from_daemonset(ds, cluster.nodes))
        cluster.pods = pods
        span.step("expand cluster workloads")

        sim = Simulator(cluster.nodes, disable_progress=disable_progress,
                        patch_pod_funcs=patch_pod_funcs, device=device,
                        sched_config=sched_config)
        result = sim.run_cluster(cluster)
        span.step("sync cluster")
        failed = list(result.unscheduled_pods)
        for app in apps:
            result = sim.schedule_app(app)
            span.step(f"schedule app {app.name}")
            failed.extend(result.unscheduled_pods)
        result.unscheduled_pods = failed
    return result
