"""Scheduling scenarios shared by the PyTorch port's parity tests.

Each case builds plain dicts (nodes, cluster objects, apps) with the fixture
builders, so the JAX package and the port each wrap them in their own
`ResourceTypes`/`AppResource`. The shapes are those of tests/test_simulate.py
(basic placement, taints and selectors, inter-pod affinity, topology
spread, scoring, host ports, bound-pod order), plus ScheduleAnyway spread and
weighted pod affinity, which that file does not cover.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

from fixtures import (
    make_daemonset,
    make_deployment,
    make_job,
    make_node,
    make_pod,
    make_replicaset,
    make_statefulset,
    master_taint,
    master_toleration,
)

# (cluster ResourceTypes kwargs, [(app name, app ResourceTypes kwargs)])
Case = Tuple[dict, List[Tuple[str, dict]]]


def _anti_sts(name, replicas, required=True):
    anti = {"labelSelector": {"matchExpressions": [
        {"key": "app", "operator": "In", "values": [name]}]},
        "topologyKey": "kubernetes.io/hostname"}
    affinity = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [anti]} if required else
        {"preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 100, "podAffinityTerm": anti}]}}
    return make_statefulset(name, replicas=replicas, cpu="500m", memory="512Mi",
                            affinity=affinity)


def _spread_dep(name, replicas, when, max_skew=1, key="zone"):
    labels = {"app": name}
    dep = make_deployment(name, replicas=replicas, cpu="100m", memory="128Mi", labels=labels)
    dep["spec"]["template"]["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": max_skew, "topologyKey": key, "whenUnsatisfiable": when,
        "labelSelector": {"matchLabels": labels}}]
    return dep


def basic() -> Case:
    nodes = [make_node(f"w{i}", cpu="8", memory="16Gi") for i in range(4)]
    nodes.append(make_node("tiny", cpu="2", memory="4Gi", pods="3"))
    bound = make_pod("hog", cpu="7", memory="1Gi", node_name="w0")
    return ({"nodes": nodes, "pods": [bound]},
            [("a", {"deployments": [make_deployment("web", replicas=8, cpu="1", memory="1Gi"),
                                    make_deployment("big", replicas=6, cpu="1500m",
                                                    memory="1Gi")]}),
             ("b", {"deployments": [make_deployment("small", replicas=40, cpu="10m",
                                                    memory="16Mi")]})])


def taints_and_selectors() -> Case:
    gt = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
        "nodeSelectorTerms": [{"matchExpressions": [
            {"key": "gen", "operator": "Gt", "values": ["5"]}]}]}}}
    pref = {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": 100, "preference": {"matchExpressions": [
            {"key": "tier", "operator": "In", "values": ["gold"]}]}}]}}
    nodes = [make_node("m0", taints=[master_taint()]),
             make_node("ssd0", labels={"disk": "ssd", "gen": "3"}),
             make_node("hdd0", labels={"disk": "hdd", "gen": "7", "tier": "gold"}),
             make_node("off", unschedulable=True)]
    pods = [make_pod("tol", cpu="1", memory="1Gi", tolerations=[master_toleration()]),
            make_pod("sel", cpu="1", memory="1Gi", node_selector={"disk": "ssd"}),
            make_pod("gt", affinity=gt), make_pod("pref", affinity=pref),
            make_pod("nowhere", node_selector={"disk": "nvme"})]
    return ({"nodes": nodes},
            [("a", {"deployments": [make_deployment("d", replicas=5, cpu="1", memory="1Gi")],
                    "pods": pods})])


def untolerated_taint() -> Case:
    return ({"nodes": [make_node("m0", taints=[master_taint()])]},
            [("a", {"pods": [make_pod("p", cpu="1", memory="1Gi")]})])


def interpod_affinity() -> Case:
    follower_aff = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "labelSelector": {"matchLabels": {"app": "db"}},
        "topologyKey": "kubernetes.io/hostname"}]}}
    solo_aff = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "labelSelector": {"matchLabels": {"app": "solo"}},
        "topologyKey": "kubernetes.io/hostname"}]}}
    ghost_aff = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "labelSelector": {"matchLabels": {"app": "ghost"}},
        "topologyKey": "kubernetes.io/hostname"}]}}
    guard_aff = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
        "labelSelector": {"matchLabels": {"team": "red"}},
        "topologyKey": "kubernetes.io/hostname"}]}}
    weighted = {"podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": 30, "podAffinityTerm": {"labelSelector": {"matchLabels": {"app": "db"}},
                                           "topologyKey": "kubernetes.io/hostname"}}]}}
    pods = ([make_pod("base", labels={"app": "db"})]
            + [make_pod(f"f{i}", labels={"app": "web"}, affinity=follower_aff) for i in range(2)]
            + [make_pod("solo", labels={"app": "solo"}, affinity=solo_aff),
               make_pod("lost", labels={"app": "solo2"}, affinity=ghost_aff),
               make_pod("guard", labels={"team": "blue"}, affinity=guard_aff),
               make_pod("intruder", labels={"team": "red"}),
               make_pod("near", labels={"app": "cache"}, affinity=weighted)])
    return ({"nodes": [make_node(f"w{i}") for i in range(3)]},
            [("a", {"stateful_sets": [_anti_sts("sts", 4), _anti_sts("soft", 5, required=False)],
                    "pods": pods})])


def topology_spread() -> Case:
    nodes = [make_node(f"w{i}", labels={"zone": f"z{i % 3}"}) for i in range(6)]
    nodes.append(make_node("nolabel"))
    return ({"nodes": nodes},
            [("a", {"deployments": [_spread_dep("hard", 7, "DoNotSchedule"),
                                    _spread_dep("soft", 9, "ScheduleAnyway"),
                                    _spread_dep("host", 8, "ScheduleAnyway", max_skew=2,
                                                key="kubernetes.io/hostname")]})])


def scoring_and_workloads() -> Case:
    svc = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "svc", "namespace": "default"},
           "spec": {"selector": {"app": "spread-me"}}}
    nodes = [
        make_node("master-1", cpu="8", memory="16Gi",
                  labels={"node-role.kubernetes.io/master": "", "zone": "a"},
                  taints=[master_taint()]),
        make_node("worker-1", cpu="16", memory="32Gi", labels={"zone": "a"}),
        make_node("worker-2", cpu="16", memory="32Gi", labels={"zone": "b"}),
        make_node("small", cpu="4", memory="8Gi"),
    ]
    app = {
        "deployments": [make_deployment("web", replicas=4, cpu="1", memory="1Gi"),
                        make_deployment("spread-me", replicas=6, cpu="100m", memory="128Mi",
                                        labels={"app": "spread-me"})],
        "stateful_sets": [make_statefulset("db", replicas=2, cpu="2", memory="4Gi")],
        "daemon_sets": [make_daemonset("log")],
        "jobs": [make_job("batch", completions=3)],
        "replica_sets": [make_replicaset("rs", replicas=2)],
        "pods": [make_pod("single", cpu="500m", memory="512Mi",
                          tolerations=[master_toleration()]),
                 make_pod("p8080", cpu="100m", memory="128Mi", host_ports=[8080]),
                 make_pod("q8080", cpu="100m", memory="128Mi", host_ports=[8080]),
                 make_pod("r9090", cpu="100m", memory="128Mi", host_ports=[9090])],
    }
    return ({"nodes": nodes, "services": [svc], "daemon_sets": [make_daemonset("agent")]},
            [("app", app)])


def bound_pod_order() -> Case:
    unbound = make_pod("early", cpu="4", memory="1Gi")
    hog = make_pod("hog", cpu="7", memory="1Gi", node_name="w0")
    late = make_pod("late", cpu="4", memory="1Gi")
    ghost = make_pod("ghost", cpu="1", memory="1Gi", node_name="nowhere")
    return ({"nodes": [make_node("w0", cpu="8", memory="16Gi")],
             "pods": [unbound, hog, late, ghost]}, [])


CASES: Dict[str, Callable[[], Case]] = {
    "basic": basic,
    "taints_and_selectors": taints_and_selectors,
    "untolerated_taint": untolerated_taint,
    "interpod_affinity": interpod_affinity,
    "topology_spread": topology_spread,
    "scoring_and_workloads": scoring_and_workloads,
    "bound_pod_order": bound_pod_order,
}


def build(pkg_types, case: Case):
    """(cluster, apps) as `pkg_types`' (a core.types module) own classes."""
    cluster_kw, apps = copy.deepcopy(case)
    cluster = pkg_types.ResourceTypes(**cluster_kw)
    return cluster, [pkg_types.AppResource(name, pkg_types.ResourceTypes(**kw))
                     for name, kw in apps]


def outcome(result) -> dict:
    """Node per pod and the reason of every unscheduled pod, in order."""
    nodes = {}
    for ns in result.node_status:
        for p in ns.pods:
            md = p["metadata"]
            nodes[(md.get("namespace"), md["name"])] = ns.node["metadata"]["name"]
    reasons = [u.reason for u in result.unscheduled_pods]
    return {"nodes": nodes, "reasons": reasons}
