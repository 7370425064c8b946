"""Synthetic cluster/workload generators for benchmarks and harness dry-runs.

Shapes mirror BASELINE.md's configs (1k nodes / 10k nginx replicas; hard-predicate
stress with taints + affinities) without copying any reference fixture files.
"""

from __future__ import annotations

import json
import random
from typing import List, Optional, Tuple


def synth_node(
    i: int,
    cpu_milli: int = 32000,
    mem_bytes: int = 128 << 30,
    pods: int = 256,
    n_zones: int = 0,
    taint_every: int = 0,
) -> dict:
    name = f"node-{i:05d}"
    labels = {"kubernetes.io/hostname": name, "node-index": str(i)}
    if n_zones:
        labels["topology.kubernetes.io/zone"] = f"zone-{i % n_zones}"
    alloc = {"cpu": f"{cpu_milli}m", "memory": str(mem_bytes), "pods": str(pods)}
    node = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels},
        "spec": {},
        "status": {"allocatable": dict(alloc), "capacity": dict(alloc)},
    }
    if taint_every and i % taint_every == 0:
        node["spec"]["taints"] = [
            {"key": "synth/dedicated", "value": "batch", "effect": "NoSchedule"}
        ]
    return node


def synth_pod(
    i: int,
    cpu_milli: int = 100,
    mem_bytes: int = 256 << 20,
    labels: Optional[dict] = None,
    tolerate: bool = False,
    anti_affinity_on: Optional[str] = None,
    spread_zone: bool = False,
) -> dict:
    spec: dict = {
        "containers": [
            {
                "name": "app",
                "image": "nginx:1.25",
                "resources": {
                    "requests": {"cpu": f"{cpu_milli}m", "memory": str(mem_bytes)}
                },
            }
        ]
    }
    lbl = {"app": "synth", **(labels or {})}
    if tolerate:
        spec["tolerations"] = [
            {"key": "synth/dedicated", "operator": "Equal", "value": "batch",
             "effect": "NoSchedule"}
        ]
    if anti_affinity_on:
        spec["affinity"] = {
            "podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {
                        "labelSelector": {"matchLabels": {"app": anti_affinity_on}},
                        "topologyKey": "kubernetes.io/hostname",
                    }
                ]
            }
        }
    if spread_zone:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": 2,
                "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": "synth"}},
            }
        ]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": f"pod-{i:06d}", "namespace": "default", "labels": lbl},
        "spec": spec,
    }


def synth_cluster(
    n_nodes: int,
    n_pods: int,
    hard_predicates: bool = False,
) -> Tuple[List[dict], List[dict]]:
    """(nodes, pods). With hard_predicates, adds zones, a tainted slice of nodes,
    and block-structured workloads (contiguous replica runs, the shape real apps
    produce) cycling plain / tolerating / self-anti-affinity / zone-spread pods —
    BASELINE.md's stress shape."""
    if not hard_predicates:
        nodes = [synth_node(i) for i in range(n_nodes)]
        pods = [synth_pod(i) for i in range(n_pods)]
        return nodes, pods

    nodes = [synth_node(i, n_zones=8, taint_every=10) for i in range(n_nodes)]
    pods: List[dict] = []
    block = max(1, n_pods // 50)
    k = 0
    while len(pods) < n_pods:
        n = min(block, n_pods - len(pods))
        kind = k % 5
        app = f"synth-{k}"
        for i in range(n):
            idx = len(pods)
            if kind == 1:
                pods.append(synth_pod(idx, labels={"app": app}, tolerate=True))
            elif kind == 3:
                # self anti-affinity: at most one replica per node
                cap = min(n, max(1, n_nodes // 2))
                if i < cap:
                    pods.append(
                        synth_pod(idx, labels={"app": app}, anti_affinity_on=app)
                    )
                else:
                    pods.append(synth_pod(idx, labels={"app": app}))
            elif kind == 4:
                # zone topology spread (serial path: spread state is stateful)
                pods.append(synth_pod(idx, spread_zone=True))
            else:
                pods.append(synth_pod(idx, labels={"app": app}))
        k += 1
    return nodes, pods


def synth_watch_stream(
    n_nodes: int,
    n_events: int,
    seed: int = 0,
    bookmark_every: int = 64,
    n_bound: int = 0,
    n_templates: int = 8,
    start_rv: int = 1000,
) -> Tuple[List[dict], List[dict], List[str]]:
    """A deterministic recorded kube-watch stream over a synthetic cluster:
    (initial nodes, initially bound pods, JSONL watch lines).

    The stream is churn the resident-image delta path can express end to
    end — bound-pod ADDED/DELETED from a small template pool (so decode's
    template interning has something to intern), occasional node ADDED and
    drain (MODIFIED with spec.unschedulable) — delimited by BOOKMARK lines
    every `bookmark_every` events. resourceVersions are globally monotone;
    deletes only target pods committed before the current window so a
    window's net effect is never a wash (the chaos gate's relist windows
    stay meaningful). Drains evict their pods from the generator's own
    live-set, mirroring the image's node_drain semantics.
    """
    rng = random.Random(seed)
    nodes = [synth_node(i) for i in range(n_nodes)]
    live_nodes = [f"node-{i:05d}" for i in range(n_nodes)]

    bound: List[dict] = []
    pods_by_node: dict = {name: set() for name in live_nodes}
    live_pods: dict = {}  # key -> node name
    for i in range(n_bound):
        p = synth_pod(i, cpu_milli=100 + 50 * (i % n_templates),
                      labels={"app": f"seed-{i % n_templates}"})
        node = live_nodes[i % len(live_nodes)]
        p["spec"]["nodeName"] = node
        bound.append(p)
        key = f"default/{p['metadata']['name']}"
        live_pods[key] = node
        pods_by_node[node].add(key)

    def _line(typ: str, obj: dict) -> str:
        return json.dumps({"type": typ, "object": obj},
                          separators=(",", ":"))

    lines: List[str] = []
    rv = start_rv
    next_node_i = n_nodes
    next_pod_i = 0
    # pods eligible for deletion: committed before the current window
    deletable = sorted(live_pods)
    in_window = 0

    for _ in range(n_events):
        rv += 1
        r = rng.random()
        if r < 0.04 and len(live_nodes) > max(2, n_nodes // 2):
            # drain one node; its pods leave the cluster with it
            name = live_nodes.pop(rng.randrange(len(live_nodes)))
            for key in pods_by_node.pop(name, ()):
                live_pods.pop(key, None)
            deletable = [k for k in deletable if k in live_pods]
            obj = synth_node(int(name.split("-")[-1]))
            obj["spec"]["unschedulable"] = True
            obj["metadata"]["resourceVersion"] = str(rv)
            lines.append(_line("MODIFIED", obj))
        elif r < 0.07:
            obj = synth_node(next_node_i)
            name = obj["metadata"]["name"]
            next_node_i += 1
            live_nodes.append(name)
            pods_by_node[name] = set()
            obj["metadata"]["resourceVersion"] = str(rv)
            lines.append(_line("ADDED", obj))
        elif r < 0.27 and deletable:
            key = deletable.pop(rng.randrange(len(deletable)))
            node = live_pods.pop(key, None)
            if node is not None:
                pods_by_node.get(node, set()).discard(key)
            ns, name = key.split("/", 1)
            lines.append(_line("DELETED", {
                "kind": "Pod", "apiVersion": "v1",
                "metadata": {"name": name, "namespace": ns,
                             "resourceVersion": str(rv)}}))
        else:
            t = rng.randrange(n_templates)
            p = synth_pod(0, cpu_milli=100 + 50 * t,
                          labels={"app": f"stream-{t}"})
            name = f"wpod-{next_pod_i:06d}"
            next_pod_i += 1
            node = live_nodes[rng.randrange(len(live_nodes))]
            p["metadata"]["name"] = name
            p["metadata"]["resourceVersion"] = str(rv)
            p["kind"] = "Pod"
            p["spec"]["nodeName"] = node
            key = f"default/{name}"
            live_pods[key] = node
            pods_by_node[node].add(key)
            lines.append(_line("ADDED", p))
        in_window += 1
        if in_window >= bookmark_every:
            rv += 1
            lines.append(_line("BOOKMARK", {
                "kind": "Pod",
                "metadata": {"resourceVersion": str(rv)}}))
            deletable = sorted(live_pods)
            in_window = 0
    if in_window:
        rv += 1
        lines.append(_line("BOOKMARK", {
            "kind": "Pod", "metadata": {"resourceVersion": str(rv)}}))
    return nodes, bound, lines


def synth_cluster_store(
    n_nodes: int,
    n_pods: int,
    hard_predicates: bool = False,
):
    """Columnar twin of synth_cluster: the SAME cluster and workload, emitted
    as a (NodeStore, PodStore) pair (simulator/store.py) — one node template
    block and one pod template block per synth "app" instead of n dicts. The
    double-encode parity suite (tests/test_store.py) asserts a Simulator over
    this form encodes and places bit-identically to the dict form; at 1M+
    pods this is the only form that fits in host memory at all."""
    from ..simulator.store import NodeStore, PodStore

    def node_template(taint: bool = False) -> dict:
        t = synth_node(0)
        t["metadata"] = {}
        if not taint:
            t.get("spec", {}).pop("taints", None)
        return t

    def pod_template(**kw) -> dict:
        t = synth_pod(0, **kw)
        t["metadata"].pop("name", None)
        return t

    ns = NodeStore()
    ps = PodStore()
    if not hard_predicates:
        ns.add_block(node_template(), n_nodes, name_fmt="node-{0:05d}",
                     index_labels=("node-index",))
        ps.add_block(pod_template(), n_pods, name_fmt="pod-{0:06d}")
        return ns, ps

    ns.add_block(
        node_template(), n_nodes, name_fmt="node-{0:05d}",
        index_labels=("node-index",),
        zone_cycle=("topology.kubernetes.io/zone", "zone-{0}", 8),
        taint=({"key": "synth/dedicated", "value": "batch",
                "effect": "NoSchedule"}, 10))
    block = max(1, n_pods // 50)
    made = 0
    k = 0
    while made < n_pods:
        n = min(block, n_pods - made)
        kind = k % 5
        app = f"synth-{k}"
        if kind == 1:
            ps.add_block(pod_template(labels={"app": app}, tolerate=True),
                         n, name_fmt="pod-{0:06d}")
        elif kind == 3:
            cap = min(n, max(1, n_nodes // 2))
            ps.add_block(pod_template(labels={"app": app},
                                      anti_affinity_on=app),
                         cap, name_fmt="pod-{0:06d}")
            if n > cap:
                ps.add_block(pod_template(labels={"app": app}), n - cap,
                             name_fmt="pod-{0:06d}")
        elif kind == 4:
            ps.add_block(pod_template(spread_zone=True), n,
                         name_fmt="pod-{0:06d}")
        else:
            ps.add_block(pod_template(labels={"app": app}), n,
                         name_fmt="pod-{0:06d}")
        made += n
        k += 1
    return ns, ps
