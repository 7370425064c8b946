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


def _spread_term(app: str, topo: str, when: str, max_skew: int) -> dict:
    return {"maxSkew": max_skew, "topologyKey": topo, "whenUnsatisfiable": when,
            "labelSelector": {"matchLabels": {"app": app}}}


def synth_spread_cluster(
    n_nodes: int,
    n_pods: int,
    n_zones: int = 8,
) -> Tuple[List[dict], List[dict], List[dict]]:
    """(nodes, pods, services): a zoned cluster whose pods spread against
    themselves, in contiguous replica blocks cycling four shapes — a
    ScheduleAnyway zone spread, a Service-backed Deployment (SelectorSpread
    with the zone blend), two DoNotSchedule terms on zone and hostname, and
    plain pods. The first three are the group-serial route's shapes (live
    ScheduleAnyway, live zoned SelectorSpread, several live DoNotSchedule
    terms); the services list holds the one Service the second shape needs."""
    zone = "topology.kubernetes.io/zone"
    nodes = [synth_node(i, n_zones=n_zones) for i in range(n_nodes)]
    services = [{"apiVersion": "v1", "kind": "Service",
                 "metadata": {"name": "web", "namespace": "default"},
                 "spec": {"selector": {"app": "svc-web"}}}]
    pods: List[dict] = []
    block = max(8, n_pods // 40)
    k = 0
    while len(pods) < n_pods:
        n = min(block, n_pods - len(pods))
        kind = k % 4
        for _ in range(n):
            idx = len(pods)
            if kind == 0:
                app = f"sa-{k}"
                pod = synth_pod(idx, cpu_milli=200, labels={"app": app})
                pod["spec"]["topologySpreadConstraints"] = [
                    _spread_term(app, zone, "ScheduleAnyway", 1)]
            elif kind == 1:
                pod = synth_pod(idx, cpu_milli=150, mem_bytes=128 << 20,
                                labels={"app": "svc-web"})
            elif kind == 2:
                app = f"dns-{k}"
                pod = synth_pod(idx, cpu_milli=250, labels={"app": app})
                pod["spec"]["topologySpreadConstraints"] = [
                    _spread_term(app, zone, "DoNotSchedule", 2),
                    _spread_term(app, "kubernetes.io/hostname", "DoNotSchedule", 1)]
            else:
                pod = synth_pod(idx, labels={"app": f"plain-{k}"})
            pods.append(pod)
        k += 1
    return nodes, pods, services


def _required_term(app: str, topo: str) -> dict:
    return {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": topo}]}


def synth_affinity_cluster(
    n_nodes: int,
    n_pods: int,
    n_zones: int = 8,
) -> Tuple[List[dict], List[dict], List[dict]]:
    """(nodes, pods, services): a zoned cluster of three node sizes (32, 36
    or 40 cores and 128, 136 or 144 GiB by i % 3, so the normalizer inputs
    differ between nodes) whose pods constrain themselves, in replica blocks
    cycling five shapes — required zone self-affinity, a hostname
    DoNotSchedule spread (maxSkew 1), a group of ten replicas with required
    zone self-anti-affinity (more replicas than zones: the rest fail), a zone
    DoNotSchedule spread (maxSkew 2), and a block of the Service-backed
    Deployment `svc-web` with required zone self-affinity (SelectorSpread
    live). Every block is an affinity-wave segment; the services list holds
    the one Service the last shape needs."""
    zone = "topology.kubernetes.io/zone"
    host = "kubernetes.io/hostname"
    nodes = [synth_node(i, cpu_milli=32000 + 4000 * (i % 3),
                        mem_bytes=(128 + 8 * (i % 3)) << 30, n_zones=n_zones)
             for i in range(n_nodes)]
    services = [{"apiVersion": "v1", "kind": "Service",
                 "metadata": {"name": "web", "namespace": "default"},
                 "spec": {"selector": {"app": "svc-web"}}}]
    pods: List[dict] = []
    block = max(8, n_pods // 40)
    k = 0
    while len(pods) < n_pods:
        kind = k % 5
        n = min(10 if kind == 2 else block, n_pods - len(pods))
        for _ in range(n):
            idx = len(pods)
            if kind == 0:
                app = f"aff-{k}"
                pod = synth_pod(idx, labels={"app": app})
                pod["spec"]["affinity"] = {"podAffinity": _required_term(app, zone)}
            elif kind == 1:
                app = f"host-{k}"
                pod = synth_pod(idx, cpu_milli=200, labels={"app": app})
                pod["spec"]["topologySpreadConstraints"] = [
                    _spread_term(app, host, "DoNotSchedule", 1)]
            elif kind == 2:
                app = f"anti-{k}"
                pod = synth_pod(idx, labels={"app": app})
                pod["spec"]["affinity"] = {"podAntiAffinity": _required_term(app, zone)}
            elif kind == 3:
                app = f"zone-{k}"
                pod = synth_pod(idx, cpu_milli=200, labels={"app": app})
                pod["spec"]["topologySpreadConstraints"] = [
                    _spread_term(app, zone, "DoNotSchedule", 2)]
            else:
                pod = synth_pod(idx, labels={"app": "svc-web"})
                pod["spec"]["affinity"] = {"podAffinity": _required_term("svc-web", zone)}
            pods.append(pod)
        k += 1
    return nodes, pods, services


_GPU_MODEL = "alibabacloud.com/gpu-card-model"
_GPU_COUNT = "alibabacloud.com/gpu-count"
_GPU_MEM = "alibabacloud.com/gpu-mem"
_GPU_INDEX = "alibabacloud.com/gpu-index"
_NODE_STORAGE = "simon/node-local-storage"
_POD_STORAGE = "simon/pod-local-storage"
_GIB = 1 << 30


def _storage_class(name: str, **params) -> dict:
    return {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
            "metadata": {"name": name}, "provisioner": "local.csi.aliyun.com",
            "parameters": params, "reclaimPolicy": "Delete",
            "volumeBindingMode": "WaitForFirstConsumer"}


def _gpu_pod(idx: int, app: str, mem_mi: int, count: int, cpu_milli: int,
             mem_bytes: int) -> dict:
    pod = synth_pod(idx, cpu_milli=cpu_milli, mem_bytes=mem_bytes, labels={"app": app})
    pod["metadata"]["annotations"] = {_GPU_MEM: f"{mem_mi}Mi", _GPU_COUNT: str(count)}
    return pod


def synth_extended_cluster(
    n_nodes: int,
    n_pods: int,
    n_zones: int = 8,
) -> Tuple[List[dict], List[dict], List[dict], List[dict]]:
    """(nodes, pods, services, storage_classes): a GPU-share and Open-Local
    cluster in the shapes of the reference's examples, at the scale of a
    shared GPU fleet (Alibaba PAI's public cluster-trace-gpu-v2020: ~1,800
    GPU machines, many tasks asking for a fraction of one GPU's memory).

    Nodes cycle six shapes by index, zoned by i % n_zones: the two V100
    nodes of examples/cluster/gpushare (2 GPUs in 32560Mi, 4 in 64640Mi), an
    8-GPU node with the 4-GPU node's per-device memory, the storage node of
    examples/newnode/demo_1 (VG yoda-pool 500 GiB, one 100 GiB HDD), a
    variant of it with a second 200 GiB VG and two SSDs (200 and 400 GiB),
    and a CPU-only node.

    Pods come in replica blocks cycling seven shapes: (a) shared-GPU
    replicas asking for one GPU of 1024Mi-10240Mi (gpu-pod-00's request; the
    wave route with its GPU branch), (b) 2 x 10240Mi replicas (gpu-pod-02's
    request; the wave route, in-order units), (c) a short block with a
    pre-assigned gpu-index (the serial route), (d) one-GPU replicas with a
    zone DoNotSchedule spread (the serial route with the GPU branch), (e)
    StatefulSet pods with the LVM claims of
    examples/application/open_local/sts-nginx.yaml plus a 100 GiB one,
    alternating the unnamed (Binpack) class and the class naming yoda-pool,
    (f) pods with SSD and HDD device claims and (g) plain CPU pods. The GPU
    and storage demand exceeds the cluster, so part of (a), (b), (e) and (f)
    fails. The storage_classes list holds the classes the claims name."""
    zone = "topology.kubernetes.io/zone"
    storage_classes = [
        _storage_class("open-local-lvm", volumeType="LVM"),
        _storage_class("yoda-lvm-default", volumeType="LVM", vgName="yoda-pool"),
        _storage_class("open-local-device-hdd", volumeType="Device", mediaType="hdd"),
        _storage_class("open-local-device-ssd", volumeType="Device", mediaType="ssd"),
    ]
    gpu_shapes = {0: (2, "32560Mi"), 1: (4, "64640Mi"), 2: (8, "129280Mi")}
    nodes = []
    for i in range(n_nodes):
        kind = i % 6
        if kind in gpu_shapes:
            count, mem = gpu_shapes[kind]
            node = synth_node(i, cpu_milli=64000, mem_bytes=256000 << 20, pods=110,
                              n_zones=n_zones)
            node["metadata"]["labels"][_GPU_MODEL] = "V100"
            for key in ("allocatable", "capacity"):
                node["status"][key].update({_GPU_COUNT: str(count), _GPU_MEM: mem})
        elif kind in (3, 4):
            node = synth_node(i, cpu_milli=32000, mem_bytes=64 * _GIB, pods=110, n_zones=n_zones)
            vgs = [{"name": "yoda-pool", "capacity": str(500 * _GIB)}]
            devices = [{"name": "/dev/vdd", "device": "/dev/vdd", "capacity": str(100 * _GIB),
                        "mediaType": "hdd", "isAllocated": "false"}]
            if kind == 4:
                vgs.append({"name": "pool-b", "capacity": str(200 * _GIB)})
                devices += [{"name": f"/dev/nvme{k}n1", "device": f"/dev/nvme{k}n1",
                             "capacity": str(size * _GIB), "mediaType": "ssd",
                             "isAllocated": "false"} for k, size in ((0, 200), (1, 400))]
            node["metadata"]["annotations"] = {
                _NODE_STORAGE: json.dumps({"devices": devices, "vgs": vgs})}
        else:
            node = synth_node(i, pods=110, n_zones=n_zones)
        nodes.append(node)

    pods: List[dict] = []
    block = max(8, n_pods // 70)
    k = 0
    while len(pods) < n_pods:
        kind, cycle = k % 7, k // 7
        n = min(min(16, block) if kind == 2 else block, n_pods - len(pods))
        for r in range(n):
            idx = len(pods)
            if kind == 0:
                mem_mi = (1024, 2048, 4096, 8192, 10240)[cycle % 5]
                pod = _gpu_pod(idx, f"share-{k}", mem_mi, 1, 4000, 9216 << 20)
            elif kind == 1:
                pod = _gpu_pod(idx, f"dual-{k}", 10240, 2, 12000, 18432 << 20)
            elif kind == 2:
                pod = _gpu_pod(idx, f"pinned-{k}", 10240, 1, 4000, 9216 << 20)
                pod["metadata"]["annotations"][_GPU_INDEX] = "0"
            elif kind == 3:
                app = f"spread-{k}"
                pod = _gpu_pod(idx, app, 4096, 1, 4000, 9216 << 20)
                pod["spec"]["topologySpreadConstraints"] = [
                    _spread_term(app, zone, "DoNotSchedule", 1)]
            elif kind == 4:
                sc = "open-local-lvm" if cycle % 2 == 0 else "yoda-lvm-default"
                app = f"sts-{k}"
                pod = synth_pod(idx, cpu_milli=1000, mem_bytes=2 * _GIB, labels={"app": app})
                pod["metadata"]["name"] = f"{app}-{r}"
                pod["metadata"]["annotations"] = {_POD_STORAGE: json.dumps({"volumes": [
                    {"size": str(size * _GIB), "kind": "LVM", "scName": sc}
                    for size in (10, 40, 100)]})}
            elif kind == 5:
                hdd, ssd = "open-local-device-hdd", "open-local-device-ssd"
                vols = ([(150, "SSD", ssd), (80, "HDD", hdd)] if cycle % 2 == 0
                        else [(50, "HDD", hdd)])
                pod = synth_pod(idx, cpu_milli=2000, mem_bytes=4 * _GIB,
                                labels={"app": f"disk-{k}"})
                pod["metadata"]["annotations"] = {_POD_STORAGE: json.dumps({"volumes": [
                    {"size": str(size * _GIB), "kind": kd, "scName": sc}
                    for size, kd, sc in vols]})}
            else:
                pod = synth_pod(idx, cpu_milli=500, mem_bytes=1 * _GIB,
                                labels={"app": f"plain-{k}"})
            pods.append(pod)
        k += 1
    return nodes, pods, [], storage_classes


def synth_capacity_cluster(
    n_base: int = 512,
    n_pods: int = 20000,
    n_zones: int = 4,
) -> Tuple[List[dict], dict, List[dict], List[dict]]:
    """(base_nodes, template, pods, services): a capacity-planning input whose
    arithmetic lower bound is not exact, so the planner's search runs rounds
    of eight candidates through every segment kind of the router.

    n_base zoned `synth_node`s and the template `synth_node(0)` (zone 0, so
    every added node lands there); pods in replica blocks cycling five
    shapes: plain replicas (the wave route), replicas with required hostname
    self-anti-affinity (one per node: a cap-1 wave with hostname-keyed
    counters, which the lower bound does not see), a block of the
    Service-backed Deployment `svc-web` (live zoned SelectorSpread: the
    group-serial route), replicas with required zone self-affinity (the
    affinity wave), and a run of short alternating blocks below the router's
    WAVE_MIN (the serial scan). The services list holds the one Service."""
    zone = "topology.kubernetes.io/zone"
    base = [synth_node(i, n_zones=n_zones) for i in range(n_base)]
    template = synth_node(0, n_zones=n_zones)
    services = [{"apiVersion": "v1", "kind": "Service",
                 "metadata": {"name": "web", "namespace": "default"},
                 "spec": {"selector": {"app": "svc-web"}}}]
    pods: List[dict] = []
    block = max(16, n_pods // 20)
    k = 0
    while len(pods) < n_pods:
        n = min(block, n_pods - len(pods))
        kind = k % 5
        if kind == 4:  # short runs of two alternating shapes: serial chunks
            for r in range(n // 4):
                app = f"small-{k}-{r % 2}"
                for _ in range(4):
                    pods.append(synth_pod(len(pods), cpu_milli=300 + 200 * (r % 2),
                                          labels={"app": app}))
            k += 1
            continue
        for _ in range(n):
            idx = len(pods)
            if kind == 0:
                pod = synth_pod(idx, cpu_milli=1000, mem_bytes=2 << 30,
                                labels={"app": f"plain-{k}"})
            elif kind == 1:
                app = f"host-anti-{k}"
                pod = synth_pod(idx, cpu_milli=2000, labels={"app": app}, anti_affinity_on=app)
            elif kind == 2:
                pod = synth_pod(idx, cpu_milli=500, mem_bytes=1 << 30, labels={"app": "svc-web"})
            else:
                app = f"zone-aff-{k}"
                pod = synth_pod(idx, cpu_milli=1500, labels={"app": app})
                pod["spec"]["affinity"] = {"podAffinity": _required_term(app, zone)}
            pods.append(pod)
        k += 1
    return base, template, pods, services


# The capacity planner's scenarios: kind -> (generator call, MaxCPU percent).
# "capacity" is the repo's capacity row (bench.py bench_capacity_plan,
# config 5): 64 base nodes, 100,000 pods, a 60% MaxCPU envelope, whose
# arithmetic bound is exact; "capacity_lanes" is synth_capacity_cluster at a
# 90% envelope, whose bound is not.
CAPACITY_SCENARIOS = {
    "capacity": ("synth_node(i) x 64, template synth_node(0), synth_pod(i) x 100000", 60),
    "capacity_lanes": ("synth_capacity_cluster(512, 20000)", 90),
}


def capacity_scenario(kind: str):
    """(base_nodes, template, pods, services, MaxCPU) of a CAPACITY_SCENARIOS kind."""
    max_cpu = CAPACITY_SCENARIOS[kind][1]
    if kind == "capacity":
        return ([synth_node(i) for i in range(64)], synth_node(0),
                [synth_pod(i) for i in range(100000)], [], max_cpu)
    base, template, pods, services = synth_capacity_cluster(512, 20000)
    return base, template, pods, services, max_cpu
