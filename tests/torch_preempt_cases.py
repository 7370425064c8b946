"""The preemption cases of tests/test_torch_preemption.py (the port against
the JAX package on the CPU) and tests/test_torch_cuda.py (the port on the
card against the port on the CPU).

Imports no JAX (the card's host need not have it): the scenario functions
of tests/test_preemption.py, a GPU-share and an Open-Local eviction, and
`record`, the comparable record of one run (placements in node order, the
`preempted` records, the failures with their reasons, every pod's final
nodeName, nominatedNodeName and annotations, the node annotations and the
preemption counters' deltas).
"""

import copy

from fixtures import make_node, make_pod

COUNTERS = ("simon_preemption_attempts_total", "simon_preemption_victims_total",
            "simon_preemption_replay_pods_total", "simon_commit_rollbacks_total",
            "simon_commits_total")


def prio_pod(name, priority, cpu="1", **kw):
    p = make_pod(name, cpu=cpu, **kw)
    p["spec"]["priority"] = priority
    return p


def pdb(app, allowed):
    return {"kind": "PodDisruptionBudget",
            "metadata": {"name": f"{app}-pdb", "namespace": "default"},
            "spec": {"selector": {"matchLabels": {"app": app}}},
            "status": {"disruptionsAllowed": allowed}}


def _name(p):
    return p["metadata"]["name"]


def _deltas(before, after):
    keys = {k for k in after if k.split("{")[0] in COUNTERS}
    return {k: after[k] - before.get(k, 0) for k in sorted(keys) if after[k] != before.get(k, 0)}


def record(sim, calls, failed, before, after) -> dict:
    """The comparable record of one run of `calls` (registry views
    `before` and `after` it)."""
    return {
        "placements": [[_name(p) for p in sim.pods_on_node[i]] for i in range(sim.na.N)],
        "preempted": [(_name(r["pod"]), r["node"], r["by"]) for r in sim.preempted],
        "failed": [(_name(u.pod), u.reason) for u in failed],
        "pods": [(_name(p), (p.get("spec") or {}).get("nodeName"),
                  (p.get("status") or {}).get("nominatedNodeName"),
                  dict((p.get("metadata") or {}).get("annotations") or {}))
                 for call in calls for p in call],
        "node_annotations": [dict(n["metadata"].get("annotations") or {})
                             for n in sim.na.nodes],
        "counters": _deltas(before, after),
        "armed": sim._preempt_armed,
    }


def run_port(device, nodes, calls, pdbs=(), sched_config=None, use_waves=True,
             storage_classes=()):
    """`calls` through the port's Simulator on `device`: (record, sim)."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.obs import REGISTRY
    from open_simulator_torch.simulator.engine import Simulator

    nodes, calls = copy.deepcopy(nodes), copy.deepcopy(calls)
    sim = Simulator(nodes, device=device, sched_config=sched_config)
    sim.use_waves = use_waves
    sim.register_cluster_objects(ResourceTypes(
        pod_disruption_budgets=copy.deepcopy(list(pdbs)),
        storage_classes=copy.deepcopy(list(storage_classes))))
    v0 = REGISTRY.values()
    failed = []
    for call in calls:
        failed.extend(sim.schedule_pods(call))
    return record(sim, calls, failed, v0, REGISTRY.values()), sim


# ------------------------------------------------ tests/test_preemption.py ----


def _basic():
    return [make_node("n0", cpu="4")], [[prio_pod(f"low{i}", 0) for i in range(4)]
                                        + [prio_pod("high", 100, cpu="2")]], {}


def _freed_capacity():
    return [make_node("n0", cpu="4")], [[prio_pod(f"low{i}", 0) for i in range(4)]
                                        + [prio_pod("high", 100, cpu="4"),
                                           prio_pod("med", 50, cpu="2")]], {}


def _interleaves():
    nodes = [make_node("n0", cpu="8"), make_node("n1", cpu="8")]
    lows = [prio_pod(f"low{i}", 0, labels={"app": "low"}) for i in range(16)]
    highs = [prio_pod(f"high{i}", 100, labels={"app": "high"}) for i in range(4)]
    return nodes, [lows + highs], {}


def _never_policy():
    high = prio_pod("high", 100, cpu="2")
    high["spec"]["preemptionPolicy"] = "Never"
    return [make_node("n0", cpu="4")], [[prio_pod(f"low{i}", 0) for i in range(4)] + [high]], {}


def _unresolvable_nodes():
    tainted = make_node("nA", cpu="8", taints=[
        {"key": "dedicated", "value": "infra", "effect": "NoSchedule"}])
    return ([tainted, make_node("nB", cpu="1")],
            [[prio_pod("low0", 0, cpu="1"), prio_pod("high", 100, cpu="1")]], {})


def _no_candidates():
    nodes = [make_node("n0", cpu="1", labels={"disk": "hdd"})]
    high = prio_pod("high", 100, cpu="1", node_selector={"disk": "ssd"})
    return nodes, [[prio_pod("low0", 0, cpu="1"), high]], {}


def _lowest_priority_victims():
    return [make_node("n0", cpu="3")], [[prio_pod("a", 5), prio_pod("b", 1), prio_pod("c", 3),
                                         prio_pod("high", 100, cpu="1")]], {}


def _min_highest_victim():
    nodes = [make_node("nA", cpu="1"), make_node("nB", cpu="1")]
    return nodes, [[prio_pod("va", 10, node_name="nA"), prio_pod("vb", 5, node_name="nB"),
                    prio_pod("high", 100, cpu="1")]], {}


def _pdb_reprieved_first():
    pods = [prio_pod("covered", 0, labels={"app": "db"}), prio_pod("free", 0, labels={"app": "web"}),
            prio_pod("high", 100, cpu="1")]
    return [make_node("n0", cpu="2")], [pods], {"pdbs": [pdb("db", 0)]}


def _prefers_no_pdb_violations():
    nodes = [make_node("nA", cpu="1"), make_node("nB", cpu="1")]
    pods = [prio_pod("va", 0, node_name="nA", labels={"app": "db"}),
            prio_pod("vb", 0, node_name="nB", labels={"app": "web"}),
            prio_pod("high", 100, cpu="1")]
    return nodes, [pods], {"pdbs": [pdb("db", 0)]}


def _across_calls():
    return [make_node("n0", cpu="2")], [[prio_pod(f"low{i}", 0) for i in range(2)],
                                        [prio_pod("high", 100, cpu="2")]], {}


SCHED_NO_PREEMPTION = ("apiVersion: kubescheduler.config.k8s.io/v1beta1\n"
                       "kind: KubeSchedulerConfiguration\n"
                       "profiles:\n"
                       "- schedulerName: default-scheduler\n"
                       "  plugins:\n"
                       "    postFilter:\n"
                       "      disabled:\n"
                       "      - name: DefaultPreemption\n")


def _disabled_by_config():
    return ([make_node("n0", cpu="2")],
            [[prio_pod(f"low{i}", 0) for i in range(2)] + [prio_pod("high", 100, cpu="1")]],
            {"sched_yaml": SCHED_NO_PREEMPTION})


def _no_lower_priority():
    return [make_node("n0", cpu="2")], [[prio_pod("high0", 100), prio_pod("high1", 100),
                                         prio_pod("low", 0, cpu="2")]], {}


def _anti_affinity_resolvable():
    blocker = prio_pod("blocker", 0, labels={"app": "solo"})
    blocker["spec"]["affinity"] = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": "kubernetes.io/hostname",
            "labelSelector": {"matchLabels": {"app": "web"}},
        }]}}
    return [make_node("n0", cpu="8")], [[blocker, prio_pod("high", 100, labels={"app": "web"})]], {}


def _same_spec_higher_priority():
    pods = [prio_pod("tiny", 0, cpu="1"), prio_pod("mid", 50, cpu="3"),
            prio_pod("atk-low", 10, cpu="2", labels={"app": "atk"}),
            prio_pod("atk-high", 100, cpu="2", labels={"app": "atk"})]
    return [make_node("n0", cpu="4")], [pods], {}


# name -> (make, victims expected, nominations expected)
SCENARIOS = {
    "basic": (_basic, 2, 1),
    "freed_capacity": (_freed_capacity, 4, 1),
    "interleaves": (_interleaves, 2, 2),
    "never_policy": (_never_policy, 0, 0),
    "unresolvable_nodes": (_unresolvable_nodes, 1, 1),
    "no_candidates": (_no_candidates, 0, 0),
    "lowest_priority_victims": (_lowest_priority_victims, 1, 1),
    "min_highest_victim": (_min_highest_victim, 1, 1),
    "pdb_reprieved_first": (_pdb_reprieved_first, 1, 1),
    "prefers_no_pdb_violations": (_prefers_no_pdb_violations, 1, 1),
    "across_calls": (_across_calls, 2, 1),
    "disabled_by_config": (_disabled_by_config, 0, 0),
    "no_lower_priority": (_no_lower_priority, 0, 0),
    "anti_affinity_resolvable": (_anti_affinity_resolvable, 1, 1),
    "same_spec_higher_priority": (_same_spec_higher_priority, 1, 1),
}




# ------------------------------------------------ the host ledgers ----

GI = 1 << 30


def gpu_node(name, count=1, total_mem=16 * GI, cpu="4", mem="256Gi"):
    """tests/test_gpushare.py's GPU node."""
    return make_node(name, cpu=cpu, memory=mem,
                     labels={"alibabacloud.com/gpu-card-model": "V100"},
                     extra_resources={"alibabacloud.com/gpu-count": str(count),
                                      "alibabacloud.com/gpu-mem": str(total_mem)})


def gpu_pod(name, mem_gi, priority, cpu="2"):
    pod = make_pod(name, cpu=cpu, memory="1Gi")
    pod["metadata"]["annotations"] = {"alibabacloud.com/gpu-mem": f"{mem_gi}Gi",
                                      "alibabacloud.com/gpu-count": "1"}
    pod["spec"]["priority"] = priority
    return pod


def storage_node(name, vg_bytes, cpu="2"):
    """tests/test_openlocal.py's storage node with one volume group."""
    from open_simulator_torch.utils.storage import VG, NodeStorage

    st = NodeStorage(vgs=[VG("pool", vg_bytes)], devices=[])
    return make_node(name, cpu=cpu, memory="64Gi",
                     annotations={"simon/node-local-storage": st.to_json()})


def storage_pod(name, lvm_bytes, priority):
    import json

    pod = make_pod(name, cpu="1", memory="1Gi")
    pod["metadata"]["annotations"] = {"simon/pod-local-storage": json.dumps(
        {"volumes": [{"size": str(lvm_bytes), "kind": "LVM", "scName": "open-local-lvm"}]})}
    pod["spec"]["priority"] = priority
    return pod


LVM_SC = {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
          "metadata": {"name": "open-local-lvm"}, "provisioner": "local.csi.aliyun.com",
          "parameters": {"volumeType": "LVM"}}


def _gpushare():
    """A GPU pod short of CPU preempts a GPU pod (the dry run keeps the GPU
    ledger, so the shortage must be elsewhere); the next pod takes the
    freed device share."""
    pods = ([gpu_pod(f"low{i}", 4, 0) for i in range(2)]
            + [gpu_pod(n, 4, 100) for n in ("hi", "after")])
    return [gpu_node("g0")], [pods], {}


def _openlocal():
    """A storage pod short of CPU preempts an LVM pod; the next pod takes
    the freed volume-group space."""
    pods = ([storage_pod(f"low{i}", 8 * GI, 0) for i in range(2)]
            + [storage_pod(n, 8 * GI, 100) for n in ("hi", "after")])
    return [storage_node("s0", 32 * GI)], [pods], {"storage_classes": [LVM_SC]}


def _armed_with_room():
    """tests/test_simulate.py: mixed priorities arm the PostFilter; with room
    to spare it changes nothing."""
    pods = [make_pod(f"p{i}", cpu="100m", memory="128Mi") for i in range(3)]
    pods[0]["spec"]["priority"] = 1000
    pods[1]["spec"]["priority"] = 0
    return [make_node("n0")], [pods], {}


def _reconcile():
    """tests/test_obs.py: commits - rollbacks - victims = the pods live."""
    pods = [prio_pod(f"low{i}", 0, memory="128Mi") for i in range(4)]
    pods.append(prio_pod("high", 100, cpu="2", memory="128Mi"))
    return [make_node("n0", cpu="4")], [pods], {}


# name -> (make, victims expected, nominations expected)
EXTRA_CASES = {
    "gpushare": (_gpushare, 1, 1),
    "openlocal": (_openlocal, 1, 1),
    "armed_with_room": (_armed_with_room, 0, 0),
    "reconcile": (_reconcile, 2, 1),
}


def preempt_cut(n_nodes: int = 64):
    """(nodes, calls, kw) of tests/test_torch_golden.py preempt_workload,
    cut to n_nodes."""
    from test_torch_golden import preempt_workload

    nodes, calls, pdbs = preempt_workload(n_nodes)
    return nodes, calls, {"pdbs": pdbs}
