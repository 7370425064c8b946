"""Goldens for the PyTorch port's chip check, computed by the JAX package.

`chip_smoke.py` runs the port on the GPU for synthetic clusters and holds its
result against `tests/golden/torch_port_*.json`: the sha256 of the per-pod
choices, the per-node pod counts and the census of failure reasons. Those
files come from the JAX package on one CPU device, through `compute()` below,
on the route each file names: the serial route (`use_waves=False`) for
"hard" and "overflow", the default route (the segment router) for the rest:

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write

The slow test recomputes the goldens through JAX; the tier-1 tests hold the
two packages to one result on small clusters of the same kinds.

The capacity planner's goldens come the same way: `capacity` and
`capacity_lanes` (utils/synth.py CAPACITY_SCENARIOS) hold the JAX
`CapacityPlanner.search()` result (found, nodes_added, hist, stats without
the encode wall) and every probe round's candidates with their (scheduled,
total, utilization), captured by wrapping the JAX `ProbeSession.probe_many`;
`apply_smoke`, `apply_gpushare` and `apply_demo1` (APPLY_SCENARIOS) hold the
JAX `Applier.run()` on the repo's example configs: nodes added and the
report with its fake-node names normalized (parity.normalize_report):

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write capacity capacity_lanes

The flight recorder's goldens, `xray_hard_waves` and `xray_extended`, hold
the JAX package's trace of the `hard_waves` and `extended` runs recorded
with `--xray` (open_simulator_torch/parity.py `xray_trace_digest`: the set
count, one sha256 per decision set over its arrays, the set records' and
the pod rows' digests) and the placements of the same run with recording
off:

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write xray_hard_waves xray_extended

`preempt` holds the JAX package's run of chip_smoke.py's preemption
workload (`preempt_workload(1000)`: three calls of rising priority on
`synth_cluster(1000, ·, hard_predicates=True)`'s nodes, a PDB on one
batch app, the third call's pods preempting): summarize()'s digest over
all three calls, a sha256 over the `preempted` records in order, the
nominatedNodeName of every failed pod, the preemption counters' deltas
and the checks the workload was sized to pass. `sched_hard_waves` holds
`hard_waves` under the KubeSchedulerConfiguration in
tests/golden/torch_port_sched_hard_waves.sched.yaml (custom score weights,
a kernel filter and an encoder filter disabled):

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write preempt sched_hard_waves
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
# kind -> (generator, nodes, pods, serial route?)
SCENARIOS = {
    # BASELINE.md's hard-predicate stress configuration
    "hard": ("hard", 5000, 50000, True),
    # 100 nodes x 256 pod slots cannot hold 30,000 pods: exercises the reasons
    "overflow": ("hard", 100, 30000, True),
    # the same two on the default route: wave and affinity segments
    "hard_waves": ("hard", 5000, 50000, False),
    "overflow_waves": ("hard", 100, 30000, False),
    # bench.py's headline shape: one 100,000-pod wave over 10,000 nodes
    "northstar": ("plain", 10000, 100000, False),
    # zoned pods spreading against themselves: the group-serial route
    "spread": ("spread", 5000, 20000, False),
    # pods constraining themselves (self-affinity, self-anti-affinity,
    # DoNotSchedule spread, live SelectorSpread): the affinity-wave route
    "affinity": ("affinity", 5000, 20000, False),
    # GPU-share and Open-Local demand: shared-GPU waves with the GPU branch,
    # the rest on the serial route with both branches
    "extended": ("extended", 2000, 20000, False),
    # the same on the serial route: every GPU pod through K2's allocator
    "extended_serial": ("extended", 2000, 20000, True),
}
ROUTES = {True: "open_simulator_tpu Simulator, use_waves=False, one CPU device",
          False: "open_simulator_tpu Simulator, default route (use_waves=True), one CPU device"}


# kind -> (simon config, MaxCPU percent or None, --extended-resources)
APPLY_SCENARIOS = {
    "apply_smoke": ("examples/simon-smoke-config.yaml", 40, ()),
    "apply_gpushare": ("examples/simon-gpushare-config.yaml", None, ("gpu",)),
    "apply_demo1": ("examples/simon-config.yaml", None, ("open-local", "gpu")),
}
# kind -> the SCENARIOS kind recorded with the flight recorder on
XRAY_SCENARIOS = {"xray_hard_waves": "hard_waves", "xray_extended": "extended"}
# the KubeSchedulerConfiguration of the sched_hard_waves golden
SCHED_HARD_WAVES = "tests/golden/torch_port_sched_hard_waves.sched.yaml"
ALL_KINDS = (sorted(SCENARIOS) + ["capacity", "capacity_lanes"] + sorted(APPLY_SCENARIOS)
             + sorted(XRAY_SCENARIOS) + ["preempt", "sched_hard_waves"])


def golden_path(kind: str) -> str:
    return os.path.join(GOLDEN_DIR, f"torch_port_{kind}.json")


def summarize(sim, pods, failed) -> dict:
    """Digest of one scheduling run: choices (node index per pod, -1 when
    unschedulable, i32 little-endian) hashed, per-node counts, reason census
    (the FitError detail after the pod name)."""
    choices = np.array([sim.na.index.get((p.get("spec") or {}).get("nodeName"), -1)
                        for p in pods], dtype="<i4")
    counts = np.bincount(choices[choices >= 0], minlength=sim.na.N)
    census = Counter(u.reason.split("): ", 1)[1] for u in failed)
    return {
        "choices_sha256": hashlib.sha256(choices.tobytes()).hexdigest(),
        "per_node_counts": counts.tolist(),
        "placed": int((choices >= 0).sum()),
        "unscheduled": len(failed),
        "reason_census": dict(sorted(census.items())),
    }


PORT_GENERATORS = ("spread", "affinity", "extended")


def generator(gen: str, n_nodes: int, n_pods: int) -> str:
    if gen in PORT_GENERATORS:
        return f"synth_{gen}_cluster({n_nodes}, {n_pods})"
    hard = ", hard_predicates=True" if gen == "hard" else ""
    return f"synth_cluster({n_nodes}, {n_pods}{hard})"


def workload(gen: str, n_nodes: int, n_pods: int, synth) -> tuple:
    """(nodes, pods, services, storage_classes) from `synth` (a utils.synth
    module of either package: their synth_cluster is one function); the
    spread, affinity and extended workloads come from the port's own
    generators, which import no JAX."""
    if gen in PORT_GENERATORS:
        from open_simulator_torch.utils import synth as port_synth

        out = getattr(port_synth, f"synth_{gen}_cluster")(n_nodes, n_pods)
        return out if len(out) == 4 else (*out, [])
    nodes, pods = synth.synth_cluster(n_nodes, n_pods, hard_predicates=gen == "hard")
    return nodes, pods, [], []


def run_jax(gen: str, n_nodes: int, n_pods: int, serial: bool, sched_config=None) -> dict:
    from open_simulator_tpu.core.types import ResourceTypes
    from open_simulator_tpu.simulator.engine import Simulator
    from open_simulator_tpu.utils import synth

    nodes, pods, services, scs = workload(gen, n_nodes, n_pods, synth)
    sim = Simulator(nodes, use_mesh=False, sched_config=sched_config)
    sim.use_waves = not serial
    sim.register_cluster_objects(ResourceTypes(services=services, storage_classes=scs))
    failed = sim.schedule_pods(pods)
    return summarize(sim, pods, failed)


def run_port(gen: str, n_nodes: int, n_pods: int, serial: bool, device: str = "cpu",
             sched_config=None) -> dict:
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils import synth

    nodes, pods, services, scs = workload(gen, n_nodes, n_pods, synth)
    sim = Simulator(nodes, device=device, sched_config=sched_config)
    sim.use_waves = not serial
    sim.register_cluster_objects(ResourceTypes(services=services, storage_classes=scs))
    failed = sim.schedule_pods(pods)
    return summarize(sim, pods, failed)


# ---- chip_smoke.py's preemption workload (chip_smoke.py keeps a copy) ----

PREEMPT_NODES = 1000
PREEMPT_BATCH = (7000, 24)   # (cpu milli, memory GiB) of every call-1 / call-2 pod
PREEMPT_PROD = (20000, 48)   # the same of every call-3 pod
PREEMPT_COUNTERS = ("simon_preemption_attempts_total", "simon_preemption_victims_total",
                    "simon_preemption_replay_pods_total", "simon_commit_rollbacks_total")


def preempt_pod(name: str, priority: int, cpu_milli: int, mem_gi: int, app: str,
                tolerate: bool = False, spread: bool = False, never: bool = False) -> dict:
    spec = {"priority": priority,
            "containers": [{"name": "app", "image": "nginx:1.25", "resources": {
                "requests": {"cpu": f"{cpu_milli}m", "memory": str(mem_gi << 30)}}}]}
    if tolerate:
        spec["tolerations"] = [{"key": "synth/dedicated", "operator": "Equal",
                                "value": "batch", "effect": "NoSchedule"}]
    if spread:
        spec["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": app}}}]
    if never:
        spec["preemptionPolicy"] = "Never"
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default", "labels": {"app": app}},
            "spec": spec}


def preempt_workload(n_nodes: int = PREEMPT_NODES) -> tuple:
    """(nodes, calls, pdbs): the nodes of synth_cluster(n_nodes, 0,
    hard_predicates=True) (8 zones, every 10th node tainted); call 1 at
    priority 0: n_nodes `batch-a` pods and n_nodes `batch-b` pods that
    tolerate the taint, under a PDB allowing 2 disruptions; call 2 at
    priority 100: n_nodes `svc-c` pods; call 3 at priority 1000: four specs
    of max(2, n_nodes // 100) pods (`prod-x` plain, `prod-y` with a zone
    DoNotSchedule spread of maxSkew 1, `prod-z` tolerating the taint,
    `prod-n` with preemptionPolicy Never)."""
    from open_simulator_torch.utils.synth import synth_cluster

    nodes, _ = synth_cluster(n_nodes, 0, hard_predicates=True)
    bc, bm = PREEMPT_BATCH
    pc, pm = PREEMPT_PROD
    call1 = ([preempt_pod(f"batch-a-{i:05d}", 0, bc, bm, "batch-a") for i in range(n_nodes)]
             + [preempt_pod(f"batch-b-{i:05d}", 0, bc, bm, "batch-b", tolerate=True)
                for i in range(n_nodes)])
    call2 = [preempt_pod(f"svc-c-{i:05d}", 100, bc, bm, "svc-c") for i in range(n_nodes)]
    k = max(2, n_nodes // 100)
    call3 = [preempt_pod(f"{app}-{i:03d}", 1000, pc, pm, app, **kw)
             for app, kw in (("prod-x", {}), ("prod-y", {"spread": True}),
                             ("prod-z", {"tolerate": True}), ("prod-n", {"never": True}))
             for i in range(k)]
    pdb = {"apiVersion": "policy/v1beta1", "kind": "PodDisruptionBudget",
           "metadata": {"name": "batch-b", "namespace": "default"},
           "spec": {"selector": {"matchLabels": {"app": "batch-b"}}},
           "status": {"disruptionsAllowed": 2}}
    return nodes, [call1, call2, call3], [pdb]


def preempt_digest(sim, calls, failed) -> dict:
    """summarize() over every call's pods, the `preempted` records' sha256
    (victim, node, preemptor, in order) and every failed pod's
    nominatedNodeName."""
    pods = [p for call in calls for p in call]
    rows = [[r["pod"]["metadata"]["name"], r["node"], r["by"]] for r in sim.preempted]
    return {**summarize(sim, pods, failed),
            "preempted": len(rows),
            "preempted_sha256": hashlib.sha256(json.dumps(rows).encode()).hexdigest(),
            "nominations": [[u.pod["metadata"]["name"],
                             (u.pod.get("status") or {}).get("nominatedNodeName")]
                            for u in failed]}


def counter_deltas(before: dict, after: dict) -> dict:
    """The PREEMPT_COUNTERS samples that moved between two registry views."""
    return {k: after[k] - before.get(k, 0) for k in sorted(after)
            if k.split("{")[0] in PREEMPT_COUNTERS and after[k] != before.get(k, 0)}


def preempt_run(pkg: str, n_nodes: int = PREEMPT_NODES, use_waves: bool = True,
                device: str = "cpu", spy=None) -> dict:
    """preempt_workload(n_nodes) through package `pkg`'s Simulator, one
    schedule_pods call a tier: preempt_digest plus the counter deltas.
    `spy(sim)`, if given, runs before the first call."""
    import importlib

    E = importlib.import_module(f"{pkg}.simulator.engine")
    T = importlib.import_module(f"{pkg}.core.types")
    reg = importlib.import_module(f"{pkg}.obs").REGISTRY
    nodes, calls, pdbs = preempt_workload(n_nodes)
    sim = (E.Simulator(nodes, use_mesh=False) if pkg == "open_simulator_tpu"
           else E.Simulator(nodes, device=device))
    sim.use_waves = use_waves
    sim.register_cluster_objects(T.ResourceTypes(pod_disruption_budgets=pdbs))
    if spy is not None:
        spy(sim)
    v0 = reg.values()
    failed = []
    for call in calls:
        failed.extend(sim.schedule_pods(call))
    return {**preempt_digest(sim, calls, failed), "counters": counter_deltas(v0, reg.values())}


def preempt_checks(n_nodes: int = PREEMPT_NODES) -> dict:
    """What the workload is sized to exercise, read from the JAX package's
    PostFilter: the preemptors nominated, whether a candidate node held pods
    of both lower tiers (the reprieve order), whether a candidate's victims
    matched the PDB, and how many prod-n pods failed with no attempt and no
    nomination."""
    from open_simulator_tpu.simulator import preemption as P

    seen = {"tiers": False, "pdb": False}
    orig = P._select_victims_on_node

    def spy(sim, g, node_i, prio):
        out = orig(sim, g, node_i, prio)
        if out is not None:
            tiers = {P.pod_priority(p) for p in sim.pods_on_node[node_i]}
            seen["tiers"] |= {0, 100} <= tiers
            seen["pdb"] |= any(v["metadata"]["labels"]["app"] == "batch-b"
                               for v in out["victims"])
        return out

    P._select_victims_on_node = spy
    try:
        got = preempt_run("open_simulator_tpu", n_nodes)
    finally:
        P._select_victims_on_node = orig
    noms = dict((n, v) for n, v in got["nominations"])
    return {"nominated": sum(1 for v in noms.values() if v),
            "candidate_with_both_lower_tiers": seen["tiers"],
            "candidate_victims_under_the_pdb": seen["pdb"],
            "prod_n_failed_without_nomination": sum(
                1 for n, v in noms.items() if n.startswith("prod-n") and v is None),
            "got": got}


def sched_config_of(pkg: str):
    import importlib

    parse = importlib.import_module(f"{pkg}.api.schedconfig").parse_scheduler_config
    return parse(os.path.join(REPO, SCHED_HARD_WAVES))


class _env:
    """Set MaxCPU (None: unset) for the duration of a block."""

    def __init__(self, max_cpu):
        self.max_cpu = max_cpu

    def __enter__(self):
        self.prev = os.environ.pop("MaxCPU", None)
        if self.max_cpu is not None:
            os.environ["MaxCPU"] = str(self.max_cpu)

    def __exit__(self, *exc):
        os.environ.pop("MaxCPU", None)
        if self.prev is not None:
            os.environ["MaxCPU"] = self.prev


def capacity_search(pkg: str, kind: str, device: str = "cpu") -> dict:
    """CapacityPlanner.search() of package `pkg` ("open_simulator_tpu" or
    "open_simulator_torch") on a CAPACITY_SCENARIOS kind, with every probe
    round of its session recorded."""
    import importlib

    from open_simulator_torch.utils.synth import capacity_scenario

    A = importlib.import_module(f"{pkg}.apply.applier")
    PR = importlib.import_module(f"{pkg}.simulator.probe")
    T = importlib.import_module(f"{pkg}.core.types")
    base, template, pods, services, max_cpu = capacity_scenario(kind)
    rounds = []
    orig = PR.ProbeSession.probe_many

    def probe_many(self, ns):
        res = orig(self, ns)
        rounds.append({"candidates": list(ns),
                       "results": {str(n): [res[n][0], res[n][1], res[n][2]] for n in ns}})
        return res

    kw = {"device": device} if pkg == "open_simulator_torch" else {}
    PR.ProbeSession.probe_many = probe_many
    try:
        with _env(max_cpu):
            planner = A.CapacityPlanner(base, template, pods,
                                        cluster_objects=T.ResourceTypes(services=services), **kw)
            found, n, hist = planner.search()
    finally:
        PR.ProbeSession.probe_many = orig
    stats = {k: planner.stats[k] for k in ("path", "probes", "dispatches", "encodes")}
    return {"found": found, "nodes_added": n, "hist": [list(h) for h in hist],
            "stats": stats, "rounds": rounds}


def apply_run(pkg: str, kind: str, device: str = "cpu") -> dict:
    """Applier.run() of package `pkg` on an APPLY_SCENARIOS config, from the
    repo root, pod names restarted: nodes added and the normalized report."""
    import importlib
    import io

    from open_simulator_torch.parity import normalize_report

    config, max_cpu, ext = APPLY_SCENARIOS[kind]
    A = importlib.import_module(f"{pkg}.apply.applier")
    importlib.import_module(f"{pkg}.models.workloads").reset_name_counter()
    kw = {"device": device} if pkg == "open_simulator_torch" else {}
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with _env(max_cpu):
            applier = A.Applier(A.Options(simon_config=config, extended_resources=list(ext),
                                          **kw))
            applier.out = io.StringIO()
            result = applier.run()
    finally:
        os.chdir(cwd)
    added = sum(1 for ns in result.node_status
                if "simon/new-node" in (ns.node["metadata"].get("labels") or {}))
    return {"nodes_added": added, "unscheduled": len(result.unscheduled_pods),
            "report": normalize_report(applier.out.getvalue())}


def xray_run(pkg: str, kind: str, prefix: str, device: str = "cpu") -> dict:
    """The XRAY_SCENARIOS run of package `pkg` recorded to `prefix`:
    {"choices_sha256": placements, **xray_trace_digest(prefix)}."""
    import importlib

    from open_simulator_torch.parity import xray_trace_digest

    gen, n_nodes, n_pods, serial = SCENARIOS[XRAY_SCENARIOS[kind]]
    xray = importlib.import_module(f"{pkg}.obs.xray")
    run = run_jax if pkg == "open_simulator_tpu" else run_port
    kw = {} if pkg == "open_simulator_tpu" else {"device": device}
    xray.enable(prefix)
    try:
        got = run(gen, n_nodes, n_pods, serial, **kw)
    finally:
        xray.disable()
    return {"choices_sha256": got["choices_sha256"], **xray_trace_digest(prefix)}


def compute(kind: str) -> dict:
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                                text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    if kind in ("capacity", "capacity_lanes"):
        from open_simulator_torch.utils.synth import CAPACITY_SCENARIOS

        gen, max_cpu = CAPACITY_SCENARIOS[kind]
        return {"generator": gen, "max_cpu": max_cpu,
                "route": "open_simulator_tpu CapacityPlanner.search(), one CPU device",
                "commit": commit, **capacity_search("open_simulator_tpu", kind)}
    if kind in XRAY_SCENARIOS:
        import tempfile

        gen, n_nodes, n_pods, serial = SCENARIOS[XRAY_SCENARIOS[kind]]
        off = run_jax(gen, n_nodes, n_pods, serial)
        with tempfile.TemporaryDirectory() as d:
            on = xray_run("open_simulator_tpu", kind, os.path.join(d, "trace"))
        if on["choices_sha256"] != off["choices_sha256"]:
            raise AssertionError(f"{kind}: recording changed the JAX placements")
        return {"generator": generator(gen, n_nodes, n_pods), "route": ROUTES[serial] + ", --xray",
                "commit": commit, "recording_off_choices_sha256": off["choices_sha256"],
                **{k: v for k, v in on.items() if k != "choices_sha256"}}
    if kind == "preempt":
        checks = preempt_checks()
        got = checks.pop("got")
        return {"generator": f"tests/test_torch_golden.py preempt_workload({PREEMPT_NODES})",
                "route": ROUTES[False] + ", three schedule_pods calls", "commit": commit,
                "checks": checks, **got}
    if kind == "sched_hard_waves":
        gen, n_nodes, n_pods, serial = SCENARIOS["hard_waves"]
        return {"generator": generator(gen, n_nodes, n_pods),
                "route": ROUTES[serial] + ", sched_config " + SCHED_HARD_WAVES,
                "commit": commit,
                **run_jax(gen, n_nodes, n_pods, serial,
                          sched_config=sched_config_of("open_simulator_tpu"))}
    if kind in APPLY_SCENARIOS:
        config, max_cpu, ext = APPLY_SCENARIOS[kind]
        return {"config": config, "max_cpu": max_cpu, "extended_resources": list(ext),
                "route": "open_simulator_tpu Applier.run(), one CPU device", "commit": commit,
                **apply_run("open_simulator_tpu", kind)}
    gen, n_nodes, n_pods, serial = SCENARIOS[kind]
    return {
        "generator": generator(gen, n_nodes, n_pods),
        "route": ROUTES[serial],
        "commit": commit,
        **run_jax(gen, n_nodes, n_pods, serial),
    }


def load(kind: str) -> dict:
    with open(golden_path(kind)) as f:
        return json.load(f)


RESULT_KEYS = ("choices_sha256", "per_node_counts", "placed", "unscheduled", "reason_census")


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_goldens_match_jax(kind):
    got = compute(kind)
    want = load(kind)
    for k in RESULT_KEYS:
        assert got[k] == want[k], k


@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_golden_files_are_consistent(kind):
    g = load(kind)
    gen, n_nodes, n_pods, serial = SCENARIOS[kind]
    assert g["generator"] == generator(gen, n_nodes, n_pods)
    assert g["route"] == ROUTES[serial]
    assert len(g["per_node_counts"]) == n_nodes
    assert sum(g["per_node_counts"]) == g["placed"]
    assert g["placed"] + g["unscheduled"] == n_pods
    assert sum(g["reason_census"].values()) == g["unscheduled"]


PLANNER_KINDS = ["capacity", "capacity_lanes", *sorted(APPLY_SCENARIOS)]


@pytest.mark.slow
@pytest.mark.parametrize("kind", PLANNER_KINDS)
def test_planner_goldens_match_jax(kind):
    got = json.loads(json.dumps(compute(kind)))
    want = load(kind)
    assert {k: v for k, v in got.items() if k != "commit"} == {
        k: v for k, v in want.items() if k != "commit"}


@pytest.mark.parametrize("kind", PLANNER_KINDS)
def test_planner_golden_files_are_consistent(kind):
    g = load(kind)
    if kind in APPLY_SCENARIOS:
        assert g["config"] == APPLY_SCENARIOS[kind][0]
        assert g["report"].startswith("Simulation success!")
        if g["nodes_added"]:
            assert f"(added {g['nodes_added']} node(s)" in g["report"]
        return
    from open_simulator_torch.utils.synth import CAPACITY_SCENARIOS

    assert (g["generator"], g["max_cpu"]) == CAPACITY_SCENARIOS[kind]
    assert g["found"] and g["stats"]["path"] == "incremental" and g["stats"]["encodes"] == 1
    assert g["stats"]["dispatches"] == len(g["rounds"])
    assert g["stats"]["probes"] == sum(len(set(r["candidates"])) for r in g["rounds"])
    verdicts = {int(n): v for r in g["rounds"] for n, v in r["results"].items()}
    n = g["nodes_added"]
    assert verdicts[n][0] == verdicts[n][1]  # everything schedules at the answer
    assert [list(h) for h in g["hist"]] == [[m, verdicts[m][1] - verdicts[m][0]]
                                           for m, _ in g["hist"]]


XRAY_KEYS = ("sets", "empty_sets", "pods", "unscheduled_rows", "set_sha256",
             "set_records_sha256", "pod_rows_sha256")


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(XRAY_SCENARIOS))
def test_xray_goldens_match_jax(kind):
    got = compute(kind)
    want = load(kind)
    for k in XRAY_KEYS + ("recording_off_choices_sha256",):
        assert got[k] == want[k], k


@pytest.mark.parametrize("kind", sorted(XRAY_SCENARIOS))
def test_xray_golden_files_are_consistent(kind):
    g = load(kind)
    base = SCENARIOS[XRAY_SCENARIOS[kind]]
    assert g["generator"] == generator(*base[:3])
    assert g["route"] == ROUTES[base[3]] + ", --xray"
    # recording observes only: the placements are the unrecorded golden's
    assert g["recording_off_choices_sha256"] == load(XRAY_SCENARIOS[kind])["choices_sha256"]
    assert g["sets"] == len(g["set_sha256"]) and 0 < g["sets"]
    assert g["empty_sets"] <= g["sets"]
    assert g["pods"] == base[2]
    assert g["unscheduled_rows"] == load(XRAY_SCENARIOS[kind])["unscheduled"]


PREEMPT_KEYS = RESULT_KEYS + ("preempted", "preempted_sha256", "nominations", "counters")


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["preempt", "sched_hard_waves"])
def test_preempt_and_sched_goldens_match_jax(kind):
    got = json.loads(json.dumps(compute(kind)))
    want = load(kind)
    for k in (PREEMPT_KEYS + ("checks",) if kind == "preempt" else RESULT_KEYS):
        assert got[k] == want[k], k


def test_preempt_golden_file_is_consistent():
    g = load("preempt")
    nodes, calls, _ = preempt_workload()
    n_pods = sum(len(c) for c in calls)
    assert g["generator"] == f"tests/test_torch_golden.py preempt_workload({PREEMPT_NODES})"
    assert len(g["per_node_counts"]) == len(nodes) == PREEMPT_NODES
    assert sum(g["per_node_counts"]) == g["placed"]
    # an evicted pod keeps its nodeName (the reference deletes it), so
    # summarize() counts it where it ran
    assert g["placed"] + g["unscheduled"] == n_pods
    assert sum(g["reason_census"].values()) == g["unscheduled"] == len(g["nominations"])
    c = g["checks"]
    nominated = sum(1 for _, v in g["nominations"] if v)
    assert c["nominated"] == nominated > 0
    assert c["candidate_with_both_lower_tiers"] and c["candidate_victims_under_the_pdb"]
    assert c["prod_n_failed_without_nomination"] == max(2, PREEMPT_NODES // 100)
    assert g["counters"]['simon_preemption_attempts_total{outcome="nominated"}'] == nominated
    assert g["counters"]["simon_preemption_victims_total"] == g["preempted"]


def test_sched_golden_file_is_consistent():
    g = load("sched_hard_waves")
    gen, n_nodes, n_pods, serial = SCENARIOS["hard_waves"]
    assert g["generator"] == generator(gen, n_nodes, n_pods)
    assert g["route"] == ROUTES[serial] + ", sched_config " + SCHED_HARD_WAVES
    assert len(g["per_node_counts"]) == n_nodes
    assert g["placed"] + g["unscheduled"] == n_pods
    # the configuration moves the placements off the default profile's
    assert g["choices_sha256"] != load("hard_waves")["choices_sha256"]
    for pkg in ("open_simulator_tpu", "open_simulator_torch"):
        sc = sched_config_of(pkg)
        assert sc.disabled_kernel_filters == frozenset({"NodePorts"})
        assert sc.disabled_encoder_filters == frozenset({"TaintToleration"})
        assert sc.score_weights["NodeResourcesBalancedAllocation"] == 0.0


def test_chip_smoke_builds_the_same_preempt_workload():
    """chip_smoke.py keeps its own copy of the workload function (it imports
    nothing of tests/): both copies build the same nodes, pods and PDB."""
    import chip_smoke

    for n in (64, PREEMPT_NODES):
        assert chip_smoke.preempt_workload(n) == preempt_workload(n)
    assert chip_smoke.PREEMPT_COUNTERS == PREEMPT_COUNTERS


def test_small_scenario_both_packages():
    # 4 nodes x 256 pod slots cannot hold 1,200 pods: the reasons path runs;
    # both packages on the serial route
    jax_side = run_jax("hard", 4, 1200, True)
    port_side = run_port("hard", 4, 1200, True)
    assert jax_side["unscheduled"] > 0
    for k in RESULT_KEYS:
        assert port_side[k] == jax_side[k], k


@pytest.mark.parametrize("gen,n_nodes,n_pods", [("hard", 4, 1200), ("plain", 40, 600),
                                                ("spread", 24, 320), ("affinity", 24, 320),
                                                ("extended", 48, 600)])
def test_small_scenario_both_packages_default_route(gen, n_nodes, n_pods):
    jax_side = run_jax(gen, n_nodes, n_pods, False)
    port_side = run_port(gen, n_nodes, n_pods, False)
    for k in RESULT_KEYS:
        assert port_side[k] == jax_side[k], k


def test_small_extended_scenario_both_packages_serial_route():
    # GPU-share and Open-Local demand past the cluster's: GPU and storage
    # reasons; every pod through the serial scan with both branches on
    jax_side = run_jax("extended", 48, 600, True)
    port_side = run_port("extended", 48, 600, True)
    for k in RESULT_KEYS:
        assert port_side[k] == jax_side[k], k
    census = " ".join(jax_side["reason_census"])
    assert "Node:node-" in census and "didn't have enough local storage" in census


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write [kind ...]")
    kinds = [k for k in sys.argv[1:] if k in ALL_KINDS] or sorted(SCENARIOS)
    for kind in kinds:
        g = compute(kind)
        with open(golden_path(kind), "w") as f:
            json.dump(g, f, indent=1)
            f.write("\n")
        print(kind, *(g[k] for k in ("choices_sha256", "placed", "nodes_added", "unscheduled")
                      if k in g))
