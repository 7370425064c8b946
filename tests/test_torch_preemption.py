"""DefaultPreemption in the port (open_simulator_torch/simulator/preemption.py)
against the JAX package's, on the CPU, exact.

Every case runs the same inputs through the JAX `Simulator` and the port's
`Simulator(device="cpu")` and compares, pod for pod: the placements in
node order, the `preempted` records (victim, node, preemptor), every
failure reason, every pod's final nodeName and nominatedNodeName, and the
deltas of the preemption counters (attempts by outcome, victims, replay
pods, rollbacks, commits). The cases:

- the 15 scenarios of tests/test_preemption.py (the scheduler-config one
  through each package's own `parse_scheduler_config`);
- the two arming cases of tests/test_simulate.py (mixed priorities with
  room to spare, and a priority gap between calls);
- the reconciliation of tests/test_obs.py (commits - rollbacks - victims =
  the pods live);
- the victim chain of tests/test_xray.py, recorded by both packages;
- a GPU-share and an Open-Local eviction, with the ledgers and annotations
  of the nodes and pods after it;
- a 64-node cut of chip_smoke.py's `preempt` run
  (tests/test_torch_golden.py `preempt_workload`) on the serial route and
  on the default route.
"""

import copy
import json

import pytest

import open_simulator_tpu.core.types as jax_types
from fixtures import make_node, make_pod
from open_simulator_torch.api.schedconfig import parse_scheduler_config as torch_parse
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_tpu.api.schedconfig import parse_scheduler_config as jax_parse
from open_simulator_tpu.obs import REGISTRY as JAX_REGISTRY
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from torch_preempt_cases import EXTRA_CASES, SCENARIOS, preempt_cut, record, run_port


def run(pkg, nodes, calls, sched_yaml=None, tmp_path=None, **kw):
    """Schedule `calls` (one schedule_pods call each) on a fresh Simulator
    of package `pkg`; returns (record, sim)."""
    if sched_yaml is not None:
        path = tmp_path / f"sched-{pkg}.yaml"
        path.write_text(sched_yaml)
        kw["sched_config"] = (jax_parse if pkg == "jax" else torch_parse)(str(path))
    if pkg == "torch":
        return run_port("cpu", nodes, calls, **kw)
    nodes, calls = copy.deepcopy(nodes), copy.deepcopy(calls)
    sim = JaxSimulator(nodes, use_mesh=False, sched_config=kw.pop("sched_config", None))
    sim.use_waves = kw.pop("use_waves", True)
    sim.register_cluster_objects(jax_types.ResourceTypes(
        pod_disruption_budgets=copy.deepcopy(list(kw.pop("pdbs", ()))),
        storage_classes=copy.deepcopy(list(kw.pop("storage_classes", ())))))
    assert not kw, kw
    v0 = JAX_REGISTRY.values()
    failed = []
    for call in calls:
        failed.extend(sim.schedule_pods(call))
    return record(sim, calls, failed, v0, JAX_REGISTRY.values()), sim


def both(nodes, calls, **kw):
    """The port's record against the JAX package's on the same inputs."""
    j, _ = run("jax", nodes, calls, **kw)
    t, tsim = run("torch", nodes, calls, **kw)
    for k in j:
        assert t[k] == j[k], k
    return t, tsim


# ------------------------------------------------ tests/test_preemption.py ----


@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, use_waves, tmp_path):
    build, victims, nominated = SCENARIOS[name]
    nodes, calls, kw = build()
    rec, _ = both(nodes, calls, tmp_path=tmp_path, use_waves=use_waves, **kw)
    assert len(rec["preempted"]) == victims
    assert sum(1 for p in rec["pods"] if p[2]) == nominated
    assert rec["armed"] == (name != "disabled_by_config")


# ------------------------------------------------ arming, metrics, xray ----


def test_mixed_priorities_across_batches_arm():
    low = [make_pod("low", cpu="100m", memory="128Mi")]
    high = [make_pod("high", cpu="100m", memory="128Mi")]
    high[0]["spec"]["priority"] = 1000
    for pkg in ("jax", "torch"):
        sim = (JaxSimulator([make_node("n0")], use_mesh=False) if pkg == "jax"
               else TorchSimulator([make_node("n0")], device="cpu"))
        sim.schedule_pods(copy.deepcopy(low))
        assert not sim._preempt_armed
        sim.schedule_pods(copy.deepcopy(high))
        assert sim._preempt_armed


def test_replay_cap_counts_capped_attempts(monkeypatch):
    """OPEN_SIMULATOR_MAX_PREEMPTION_REPLAYS=0: no rewind, every failure
    recorded as a capped attempt, as in the JAX package."""
    monkeypatch.setenv("OPEN_SIMULATOR_MAX_PREEMPTION_REPLAYS", "0")
    nodes, calls, _ = SCENARIOS["interleaves"][0]()
    rec, _ = both(nodes, calls)
    assert rec["preempted"] == []
    assert rec["counters"]['simon_preemption_attempts_total{outcome="capped"}'] == 4


def test_victim_chain_recorded_like_jax(tmp_path):
    from test_torch_xray import _assert_same_trace, _record
    from test_xray import replicas

    nodes = [make_node("n0", cpu="4")]
    low = replicas("low", 2, cpu="2")
    for p in low:
        p["spec"]["priority"] = 0
    hi = make_pod("hi", cpu="4")
    hi["spec"]["priority"] = 100
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsim, _ = _record("jax", jp, nodes, [low + [hi]])
    tsim, _ = _record("torch", tp, nodes, [low + [hi]])
    assert [e["pod"]["metadata"]["name"] for e in tsim.preempted] == ["low-0", "low-1"]
    _, tt = _assert_same_trace(jp, tp)
    exp = tt.explain("default/hi")
    assert exp["nominated_node"] == "n0"
    assert exp["victims"] == ["default/low-0", "default/low-1"]
    assert tt.explain("default/low-0")["preempted_by"] == "default/hi"


# ---------------------------------- the host ledgers, arming, metrics ----


@pytest.mark.parametrize("name", sorted(EXTRA_CASES))
def test_extra_case_matches_jax(name):
    """GPU-share and Open-Local evictions (the ledgers and the node and pod
    annotations after them), tests/test_simulate.py's armed run with room
    to spare and tests/test_obs.py's reconciliation."""
    build, victims, nominated = EXTRA_CASES[name]
    nodes, calls, kw = build()
    rec, sim = both(nodes, calls, **kw)
    assert rec["armed"] and len(rec["preempted"]) == victims
    assert sum(1 for p in rec["pods"] if p[2]) == nominated
    if name in ("gpushare", "openlocal"):
        assert [v for v, _, _ in rec["preempted"]] == ["low1"]
        assert [p["metadata"]["name"] for p in sim.pods_on_node[0]] == ["low0", "after"]
        key = "simon/node-gpu-share" if name == "gpushare" else "simon/node-local-storage"
        assert key in rec["node_annotations"][0]
    if name == "openlocal":
        ann = json.loads(rec["node_annotations"][0]["simon/node-local-storage"])
        assert int(ann["vgs"][0]["requested"]) == 16 << 30
    if name == "reconcile":
        c = rec["counters"]
        live = sum(len(lst) for lst in sim.pods_on_node)
        rollbacks = c["simon_commit_rollbacks_total"]
        assert rollbacks > 0 and c["simon_preemption_victims_total"] == len(sim.preempted)
        assert c["simon_commits_total"] - rollbacks - len(sim.preempted) == live
        assert c['simon_preemption_attempts_total{outcome="nominated"}'] == 1


# ------------------------------------------------ chip_smoke's preempt, cut ----


@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
def test_preempt_workload_cut_matches_jax(use_waves):
    nodes, calls, kw = preempt_cut(64)
    rec, _ = both(nodes, calls, use_waves=use_waves, **kw)
    assert rec["preempted"] and any(p[2] for p in rec["pods"])
    never = [p for p in rec["pods"] if p[0].startswith("prod-n")]
    assert never and all(p[2] is None for p in never)
