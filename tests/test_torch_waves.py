"""The segment router and its kernels: the PyTorch port against the JAX package.

Module parity: on one numpy `BatchTables`, the port's plain `schedule_wave`,
`schedule_group_serial` and `aggregate_commit` equal the JAX functions bit for
bit (per-node counts, placed, every `Carry` field), and the port's
`_segments` equals the JAX `_segments`. End to end: the port's default
`simulate()` / `Simulator.schedule_pods` (the segment router) equals the JAX
package's default, pod for pod, in node names and reason strings.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import open_simulator_torch
import open_simulator_torch.core.types as torch_types
import open_simulator_tpu.core.types as jax_types
from fixtures import make_node, make_pod
from open_simulator_torch.ops import kernels as tk
from open_simulator_torch.models.workloads import reset_name_counter as torch_reset_names
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_torch.utils.synth import synth_spread_cluster
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset_names
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.core import simulate as jax_simulate
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from open_simulator_tpu.utils.synth import synth_cluster
from test_waves import replicas
from torch_port_cases import CASES, build, outcome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZONE = "topology.kubernetes.io/zone"


def zoned(n, n_zones, **kw):
    return [make_node(f"n{i}", labels={ZONE: f"z{i % n_zones}"}, **kw) for i in range(n)]


def with_affinity(pods, app, topo, kind="podAffinity"):
    for p in pods:
        p["spec"].setdefault("affinity", {})[kind] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": topo}]}
    return pods


# ----------------------------------------------------------------- workloads ----
# (nodes, pods, services): each exercises one corner of the router's kernels

def _hard():
    # cap1 (hostname self-anti-affinity), taints with tolerations, zone spread
    nodes, pods = synth_cluster(64, 1200, hard_predicates=True)
    return nodes, pods, []


def _ports():
    # host ports make a capacity-1 wave; uneven nodes
    nodes = [make_node(f"p{i}", cpu=str(2 + i % 3), memory="8Gi") for i in range(12)]
    pods = replicas("hp", 16, cpu="100m", memory="128Mi", host_ports=[8080])
    pods += replicas("web", 40, cpu="300m", memory="256Mi")
    return nodes, pods, []


def _flat():
    # the flat-score shapes of tests/test_waves.py: one huge node beside small
    # ones (test_wave_depth_truncation_flat_scores) and two equal huge nodes
    # (test_wave_two_flat_columns_tie)
    nodes = [make_node("huge", cpu="2000", memory="4000Gi", pods="5000")]
    nodes += [make_node(f"small{i}", cpu="2", memory="2Gi") for i in range(4)]
    nodes += [make_node(f"twin{i}", cpu="1000", memory="2000Gi", pods="4000") for i in range(2)]
    pods = replicas("tiny", 400, cpu="10m", memory="16Mi")
    return nodes, pods, []


def _rising():
    # CPU-loaded nodes and memory-heavy pods: BalancedAllocation makes each
    # node's score column RISE with its copies, so every head hides behind
    # the other node's deeper entry (guard) and the head fallback runs
    nodes = [make_node(f"r{i}", cpu="4", memory="8Gi") for i in range(2)]
    pods = [make_pod(f"hog{i}", cpu="2500m", memory="100Mi", node_name=f"r{i}")
            for i in range(2)]
    pods += replicas("mem", 12, cpu="100m", memory="1Gi")
    return nodes, pods, []


def _spread():
    # live ScheduleAnyway, live zoned SelectorSpread, two DoNotSchedule terms
    return synth_spread_cluster(48, 400)


def _affinity():
    # required self-affinity (zone bootstrap and clump) and zone
    # self-anti-affinity: the "affinity" route
    nodes = zoned(12, 4, cpu="8")
    pods = with_affinity(replicas("cl", 30, cpu="100m", memory="128Mi"), "cl", ZONE)
    pods += with_affinity(replicas("az", 10, cpu="100m", memory="128Mi"), "az", ZONE,
                          "podAntiAffinity")
    pods += with_affinity(replicas("hn", 12, cpu="100m", memory="128Mi"), "hn",
                          "kubernetes.io/hostname")
    return nodes, pods, []


WORKLOADS = {"hard": _hard, "ports": _ports, "flat": _flat, "rising": _rising,
             "spread": _spread, "affinity": _affinity}
WAVE_WORKLOADS = ("hard", "ports", "flat", "rising", "spread")
_BATCHES: dict = {}


def _jax_sim(nodes, services):
    sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=False)
    if services:
        sim.register_cluster_objects(jax_types.ResourceTypes(services=copy.deepcopy(services)))
    return sim


def _torch_sim(nodes, services):
    sim = TorchSimulator(copy.deepcopy(nodes), device="cpu")
    if services:
        sim.register_cluster_objects(
            torch_types.ResourceTypes(services=copy.deepcopy(services)))
    return sim


def _split(pods):
    """(pre-bound pods, pods to schedule)."""
    bound = [p for p in pods if p["spec"].get("nodeName")]
    return bound, [p for p in pods if not p["spec"].get("nodeName")]


def _batch(name):
    """(bt, JAX tables, JAX carry, port tables, port carry, segments) of the
    workload's unbound pods, after its pre-bound pods are committed."""
    got = _BATCHES.get(name)
    if got is None:
        nodes, pods, services = WORKLOADS[name]()
        bound, pods = _split(copy.deepcopy(pods))
        sim = _jax_sim(nodes, services)
        sim.schedule_pods(bound)
        bt = sim.encode_batch(pods)
        jt, jc = sim._to_device(bt)
        got = _BATCHES[name] = (bt, jt, jc, tk.tables_from_batch(bt, "cpu"),
                                tk.carry_from_batch(bt, "cpu"), sim._segments(bt, len(pods)))
    return got


def _same_carry(want, got):
    for f in tk.Carry._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ------------------------------------------------------------ module parity ----

@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_segments_match_jax(name):
    *_, segs = _batch(name)
    nodes, pods, services = WORKLOADS[name]()
    bound, pods = _split(pods)
    jsim = _jax_sim(nodes, services)
    jsim.schedule_pods(copy.deepcopy(bound))
    jsim.encode_batch(copy.deepcopy(pods))
    sim = _torch_sim(nodes, services)
    sim.schedule_pods(copy.deepcopy(bound))
    tbt = sim.encode_batch(copy.deepcopy(pods))
    assert sim._segments(tbt, len(pods)) == segs
    groups = range(len(sim.encoder.group_list))
    assert [tuple(sim._wave_eligibility(g)) for g in groups] == [
        tuple(jsim._wave_eligibility(g)) for g in groups]


def _wave_cases(bt, segs, N):
    """(g, m, cap1, block, kmax) per wave segment, at the engine's own block
    and kmax and at a forced block 8 / kmax 16."""
    for seg in segs:
        if seg[0] != "wave":
            continue
        _, _, m, g, cap1, _ = seg
        block = jk.wave_block_for(m, N)
        yield g, m, bool(cap1), block, jk.wave_kmax(m, N, block)
        yield g, m, bool(cap1), 8, 16


@pytest.mark.parametrize("fit", [True, False])
@pytest.mark.parametrize("name", WAVE_WORKLOADS)
def test_schedule_wave_matches_jax(name, fit):
    bt, jt, jc, tt, tc, segs = _batch(name)
    assert any(s[0] == "wave" for s in segs)
    filters = tk.FilterFlags(fit=fit)
    jfilters = jk.FilterFlags(fit=fit)
    N = bt.alloc.shape[0]
    for g, m, cap1, block, kmax in _wave_cases(bt, segs, N):
        want_c, want_j, want_p = jk.schedule_wave(jt, jc, np.int32(g), np.int32(m),
                                                  np.bool_(cap1), filters=jfilters,
                                                  block=block, kmax=kmax)
        got_c, got_j, got_p = tk.schedule_wave(tt, tc, g, m, cap1, filters=filters,
                                               block=block, kmax=kmax)
        assert got_j.dtype == torch.int32
        assert np.array_equal(np.asarray(want_j), got_j.numpy()), (g, block, kmax)
        assert int(want_p) == got_p
        _same_carry(want_c, got_c)


@pytest.mark.parametrize("block,kmax", [(8, 16), (16, 32)])
def test_wave_guard_and_head_fallback_fire(block, kmax):
    """Rising score columns: the hidden-continuation guard defers entries,
    the head fallback places single pods, and the counts still equal the
    JAX wave's."""
    bt, jt, jc, tt, tc, segs = _batch("rising")
    (_, _, m, g, cap1, _), = segs
    j, placed, stats = tk.schedule_wave_plain(tt, tc, g, m, cap1, block=block, kmax=kmax)
    assert stats["head_fallbacks"] > 0 and stats["guarded"] > 0
    assert stats["iterations"] > stats["head_fallbacks"]
    _, want_j, want_p = jk.schedule_wave(jt, jc, np.int32(g), np.int32(m), np.bool_(cap1),
                                         block=block, kmax=kmax)
    assert np.array_equal(np.asarray(want_j), j.numpy()) and int(want_p) == placed == m


@pytest.mark.parametrize("fit", [True, False])
def test_schedule_group_serial_matches_jax(fit):
    bt, jt, jc, tt, tc, segs = _batch("spread")
    spread = [s for s in segs if s[0] == "spread"]
    seen = set()
    for _, _, m, g, cap1, ss_live, sa_live in spread:
        if (g, ss_live, sa_live) in seen:
            continue
        seen.add((g, ss_live, sa_live))
        vd = np.arange(m + 3) < m  # three padded pods at the end
        n_zones = bt.n_zones if ss_live else 2
        want_c, want_j, want_p = jk.schedule_group_serial(
            jt, jc, np.int32(g), vd, np.bool_(cap1), filters=jk.FilterFlags(fit=fit),
            ss_live=ss_live, sa_live=sa_live, n_zones=n_zones)
        got_c, got_j, got_p = tk.schedule_group_serial(
            tt, tc, g, torch.from_numpy(vd), bool(cap1), filters=tk.FilterFlags(fit=fit),
            ss_live=ss_live, sa_live=sa_live, n_zones=n_zones)
        assert np.array_equal(np.asarray(want_j), got_j.numpy()), (g, ss_live, sa_live)
        assert int(want_p) == got_p
        _same_carry(want_c, got_c)
    # every flag of the route, and groups with two DoNotSchedule terms
    assert {(s[5], s[6]) for s in spread} == {(True, False), (False, True), (False, False)}
    assert int((bt.dns_t >= 0).sum(axis=1).max()) == 2


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_aggregate_commit_matches_jax(name):
    bt, jt, jc, tt, tc, segs = _batch(name)
    N = bt.alloc.shape[0]
    rng = np.random.default_rng(7)
    for g in sorted({int(x) for x in bt.pod_group[:int(bt.valid.sum())]}):
        j = (rng.integers(0, 4, size=N) * (rng.random(N) < 0.5)).astype(np.int32)
        want = jk._aggregate_commit(jt, jc, jnp.int32(g), jnp.asarray(j), False)
        got = tk.aggregate_commit(tt, tc, g, torch.from_numpy(j))
        _same_carry(want, got)


# -------------------------------------------------------------- end to end ----

def _jax_default(nodes, pods, services):
    sim = _jax_sim(nodes, services)
    failed = sim.schedule_pods(pods)
    return outcome(jax_types.SimulateResult(failed, sim.get_cluster_node_status()))


def _port_default(nodes, pods, services):
    sim = _torch_sim(nodes, services)
    failed = sim.schedule_pods(pods)
    return outcome(torch_types.SimulateResult(failed, sim.get_cluster_node_status())), sim


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_matches_jax_default(name):
    nodes, pods, services = WORKLOADS[name]()
    want = _jax_default(nodes, copy.deepcopy(pods), services)
    got, sim = _port_default(nodes, copy.deepcopy(pods), services)
    assert len(got["nodes"]) > 0
    assert got == want
    assert set(sim.segment_census) - {"serial"}  # the router sent pods elsewhere


@pytest.mark.parametrize("n_nodes,n_pods", [(100, 600), (8, 2500)])
def test_synthetic_hard_matches_jax_default(n_nodes, n_pods):
    # (100, 600): wave and affinity segments; (8, 2500) overflows, so reasons
    # are taken against the end carries of several segments
    nodes, pods = synth_cluster(n_nodes, n_pods, hard_predicates=True)
    want = _jax_default(nodes, copy.deepcopy(pods), [])
    got, sim = _port_default(nodes, copy.deepcopy(pods), [])
    assert got == want
    assert {"wave", "affinity"} <= set(sim.segment_census)
    if n_nodes == 8:
        assert len(got["reasons"]) > 0


def _jax_sim_default(*args):
    jax_reset_names()
    return jax_simulate(*args)


def _port_sim_default(*args):
    torch_reset_names()
    return open_simulator_torch.simulate(*args, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_scenario_matches_jax_default(name):
    case = CASES[name]()
    want = outcome(_jax_sim_default(*build(jax_types, case)))
    got = outcome(_port_sim_default(*build(torch_types, case)))
    assert got == want


def test_demo1_simple_matches_jax_default():
    from open_simulator_torch.utils import yamlio as torch_yamlio
    from open_simulator_tpu.utils import yamlio as jax_yamlio

    def load(yamlio, types):
        cluster = yamlio.load_cluster_from_directory(
            os.path.join(REPO, "examples/cluster/demo_1"))
        app = types.AppResource("simple", yamlio.load_resources_from_directory(
            os.path.join(REPO, "examples/application/simple")))
        return cluster, [app]

    want = outcome(_jax_sim_default(*load(jax_yamlio, jax_types)))
    got = outcome(_port_sim_default(*load(torch_yamlio, torch_types)))
    assert len(got["nodes"]) > 0
    assert got == want


def test_use_waves_false_is_the_serial_route():
    nodes, pods, _ = _ports()
    sim = _torch_sim(nodes, [])
    sim.use_waves = False
    sim.schedule_pods(copy.deepcopy(pods))
    assert set(sim.segment_census) == {"serial"}
