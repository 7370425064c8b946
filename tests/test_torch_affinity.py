"""The affinity wave: the PyTorch port against the JAX package.

Module parity: on one numpy `BatchTables`, the port's `schedule_affinity_wave`
(its plain version on the CPU, then `aggregate_commit`) equals the JAX
`schedule_affinity_wave(..., stats=True)` bit for bit: per-node counts,
placed, the epoch statistics (epochs, head-fallback epochs, productive
multi-rounds) and every `Carry` field. The shapes are those of
tests/test_affinity_waves.py, the affinity segments of
tests/test_torch_waves.py's workloads, Service-backed groups (live
SelectorSpread), the filter flags, a forced block of 2, and
`synth_affinity_cluster`. tests/test_torch_affinity_e2e.py runs the same
cases end to end.
"""

import copy

import numpy as np
import pytest

import open_simulator_tpu.core.types as jax_types
from fixtures import make_node, make_pod
from open_simulator_torch.ops import kernels as tk
from open_simulator_torch.utils.synth import synth_affinity_cluster
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from test_affinity_waves import ZONE, with_affinity, with_spread, zoned
from test_torch_waves import WORKLOADS, _same_carry
from test_waves import replicas

HOST = "kubernetes.io/hostname"


def _pods(app, n, **kw):
    kw.setdefault("cpu", "100m")
    kw.setdefault("memory", "128Mi")
    return replicas(app, n, **kw)


def _service(app):
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": app, "namespace": "default"},
            "spec": {"selector": {"app": app}}}


def _hetero_nodes():
    # uneven allocatables: the normalizer inputs differ per node
    return [make_node(f"hz{i}", labels={ZONE: f"z{i % 3}"}, cpu=f"{2001 + 997 * i}m",
                      memory=str((3 << 30) + 7919 * i)) for i in range(9)]


# ---------------------------------------------------------------------- cases ----
# name -> () -> (nodes, pre-bound pods, pods to schedule, services)

def _seeded_skip_bootstrap():
    seed = [make_pod(f"s{i}", labels={"app": "sd"}, node_name=f"n{i}", cpu="100m",
                     memory="128Mi") for i in range(2)]
    return zoned(12, 4, cpu="8"), seed, with_affinity(_pods("sd", 24), "sd", ZONE), []


def _seeded_existing_anti():
    seed = with_affinity([make_pod("s0", labels={"app": "ez"}, node_name="n0", cpu="100m",
                                   memory="128Mi")], "ez", ZONE, "podAntiAffinity")
    return (zoned(12, 4, cpu="8"), seed,
            with_affinity(_pods("ez", 8), "ez", ZONE, "podAntiAffinity"), [])


def _anti_other_app():
    # an anti term tracking another app is a static gate: the router sends it
    # to the plain wave; the affinity wave must place it the same way
    anchors = [make_pod(f"an-{i}", labels={"app": "anchor"}, node_name=f"n{i}", cpu="100m",
                        memory="128Mi") for i in range(2)]
    return (zoned(8, 4, cpu="8"), anchors,
            with_affinity(_pods("obs", 12), "anchor", ZONE, "podAntiAffinity"), [])


def _skewed_capacity():
    nodes = (zoned(6, 1, cpu="4")
             + [make_node(f"b{i}", labels={ZONE: "z1"}, cpu="4") for i in range(3)]
             + [make_node("c0", labels={ZONE: "z2"}, cpu="4")])
    return nodes, [], with_spread(_pods("sk", 80, cpu="200m", memory="256Mi"), "sk"), []


def _seeded_blocked_min_rise():
    seed = with_spread([make_pod(f"seed-{i}", labels={"app": "r"}, node_name="n0",
                                 cpu="100m", memory="128Mi") for i in range(5)], "r", max_skew=2)
    return zoned(9, 3, cpu="16"), seed, with_spread(_pods("r", 40), "r", max_skew=2), []


def _spread_hostname_anti():
    pods = with_spread(_pods("mx", 25, cpu="200m", memory="256Mi"), "mx", max_skew=2)
    return zoned(10, 3, cpu="4"), [], with_affinity(pods, "mx", HOST, "podAntiAffinity"), []


def _affinity_plus_anti(topo):
    pods = with_affinity(_pods("mix", 12), "mix", ZONE)
    return zoned(12, 4, cpu="8"), [], with_affinity(pods, "mix", topo, "podAntiAffinity"), []


def _service_backed(zones: bool):
    # Services select the groups: SelectorSpread is live. On zoned nodes with
    # required zone self-affinity every epoch is a head fallback; on unzoned
    # nodes (a rack topology) the takes run under the frozen maxN depth caps
    if zones:
        nodes = zoned(12, 4, cpu="8")
        return nodes, [], with_affinity(_pods("svc-a", 40), "svc-a", ZONE), [_service("svc-a")]
    nodes = [make_node(f"u{i}", cpu=f"{4 + i % 3}", labels={"rack": f"r{i % 5}"})
             for i in range(10)]
    pods = (with_affinity(_pods("svc-a", 40), "svc-a", "rack")
            + with_affinity(_pods("svc-b", 8), "svc-b", "rack", "podAntiAffinity"))
    return nodes, [], pods, [_service("svc-a"), _service("svc-b")]


def _anti_unlabeled_nodes():
    # zone self-anti-affinity where some nodes lack the zone label: their
    # entries sit in the sentinel domain, which no budget meters
    nodes = [make_node(f"n{i}", cpu="8", labels={ZONE: f"z{i % 3}"} if i < 6 else {})
             for i in range(10)]
    return nodes, [], with_affinity(_pods("au", 12), "au", ZONE, "podAntiAffinity"), []


def _anti_unlabeled_overcommit():
    # the same with one unlabeled node of two pod slots: the JAX wave meters
    # no budget in the sentinel domain and re-takes that node's entries in
    # every round, placing 17 pods where the serial scan places 2 (a
    # reference fault, ROADMAP §C); the port reproduces the JAX result
    nodes = [make_node(f"n{i}", cpu="8", labels={ZONE: f"z{i % 3}"}) for i in range(6)]
    nodes.append(make_node("u0", cpu="8", pods="2"))
    pods = with_affinity(_pods("ao", 20, cpu="400m"), "ao", ZONE, "podAntiAffinity")
    return nodes, [], pods, []


def _mixed_interleaved():
    # affinity, anti, spread and plain groups in one batch (the shape of
    # tests/test_affinity_waves.py test_mixed_groups_interleaved_batches)
    pods = (_pods("pl", 10) + with_affinity(_pods("af", 10), "af", ZONE)
            + with_affinity(_pods("an", 10), "an", ZONE, "podAntiAffinity")
            + with_spread(_pods("dz", 10), "dz"))
    return zoned(12, 4, cpu="8"), [], pods, []


def _synth_affinity():
    nodes, pods, services = synth_affinity_cluster(200, 800)
    return nodes, [], pods, services


def _from_workload(name):
    def build():
        nodes, pods, services = WORKLOADS[name]()
        bound = [p for p in pods if p["spec"].get("nodeName")]
        return nodes, bound, [p for p in pods if not p["spec"].get("nodeName")], services
    return build


CASES = {
    "bootstrap_clump": lambda: (zoned(12, 4, cpu="8"), [],
                                with_affinity(_pods("cl", 30), "cl", ZONE), []),
    "hostname_affinity": lambda: ([make_node(f"h{i}", cpu="4") for i in range(9)], [],
                                  with_affinity(_pods("hn", 20), "hn", HOST), []),
    "seeded_skip_bootstrap": _seeded_skip_bootstrap,
    "capacity_push": lambda: (zoned(8, 2, cpu="1", pods="3"), [],
                              with_affinity(_pods("sp", 16, cpu="200m", memory="64Mi"),
                                            "sp", ZONE), []),
    "zone_anti": lambda: (zoned(12, 4, cpu="8"), [],
                          with_affinity(_pods("az", 10), "az", ZONE, "podAntiAffinity"), []),
    "seeded_existing_anti": _seeded_existing_anti,
    "anti_unlabeled_nodes": _anti_unlabeled_nodes,
    "anti_unlabeled_overcommit": _anti_unlabeled_overcommit,
    "anti_other_app": _anti_other_app,
    "low_cardinality": lambda: (zoned(15, 5, cpu="4"), [],
                                with_spread(_pods("zs", 60), "zs", max_skew=2), []),
    "skewed_capacity": _skewed_capacity,
    "odd_epochs": lambda: (zoned(13, 5, cpu="2"), [],
                           with_spread(_pods("odd", 37, cpu="150m"), "odd"), []),
    "seeded_blocked_min_rise": _seeded_blocked_min_rise,
    "spread_hostname_anti_cap1": _spread_hostname_anti,
    "affinity_hostname_anti": lambda: _affinity_plus_anti(HOST),
    "affinity_zone_anti": lambda: _affinity_plus_anti(ZONE),
    "hetero_spread": lambda: (_hetero_nodes(), [],
                              with_spread(_pods("hz", 40, cpu="77m",
                                                memory=str((128 << 20) + 13)),
                                          "hz", max_skew=2), []),
    "hetero_affinity": lambda: (_hetero_nodes(), [],
                                with_affinity(_pods("ha", 30, cpu="99m", memory="96Mi"),
                                              "ha", ZONE), []),
    "service_zoned": lambda: _service_backed(True),
    "service_unzoned": lambda: _service_backed(False),
    "mixed_interleaved": _mixed_interleaved,
    "synth_affinity": _synth_affinity,
    "workload_hard": _from_workload("hard"),
    "workload_affinity": _from_workload("affinity"),
}
_BATCHES: dict = {}


def _batch(name):
    """(bt, JAX tables, JAX seed carry, port tables, segments, n_nodes) of the
    case's pods, after its pre-bound pods are committed."""
    got = _BATCHES.get(name)
    if got is None:
        nodes, bound, pods, services = CASES[name]()
        sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=False)
        sim.register_cluster_objects(jax_types.ResourceTypes(services=copy.deepcopy(services)))
        sim.schedule_pods(copy.deepcopy(bound))
        bt = sim.encode_batch(copy.deepcopy(pods))
        jt, jc = sim._to_device(bt)
        got = _BATCHES[name] = (bt, jt, jc, tk.tables_from_batch(bt, "cpu"),
                                sim._segments(bt, len(pods)), sim.na.N)
    return got


def _run_both(name, filters=None, block=None, kinds=("affinity",)):
    """Every segment of the given kinds through both packages, each from the
    JAX end carry of the one before; returns the summed statistics."""
    bt, jt, jc, tt, segs, n_nodes = _batch(name)
    jf, tf = jk.FilterFlags(**(filters or {})), tk.FilterFlags(**(filters or {}))
    totals = dict.fromkeys(tk.AFFINITY_STATS, 0)
    carry, ran = jc, 0
    for seg in segs:
        if seg[0] not in kinds:
            continue
        _, _, m, g, cap1 = seg[:5]
        ss_live = seg[0] == "affinity" and bool(seg[5])
        blk = block or jk.wave_block_for(m, n_nodes)
        n_zones = bt.n_zones if ss_live else 2
        want_c, want_j, want_p, want_st = jk.schedule_affinity_wave(
            jt, carry, np.int32(g), np.int32(m), np.bool_(cap1), ss_live=ss_live, filters=jf,
            block=blk, n_zones=n_zones, stats=True)
        tc = tk.carry_from_numpy({f: np.asarray(v) for f, v in carry._asdict().items()}, "cpu")
        tk.reset_launch_counts()
        got_c, got_j, got_p = tk.schedule_affinity_wave(
            tt, tc, g, m, bool(cap1), ss_live=ss_live, filters=tf, block=blk, n_zones=n_zones)
        want_j = np.asarray(want_j)
        assert got_j.numpy().dtype == want_j.dtype and np.array_equal(want_j, got_j.numpy()), seg
        assert int(want_p) == got_p, seg
        stats = tk.affinity_stats()
        assert stats == dict(zip(tk.AFFINITY_STATS, np.asarray(want_st).tolist())), seg
        _same_carry(want_c, got_c)
        for k in totals:
            totals[k] += stats[k]
        carry, ran = want_c, ran + 1
    assert ran > 0
    return totals


# ------------------------------------------------------------ module parity ----

@pytest.mark.parametrize("name", sorted(CASES))
def test_affinity_wave_matches_jax(name):
    kinds = ("affinity", "wave") if name == "anti_other_app" else ("affinity",)
    stats = _run_both(name, kinds=kinds)
    assert stats["epochs"] >= 1


def test_affinity_wave_branches_fire():
    """The epoch machinery's branches, as the JAX statistics count them: many
    multi-rounds in one epoch, the bootstrap head fallback, and a group whose
    every epoch is a head fallback."""
    assert _run_both("low_cardinality")["multi_rounds"] > 4
    boot = _run_both("bootstrap_clump")
    assert boot["head_fallbacks"] == 1 and boot["epochs"] == 2
    zoned_ss = _run_both("service_zoned")
    assert zoned_ss["head_fallbacks"] == zoned_ss["epochs"] == 40


@pytest.mark.parametrize("flag", ["fit", "interpod", "spread"])
def test_affinity_wave_filter_flags_match_jax(flag):
    _run_both("mixed_interleaved", filters={flag: False})


@pytest.mark.parametrize("name", ["low_cardinality", "service_unzoned", "hetero_affinity"])
def test_affinity_wave_block_two_matches_jax(name):
    # a two-deep table: the depth caps and the hidden-continuation cut bind,
    # so the segment takes several epochs
    assert _run_both(name, block=2)["epochs"] > 1
