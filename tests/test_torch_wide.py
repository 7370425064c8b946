"""Tables past the default kernel build's fixed axes: the port against the JAX
package, and the wide build against the plain versions.

The default build of the hand kernels holds a group's term slots in arrays of
64 (ops/kernels.py MAX_SLOTS), a node's GPU devices, volume groups and storage
devices in arrays of 32 (MAX_NODE_DEVS) and the affinity kernels' candidate
key in 32 bits (domains up to AFFINITY_MAX_D1 = 2^21). A table past one of
them launches in the wide build (csrc/common.cuh OSIM_WIDE), which the view
reports (`_view` returns a WideTablesView). On the CPU the port runs its plain
versions; these tests hold them to the JAX package on such tables, bit for
bit: every slot axis at 65 (Ca and Cw at 128, as the carriers workload
encodes them), the node-device axes at 33 / 33 / 45 with their branches on,
the domain axis at 2^21 + 1 through both affinity waves, and the two
workloads of tests/test_torch_golden.py WIDE_SCENARIOS at a small size on
both routes. The tables are the encoder's own, widened by
open_simulator_torch/utils/widen.py with inert entries in front of the real
ones, so every real term sits past the default build's cap. The card tests
(skipped without CUDA) hold every wide kernel against its plain version
through chip_smoke.py's wide cases.
"""

import numpy as np
import pytest
import torch

import open_simulator_tpu.core.types as jax_types
import test_torch_golden as G
from open_simulator_torch.ops import kernels as tk
from open_simulator_torch.simulator.encode import plugin_flags
from open_simulator_torch.utils import synth
from open_simulator_torch.utils.widen import DEVICE_FIELDS, SLOT_FIELDS, widen, width_of
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator

# the width each axis is widened to (Ca and Cw: the carriers workload's own
# 128; every other slot axis 65)
WIDTHS = {**{a: 65 for a in SLOT_FIELDS}, "Ca": 128, "Cw": 128,
          "MAXDEV": 33, "MAXVG": 33, "MAXSD": 45, "D1": tk.AFFINITY_MAX_D1 + 1}
# the base workload whose encoded tables carry real entries on each axis
AXIS_BASE = {"A": "affinity", "B": "hard", "Cp": "carriers", "Sd": "spread", "Ss": "spread",
             "Ca": "carriers", "Cw": "carriers", "PP": "ports", "SL": "extended",
             "SD": "extended", "MAXDEV": "extended", "MAXVG": "extended",
             "MAXSD": "extended", "D1": "hard"}


def _ports_workload():
    nodes, pods = synth.synth_cluster(48, 200, hard_predicates=True)
    for i, p in enumerate(pods[::3]):
        p["spec"]["containers"][0]["ports"] = [{"containerPort": 80,
                                                "hostPort": 8080 + i % 4}]
    return nodes, pods, [], []


BASES = {
    "hard": lambda: (*synth.synth_cluster(48, 240, hard_predicates=True), [], []),
    "spread": lambda: (*synth.synth_spread_cluster(48, 240), []),
    "affinity": lambda: (*synth.synth_affinity_cluster(48, 240), []),
    "extended": lambda: synth.synth_extended_cluster(48, 400),
    "carriers": lambda: (*G.carriers_wide_workload(48, replicas=1, n_tail=24), [], []),
    "ports": _ports_workload,
}


def _base(name):
    """(JAX Simulator, pods, BatchTables of the whole batch)."""
    nodes, pods, services, scs = BASES[name]()
    sim = JaxSimulator(nodes, use_mesh=False)
    sim.register_cluster_objects(jax_types.ResourceTypes(services=list(services),
                                                         storage_classes=list(scs)))
    return sim, pods, sim.encode_batch(pods)


def _real(bt, axis) -> bool:
    """Whether the base's encoded axis holds a real entry."""
    field, _, fill = (SLOT_FIELDS.get(axis) or DEVICE_FIELDS[axis])[0]
    return bool((getattr(bt, field) != fill).any())


def _both_serial(sim, bt, P):
    """schedule_batch through both packages on bt: the JAX program and the
    port's plain version on the CPU; asserts choices and every carry field
    equal, bit for bit."""
    gpu, storage = plugin_flags(bt)
    jt, jc = sim._to_device(bt)
    jcarry, jch = jk.schedule_batch(jt, jc, bt.pod_group, bt.forced_node, bt.valid,
                                    n_zones=bt.n_zones, enable_gpu=gpu, enable_storage=storage)
    tt, tc = tk.tables_from_batch(bt, "cpu"), tk.carry_from_batch(bt, "cpu")
    pg, fn, vd = (torch.from_numpy(a) for a in (bt.pod_group, bt.forced_node, bt.valid))
    pcarry, pch = tk.schedule_batch(tt, tc, pg, fn, vd, bt.n_zones, enable_gpu=gpu,
                                    enable_storage=storage)
    assert np.array_equal(np.asarray(jch), pch.numpy())
    for f in tk.Carry._fields:
        a, b = np.asarray(getattr(jcarry, f)), getattr(pcarry, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return int((pch[:P] >= 0).sum())


@pytest.mark.parametrize("axis", list(SLOT_FIELDS))
def test_slot_axis_past_the_cap_matches_jax(axis):
    sim, pods, bt = _base(AXIS_BASE[axis])
    assert _real(bt, axis), f"the {AXIS_BASE[axis]} base has no {axis} entry"
    wt = widen(bt, axis, WIDTHS[axis])
    assert width_of(wt, axis) > tk.MAX_SLOTS
    placed = _both_serial(sim, wt, len(pods))
    assert placed > 0


@pytest.mark.parametrize("axis", list(DEVICE_FIELDS))
def test_node_device_axis_past_the_cap_matches_jax(axis):
    sim, pods, bt = _base("extended")
    assert plugin_flags(bt) == (True, True) and _real(bt, axis)
    wt = widen(bt, axis, WIDTHS[axis])
    assert width_of(wt, axis) > tk.MAX_NODE_DEVS
    assert _both_serial(sim, wt, len(pods)) > 0


def _domains_workload():
    """32 nodes, the last 4 without a zone (their domain the sentinel), and
    16 replicas with a zone DoNotSchedule self-spread of maxSkew 1: one
    affinity segment, a handful of counter rows."""
    nodes, _ = synth.synth_cluster(32, 0, hard_predicates=True)
    for n in nodes[28:]:
        del n["metadata"]["labels"]["topology.kubernetes.io/zone"]
    pods = [synth.synth_pod(i, labels={"app": "dz"}) for i in range(16)]
    for p in pods:
        p["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "dz"}}}]
    return nodes, pods


def test_domain_axis_past_2_21_through_both_affinity_waves():
    """D1 = 2^21 + 1 (the sentinel domain moved to the last column): one call
    of each package's affinity wave on the first affinity segment, from the
    seed carry; counts, placed, the epoch statistics and every carry field
    (after the commit) equal."""
    nodes, pods = _domains_workload()
    sim = JaxSimulator(nodes, use_mesh=False)
    bt = sim.encode_batch(pods)
    seg = next(s for s in sim._segments(bt, len(pods)) if s[0] == "affinity")
    _, _, m, g, cap1 = seg[:5]
    ss_live = bool(seg[5])
    wt = widen(bt, "D1", WIDTHS["D1"])
    assert wt.seed_counter.shape == (bt.seed_counter.shape[0], tk.AFFINITY_MAX_D1 + 1)
    assert bt.seed_counter.shape[0] <= 8 and len(nodes) <= 64
    D = bt.seed_counter.shape[1] - 1
    assert (wt.counter_dom == tk.AFFINITY_MAX_D1).sum() == (bt.counter_dom == D).sum() > 0
    block = jk.wave_block_for(m, len(nodes))
    n_zones = bt.n_zones if ss_live else 2
    # the port first, kept as numpy, then the JAX program: one side's
    # working set at a time (the test stays under 300 MB above the process)
    tt, tc = tk.tables_from_batch(wt, "cpu"), tk.carry_from_batch(wt, "cpu")
    tk.reset_launch_counts()
    got_c, got_j, got_p = tk.schedule_affinity_wave(tt, tc, g, m, bool(cap1), ss_live=ss_live,
                                                    block=block, n_zones=n_zones)
    got_st = tk.affinity_stats()
    got = {f: getattr(got_c, f).numpy() for f in tk.Carry._fields}
    got_j = got_j.numpy()
    del tt, tc, got_c
    jt, jc = sim._to_device(wt)
    want_c, want_j, want_p, want_st = jk.schedule_affinity_wave(
        jt, jc, np.int32(g), np.int32(m), np.bool_(cap1), ss_live=ss_live, block=block,
        n_zones=n_zones, stats=True)
    assert np.array_equal(np.asarray(want_j), got_j) and int(want_p) == got_p > 0
    assert got_st == dict(zip(tk.AFFINITY_STATS, np.asarray(want_st).tolist()))
    for f in tk.Carry._fields:
        assert np.array_equal(np.asarray(getattr(want_c, f)), got[f]), f


def _small_tables(axis):
    """The port's (tables, carry) on the CPU of the axis' base, widened on
    that axis, and its plugin flags."""
    _, _, bt = _base(AXIS_BASE[axis])
    wt = widen(bt, axis, WIDTHS[axis])
    return tk.tables_from_batch(wt, "cpu"), tk.carry_from_batch(wt, "cpu"), plugin_flags(bt)


@pytest.mark.parametrize("axis", list(SLOT_FIELDS) + list(DEVICE_FIELDS) + ["D1"])
def test_view_takes_the_table_and_reports_the_wide_build(axis):
    tt, tc, (gpu, storage) = _small_tables(axis)
    capped = axis == "D1"
    v = tk._view(tt, tc, 2, tk.DEFAULT_WEIGHTS, tk.DEFAULT_FILTERS, enable_gpu=gpu,
                 enable_storage=storage, domains_capped=capped)
    assert isinstance(v, tk.WideTablesView)
    dims = {k: getattr(v, k) for k in tk._DIM_FIELDS}
    assert axis in tk.wide_axes(dims, gpu, storage, capped)
    assert getattr(v, axis) >= WIDTHS[axis]
    if axis in DEVICE_FIELDS:  # the branches off: the device axes are never read
        off = tk._view(tt, tc, 2, tk.DEFAULT_WEIGHTS, tk.DEFAULT_FILTERS)
        assert type(off) is tk.TablesView
    if capped:  # only the affinity kernels cap the domain axis
        other = tk._view(tt, tc, 2, tk.DEFAULT_WEIGHTS, tk.DEFAULT_FILTERS)
        assert type(other) is tk.TablesView


def test_view_of_an_encoded_table_stays_in_the_default_build():
    _, _, bt = _base("extended")
    tt, tc = tk.tables_from_batch(bt, "cpu"), tk.carry_from_batch(bt, "cpu")
    v = tk._view(tt, tc, 2, tk.DEFAULT_WEIGHTS, tk.DEFAULT_FILTERS, enable_gpu=True,
                 enable_storage=True, domains_capped=True)
    assert type(v) is tk.TablesView
    assert tk.wide_axes({k: getattr(v, k) for k in tk._DIM_FIELDS}, True, True, True) == ()


# the workloads of tests/test_torch_golden.py WIDE_SCENARIOS at a small size
SMALL_WIDE = {"carriers_wide": (64, 1, 40), "storage_wide": (64, 400)}


@pytest.mark.parametrize("serial", [True, False], ids=["serial", "default"])
@pytest.mark.parametrize("kind", sorted(SMALL_WIDE))
def test_small_wide_workload_both_packages(kind, serial):
    jax_side = G.wide_run("open_simulator_tpu", kind, serial, *SMALL_WIDE[kind])
    port_side = G.wide_run("open_simulator_torch", kind, serial, *SMALL_WIDE[kind])
    for k in G.RESULT_KEYS + ("axes",):
        assert port_side[k] == jax_side[k], k
    axes = jax_side["axes"]
    if kind == "carriers_wide":
        assert axes["Ca"] > tk.MAX_SLOTS and axes["Cw"] > tk.MAX_SLOTS
    else:
        assert axes["MAXSD"] > tk.MAX_NODE_DEVS
    assert jax_side["placed"] > 0


def test_wide_golden_files_are_consistent():
    for kind, (fn, args) in G.WIDE_SCENARIOS.items():
        g = G.load(kind)
        nodes, pods, _ = G.wide_workload(kind)
        assert g["generator"] == f"tests/test_torch_golden.py {fn}({', '.join(map(str, args))})"
        axes = g["axes"]
        if kind == "carriers_wide":
            assert (axes["Ca"], axes["Cw"]) == (128, 128)
        else:
            assert axes["MAXSD"] > tk.MAX_NODE_DEVS
        for route in ("serial", "default"):
            r = g[route]
            assert len(r["per_node_counts"]) == len(nodes)
            assert sum(r["per_node_counts"]) == r["placed"]
            assert r["placed"] + r["unscheduled"] == len(pods)


def test_chip_smoke_builds_the_same_wide_workloads():
    """chip_smoke.py keeps its own copy of both workload functions (it imports
    nothing of tests/): both copies build the same nodes and pods."""
    import chip_smoke

    assert chip_smoke.carriers_wide_workload(64, 1, 40) == G.carriers_wide_workload(64, 1, 40)
    assert chip_smoke.storage_wide_workload(64, 400) == G.storage_wide_workload(64, 400)
    assert (chip_smoke.CARRIER_APPS, chip_smoke.STORAGE_BAYS) == (G.CARRIER_APPS,
                                                                  G.STORAGE_BAYS)
    assert {k: (v[0], v[1]) for k, v in chip_smoke.WIDE_RUNS.items()} == G.WIDE_SCENARIOS


# ------------------------------------------------------------------- the card --

CARD_BASES = {"extended": (256, 200, False), "affinity": (256, 40, True)}
SINGLE = {"feasibility", "schedule_batch", "schedule_wave", "aggregate_commit",
          "schedule_group_serial", "schedule_affinity_wave", "explain_jit",
          "probe_serial_fanout", "probe_wave_fanout", "probe_group_serial_fanout",
          "probe_affinity_wave_fanout", "aggregate_commit_lanes"}


@pytest.mark.cuda
def test_wide_kernels_match_plain_versions_on_the_card():
    """K1-K5, K3c, K7 and the lane kernels of K2-K5 and K3c in the wide build
    against their plain versions on the card, bit for bit, on tables past
    every cap each reads (chip_smoke.py wide_kernel_cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    cases = chip_smoke.wide_kernel_cases(CARD_BASES)
    assert {c["kernel"] for c in cases} == SINGLE
    for c in cases:
        assert c["same"] and c["wide_launches"] > 0, c


@pytest.mark.cuda
def test_wide_mesh_kernels_match_plain_on_two_ranks(tmp_path):
    """K8-K14 in the wide build on two ranks sharing cuda:0 over gloo against
    their plain versions on the same ranks (chip_smoke.py wide_mesh_rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()
    build.library(wide=True)  # build once, before the ranks load it
    got = run_ranks(chip_smoke.wide_mesh_rank, 2, str(tmp_path), args=(CARD_BASES,),
                    device="cuda", backend="gloo")
    assert {c["kernel"] for c in got[0]["cases"]} == set(chip_smoke.WIDE_KERNEL_NAMES) - SINGLE
    for r in got:
        for c in r["cases"]:
            assert c["same"] and c["wide_launches"] > 0, c
