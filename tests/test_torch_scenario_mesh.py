"""The scenario axis of the PyTorch port's mesh (open_simulator_torch/parallel/)
against the JAX package on `make_scenario_mesh(R)`.

Two module-scoped spawns (2 and 4 gloo ranks on the CPU, `run_ranks`) run
every case of tests/torch_scenario_cases.py on every rank. Held here,
exactly (placements, counts, utilization floats, report bytes), and equal
on every rank:

- `ProbeSession.probe_many` on the cases of tests/test_mesh_sharding.py:281
  and :347 and on a session with a segment of every kind, through the
  tables' growth on the device and by re-upload; the automatic mesh (the
  process group has more than one rank) gives the same; the flight
  recorder's probe records on the mesh equal JAX's on its mesh;
- `WhatIfSession` responses on the wave and serial routes, with drains,
  padding lanes and an ingest batch;
- `SweepRunner` reports of the three examples/sweeps specs;
- `put_fanout_inputs` and a ShardedKernels fan-out (tests/test_parallel.py:186)
  and, on 4 ranks, `schedule_scenarios_on_mesh` on the 2-D mesh of two
  scenario groups (JAX `make_node_mesh(4, scenario_axis=2)`);
- each rank stages only its block of S/R lanes (every fan-out's carry
  block, the cached base carries) and each fetch gathers once per output it
  reads; each fan-out's block equals the same lanes of one run over all S;
- the `sweep` CLI on 2 ranks: rank 0's --out equals the one-process bytes
  (tests/golden/torch_port_sweep_zone-outage.json, what the one-process run
  writes: tests/test_torch_sweep.py), and the other rank writes and prints
  nothing.

The sweeps run with parity off (the fresh oracle is not the mesh's path).
The port records no compile-cache dispatch for the fan-outs (those metric
families are ROADMAP A9), so it has no `mesh` / `donate` dims to compare;
it donates nothing on any mesh.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest

import open_simulator_tpu.core.types as jax_types
import torch_scenario_cases as C
from open_simulator_torch.parallel.launch import run_ranks
from open_simulator_tpu.ops import kernels as jax_kernels
from open_simulator_tpu.parallel.mesh import make_node_mesh as jax_node_mesh
from open_simulator_tpu.parallel.mesh import make_scenario_mesh as jax_scenario_mesh
from open_simulator_tpu.parallel.mesh import pad_batch_tables as jax_pad
from open_simulator_tpu.parallel.mesh import put_fanout_inputs as jax_put_fanout_inputs
from open_simulator_tpu.parallel.mesh import schedule_scenarios_on_mesh as jax_scenarios
from open_simulator_tpu.serve import ResidentImage as JaxImage
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from open_simulator_tpu.simulator.probe import ProbeSession as JaxSession
from test_torch_sweep import golden_path

RANKS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{R: every rank's results}, one spawn per rank count."""
    return {w: run_ranks(C.rank_cases, w, str(tmp_path_factory.mktemp(f"rdzv{w}")),
                         args=(str(tmp_path_factory.mktemp(f"out{w}")),), device="cpu")
            for w in RANKS}


def _fetches_gather_blocks(rec: dict, groups: int, outputs: int = 2) -> None:
    """Every fetch gathered `outputs` outputs of this rank's block into
    block x groups lanes, and every fan-out ran on a block some fetch read."""
    assert rec["fetched"] and all(S == b * groups for b, S in rec["fetched"])
    assert rec["gathers"]["calls"] == outputs * sum(rec["fetched"].values())
    assert set(rec["blocks"]) <= {b for b, _ in rec["fetched"]}


@pytest.mark.parametrize("R", RANKS)
def test_every_rank_returns_the_same_results(ranks, R):
    got = ranks[R]
    assert [r["rank"] for r in got] == list(range(R))
    for key in ("probe", "serve", "sweep", "put_fanout", "scenarios"):
        if key not in got[0]:
            continue
        vals = [r[key] for r in got]
        if key == "probe":
            vals = [{n: v["rounds"] for n, v in x.items()} for x in vals]
        elif key in ("serve", "scenarios"):
            vals = [x.get("responses", x.get("choices")) for x in vals]
        elif key == "sweep":
            vals = [{n: v["report"] for n, v in x.items()} for x in vals]
        assert all(v == vals[0] for v in vals[1:]), key


@functools.lru_cache(maxsize=None)
def _jax_rounds(name: str, R: int) -> list:
    """The JAX session's rounds on make_scenario_mesh(R); `every_kind` on
    the 4-device mesh for both rank counts (its JAX programs take ~8 s to
    compile per mesh, and JAX's results do not depend on the mesh:
    tests/test_mesh_sharding.py)."""
    base, tpl, pods, services, n_new, rounds = C.probe_cases()[name]
    mesh = jax_scenario_mesh(4 if name == "every_kind" else R)
    ses = JaxSession.try_build(copy.deepcopy(base), tpl, copy.deepcopy(pods),
                               cluster_objects=jax_types.ResourceTypes(services=list(services)),
                               n_new=n_new, mesh=mesh)
    return C.probe_rounds(ses, rounds)


@pytest.mark.parametrize("name", ["wave", "every_kind"])
@pytest.mark.parametrize("R", RANKS)
def test_probe_sessions_equal_jax_on_the_scenario_mesh(ranks, name, R, tmp_path):
    want = _jax_rounds(name, R)
    got = ranks[R][0]["probe"][name]
    assert got["rounds"] == want
    assert got["auto_mesh"] and got["auto_same"]
    _fetches_gather_blocks(got, R)
    # 5 candidates in 8 lanes, then 3 in 4: every segment on S/R lanes
    assert got["fetched"] == {(8 // R, 8): 1, (4 // R, 4): 1}
    assert got["blocks"] == {8 // R: got["segments"], 4 // R: got["segments"]}
    if name == "wave":
        assert got["device_extensions"] == 1 and got["repeated_same"]
        base, tpl, pods, _, n_new, rounds = C.probe_cases()[name]
        jax_ses = JaxSession.try_build(copy.deepcopy(base), tpl, copy.deepcopy(pods),
                                       n_new=n_new, mesh=jax_scenario_mesh(R))
        want = C.xray_probe_records(jax_ses, rounds[0], str(tmp_path / "jax"))
        assert got["xray"] == want and len(want) == 1 + len(rounds[0])
    else:
        assert got["kinds"] == ["affinity", "serial", "spread", "wave"] and got["uploads"] == 2


@pytest.mark.parametrize("R", RANKS)
def test_whatif_responses_equal_jax_on_the_scenario_mesh(ranks, R):
    nodes, bound = C.make_cluster(10, 6)
    want = C.serve_steps(JaxImage.try_build(copy.deepcopy(nodes), pods=copy.deepcopy(bound),
                                            mesh=jax_scenario_mesh(R)))
    for r in ranks[R]:
        got = r["serve"]
        assert got["responses"] == want
        assert got["auto_mesh"]
        _fetches_gather_blocks(got, R)
        # the cached base carries hold this rank's block of S lanes
        assert got["cache_keys"] and all(
            (lo, hi) == (r["rank"] * S // R, (r["rank"] + 1) * S // R)
            for S, lo, hi in got["cache_keys"])
    routes = {x["path"] for x in want}
    assert routes == {"batched"} and want[0]["lanes"] == 6


@pytest.mark.parametrize("spec", C.SPECS)
@pytest.mark.parametrize("R", RANKS)
def test_sweep_reports_equal_jax_on_the_scenario_mesh(ranks, spec, R):
    from open_simulator_tpu.sweep import SweepRunner, build_report, load_spec, report_json

    runner = SweepRunner(load_spec(C.spec_path(spec)), parity="off", mesh=jax_scenario_mesh(R))
    runner.run()
    want = report_json(build_report(runner))
    for r in ranks[R]:
        got = r["sweep"][spec]
        assert got["report"] == want
        assert got["image_mesh"]
        _fetches_gather_blocks(got, R)


@pytest.mark.parametrize("R", RANKS)
def test_put_fanout_inputs_and_a_sharded_fanout_equal_jax(ranks, R):
    (nodes, pods), counts = C.fanout_workload()
    bt = JaxSimulator(copy.deepcopy(nodes)).encode_batch(copy.deepcopy(pods))
    S = len(counts)
    active = np.zeros((S, bt.alloc.shape[0]), bool)
    for i, n in enumerate(counts):
        active[i, :n] = True
    seeds = (bt.seed_requested, bt.seed_nonzero, bt.seed_port_used, bt.seed_counter,
             bt.seed_carrier, bt.seed_dev_used, bt.seed_vg_req, bt.seed_sdev_alloc)
    mesh = jax_scenario_mesh(R)
    tables, carry_s, active_s = jax_put_fanout_inputs(
        mesh, bt, tuple(np.broadcast_to(a, (S,) + a.shape) for a in seeds), active)
    with mesh:
        _, placed = jax_kernels.probe_serial_fanout(
            tables, carry_s, active_s, bt.pod_group, bt.forced_node, bt.valid,
            n_zones=bt.n_zones)
    for r in ranks[R]:
        got = r["put_fanout"]
        assert got["placed"] == np.asarray(placed).tolist()
        assert got["carry_lanes"] == got["active_lanes"] == S // R


def test_schedule_scenarios_on_the_2d_mesh_equals_jax(ranks):
    nodes, pods = C.scenarios_workload()
    bt = JaxSimulator(copy.deepcopy(nodes)).encode_batch(copy.deepcopy(pods))
    mesh = jax_node_mesh(4, scenario_axis=2)
    seeds = C.scenario_seeds(jax_pad(bt, mesh.shape["nodes"]).alloc)
    want = np.asarray(jax_scenarios(bt, mesh, seeds)).tolist()
    for r in ranks[4]:
        got = r["scenarios"]
        assert got["choices"] == want
        assert got["shape"] == {"scenarios": 2, "nodes": 2}
        assert got["lane_group"] == r["rank"] // 2
        assert got["blocks"] == {2: 1} and got["fetched"] == {(2, 4): 1}
        assert got["gathers"]["calls"] == 1
    assert want[3] != want[0]  # the full even nodes move the last lane's pods


@pytest.mark.parametrize("R", RANKS)
def test_each_rank_block_equals_the_full_launch(ranks, R):
    for r in ranks[R]:
        blocks = r["lane_blocks"]
        assert len(blocks) == 8
        assert all(v == {"lanes": 8 // R, "same": True} for v in blocks.values()), blocks


def test_sweep_cli_on_two_ranks_writes_once(ranks):
    r0, r1 = ranks[2][0]["cli"], ranks[2][1]["cli"]
    with open(golden_path("zone-outage"), "rb") as f:
        assert r0["rc"] == 0 and r0["report"] == f.read()
    assert r0["stdout"] and "scenarios in" in r0["stderr"]
    assert r1["rc"] == 0 and r1["report"] is None
    assert r1["stdout"] == "" and "scenarios in" not in r1["stderr"]


def test_scenario_mesh_entry_points_default_to_cuda(monkeypatch):
    import torch

    from open_simulator_torch.parallel import make_scenario_mesh
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_torch.sweep import SweepRunner, load_spec

    case = C.probe_cases()["wave"]
    nodes, bound = C.make_cluster(4, 2)
    cpu_mesh = make_scenario_mesh(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (make_scenario_mesh, lambda: C.port_session(case, None),
                  lambda: ResidentImage.try_build(nodes, pods=bound),
                  lambda: SweepRunner(load_spec(C.spec_path("zone-outage")))):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # an explicit mesh must be on the entry point's device
    monkeypatch.undo()
    card_mesh = dataclasses.replace(cpu_mesh, device=torch.device("cuda"))
    with pytest.raises(ValueError, match="mesh is on cuda"):
        ResidentImage.try_build(nodes, pods=bound, device="cpu", mesh=card_mesh)
    with pytest.raises(ValueError, match="mesh is on cuda"):
        C.port_session(case, "cpu", card_mesh)
