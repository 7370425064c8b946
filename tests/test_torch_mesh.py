"""The node-axis mesh of the PyTorch port (open_simulator_torch/parallel/)
against the JAX package's mesh and the port's unsharded run.

Two module-scoped spawns (2 and 4 gloo ranks on the CPU, `run_ranks`) run
every case of tests/torch_mesh_cases.py on every rank. Held here:

- end to end, on the JAX mesh tests' workloads, the port on `shards` ranks
  places every pod as the JAX Simulator on `make_node_mesh(shards)` (the 8
  virtual CPU devices of conftest.py) and as the port's unsharded run;
- the epoch path is really taken on the partitioned layout: one `pmax` and
  one `all_gather_tiled` per epoch of the wave and affinity segments, on
  both kinds, beside the other routes' collectives (two all_gather_rows per
  serial pod, one per commit, one all_gather_tiled per fetch and per
  failure diagnosis);
- the plain sharded kernels equal the unsharded ones bit for bit (counts,
  placed, statistics) on seeded tables whose upper shards' blocks are all
  infeasible;
- above OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES the wave's per-round path
  (K10's plain version) places the N = 2,560 workload as the JAX Simulator
  (whose GSPMD per-round form runs there) and as the unsharded port, with
  two `pmax` and two `all_gather_rows` per round, and equals the unsharded
  plain version bit for bit on seeded tables with the limit lowered;
- above the limit the affinity wave's sharded tail (K11's plain version)
  places the N = 2,560 `tail_workload` as the JAX Simulator and as the
  unsharded port, with two all_gather_rows per epoch, a third after
  use_multi_pre and a pmax after rounds that took pods (none in a round),
  and equals the unsharded plain version bit for bit on seeded tables with
  the limit lowered, every branch of the epoch reached;
- the route's rules: an N the shard count does not divide is padded with
  phantom nodes and places the same pods on the epoch path, and above the
  limit the wave segments make the rounds' collectives and the affinity
  segments the tail's; both place the same pods;
- every rank returns the same results, and a failing rank fails the run.
"""

import copy
from collections import Counter

import pytest
import torch

import torch_mesh_cases as C
from open_simulator_torch.parallel import (NODE_AXIS, SCENARIO_AXIS, ShardedKernels,
                                           choose_backend, epoch_shards, initialize_distributed,
                                           make_global_mesh, make_node_mesh, make_scenario_mesh,
                                           round_shards)
from open_simulator_torch.parallel.launch import run_ranks
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
import open_simulator_tpu.core.types as jax_types
from open_simulator_tpu.parallel.mesh import make_node_mesh as jax_node_mesh
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator

SHARDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{shards: every rank's results}, one spawn per world size."""
    return {w: run_ranks(C.rank_cases, w, str(tmp_path_factory.mktemp(f"rdzv{w}")),
                          device="cpu")
            for w in SHARDS}


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded engine run of every workload."""
    out = {name: C.run_engine(*make()) for name, make in C.WORKLOADS.items()}
    out["seeded"] = C.run_engine(*C.seeded_workload())
    out["rounds"] = C.run_engine(*C.rounds_workload())
    out["tail"] = C.run_engine(*C.tail_workload())
    return out


def _jax_run(name: str, shards: int) -> dict:
    make = {**C.WORKLOADS, "rounds": C.rounds_workload, "tail": C.tail_workload}[name]
    nodes, pods, *services = make()
    sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=True)
    sim.register_cluster_objects(jax_types.ResourceTypes(services=copy.deepcopy(
        services[0] if services else [])))
    sim._mesh = jax_node_mesh(shards)  # pin the shard count, as test_mesh_sharding.py does
    return C.placements(sim, sim.schedule_pods(copy.deepcopy(pods)))


@pytest.mark.parametrize("shards", SHARDS)
def test_every_rank_returns_the_same_results(ranks, shards):
    got = ranks[shards]
    assert [r["rank"] for r in got] == list(range(shards))
    strip = [{k: v for k, v in r.items() if k != "rank"} for r in got]
    assert all(r == strip[0] for r in strip[1:])
    assert got[0]["backend"] == "gloo" and got[0]["transport"] == "direct"


@pytest.mark.parametrize("name,shards", [("mixed", 2), ("mixed", 4), ("hard_affinity", 2),
                                         ("hostname_spread", 2), ("hostname_spread", 4)])
def test_port_mesh_places_as_the_jax_mesh(ranks, unsharded, name, shards):
    got = ranks[shards][0][name]
    want = _jax_run(name, shards)
    assert got["shards"] == shards
    assert got["placed"] == want["placed"] and got["failed"] == want["failed"]
    assert got["placed"] == unsharded[name]["placed"]
    assert got["failed"] == unsharded[name]["failed"]
    if name == "hard_affinity":
        assert len(got["failed"]) == 4  # the hard predicate really bites
    if name == "mixed":
        assert {"wave", "affinity", "serial"} <= set(got["census"])


@pytest.mark.parametrize("shards", SHARDS)
def test_one_pmax_and_one_gather_per_epoch(ranks, unsharded, shards):
    for name in (*C.WORKLOADS, "seeded"):
        got = ranks[shards][0][name]
        epochs = got["wave"]["iterations"] + got["affinity"]["epochs"]
        calls = {k: v["calls"] for k, v in got["counts"].items()}
        want = C.summed_calls({"pmax": epochs, "all_gather_tiled": epochs, "all_gather_rows": 0},
                              C.route_calls(got))
        assert got["dispatch_calls"] == want, name
        assert calls == C.summed_calls(want, C.fetch_calls(got)), name
        assert got["affinity"] == unsharded[name]["affinity"], name
        assert got["wave"] == unsharded[name]["wave"], name
    mixed = ranks[shards][0]["mixed"]
    assert mixed["wave"]["iterations"] > 0 and mixed["affinity"]["epochs"] > 0


@pytest.mark.parametrize("shards", SHARDS)
def test_seeded_cluster_with_infeasible_shards_places_as_unsharded(ranks, unsharded, shards):
    got = ranks[shards][0]["seeded"]
    assert got["placed"] == unsharded["seeded"]["placed"]
    assert got["failed"] == unsharded["seeded"]["failed"]
    assert {"wave", "affinity"} <= set(got["census"])


@pytest.mark.parametrize("shards", SHARDS)
def test_plain_sharded_kernels_equal_unsharded(ranks, shards):
    *segs, meta = ranks[shards][0]["kernels"]
    assert meta["N"] == 64  # nodes 32-63 cordoned: every upper shard's block is infeasible
    kinds = set()
    for plain, sharded in segs:
        kinds.add((plain["kind"], plain["ss_live"]))
        assert sharded["j"] == plain["j"] and sharded["placed"] == plain["placed"]
        assert sharded["stats"] == plain["stats"]
        epochs = plain["stats"].get("iterations", plain["stats"].get("epochs"))
        assert epochs > 0
        assert {k: v["calls"] for k, v in sharded["counts"].items()} == {
            "pmax": epochs, "all_gather_tiled": epochs, "all_gather_rows": 0}
    assert {("wave", False), ("affinity", False), ("affinity", True)} <= kinds


@pytest.mark.parametrize("shards", SHARDS)
def test_route_rules_make_no_collective(ranks, unsharded, shards):
    """An N the shard count does not divide is padded with phantom nodes,
    whose blocks take the epoch path (one pmax and one all_gather_tiled per
    epoch) and place as the unsharded run; above the epoch limit the wave
    segments take the per-round path and the affinity segments the sharded
    tail."""
    rules = ranks[shards][0]["rules"]
    ind = rules["indivisible"]
    assert ind["N"] % shards and ind["padded"] % shards == 0 and ind["padded"] > ind["N"]
    assert ind["kind"] == "affinity" and ind["same"]
    assert ind["calls"] == {"pmax": ind["epochs"], "all_gather_tiled": ind["epochs"],
                            "all_gather_rows": 0}
    above = rules["above_limit"]
    assert above["shards"] == shards
    rounds = above["wave"]["iterations"]
    assert rounds > 0 and above["affinity"]["epochs"] > 0
    assert C.tail_epochs(above["branches"]) == above["affinity"]["epochs"]
    assert above["dispatch_calls"] == C.summed_calls(
        C.round_calls(rounds), C.tail_calls(above["branches"]), C.route_calls(above))
    assert {k: v["calls"] for k, v in above["counts"].items()} == C.summed_calls(
        above["dispatch_calls"], C.fetch_calls(above))
    assert above["placed"] == unsharded["mixed"]["placed"]
    assert above["wave"] == unsharded["mixed"]["wave"]
    assert above["affinity"] == unsharded["mixed"]["affinity"]


@pytest.mark.parametrize("shards", SHARDS)
def test_rounds_path_places_as_the_jax_mesh(ranks, unsharded, shards):
    """N = 2,560 > the default epoch limit: the port's per-round path on
    `shards` ranks places every pod as the JAX Simulator on
    make_node_mesh(shards) and as the unsharded port, in several rounds."""
    got = ranks[shards][0]["rounds"]
    want = _jax_run("rounds", shards)
    assert got["shards"] == shards and set(got["census"]) == {"wave"}
    assert got["placed"] == want["placed"] and got["failed"] == want["failed"]
    assert got["placed"] == unsharded["rounds"]["placed"]
    assert got["failed"] == unsharded["rounds"]["failed"] == []
    assert got["wave"] == unsharded["rounds"]["wave"]
    rounds = got["wave"]["iterations"]
    assert rounds > got["census"]["wave"][0]  # some segment took two rounds or more
    assert {k: v["calls"] for k, v in got["counts"].items()} == C.summed_calls(
        C.round_calls(rounds), C.route_calls(got), C.fetch_calls(got))


@pytest.mark.parametrize("shards", SHARDS)
def test_plain_round_kernels_equal_unsharded(ranks, shards):
    """The plain per-round sharded wave against the unsharded plain version,
    bit for bit (counts, placed, WAVE_STATS), on every wave segment of the
    three seeded clusters of `round_segments` (limit 16), with the rounds'
    collectives; together the runs reach every branch of the round."""
    recs = ranks[shards][0]["round_kernels"]
    for r in recs:
        assert r["same"], r
        assert r["calls"] == C.round_calls(r["stats"]["iterations"]), r
    # a round that takes less than what is left, with entries the guard deferred
    assert any(r["stats"]["iterations"] > 1 and r["stats"]["guarded"] > 0 for r in recs)
    assert sum(r["stats"]["head_fallbacks"] for r in recs) > 0
    assert any(0 < r["kmax"] < r["m"] for r in recs)  # kmax below m
    # equal scores on both sides of a rank cut (the seeded cluster's upper
    # blocks hold no feasible node)
    assert all(r["ties"] for r in recs if r["cluster"] != "seeded")
    assert any(r["gpu_live"] for r in recs)  # EXT
    assert any(not r["fit"] for r in recs)
    # N 64 with nodes 32-63 cordoned: whole rank blocks are infeasible
    assert {r["N"] for r in recs if r["cluster"] == "seeded"} == {64}


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_tail_places_as_the_jax_mesh(ranks, unsharded, shards):
    """N = 2,560 > the default epoch limit: the port's affinity segments take
    the sharded tail on `shards` ranks and place every pod of
    `tail_workload` as the JAX Simulator on make_node_mesh(shards) (its
    GSPMD form of the plain loop) and as the unsharded port, with the
    tail's collectives beside the wave's rounds'."""
    got = ranks[shards][0]["tail_e2e"]
    want = _jax_run("tail", shards)
    assert got["shards"] == shards and "affinity" in got["census"]
    assert got["placed"] == want["placed"] and got["failed"] == want["failed"]
    assert got["placed"] == unsharded["tail"]["placed"]
    assert got["failed"] == unsharded["tail"]["failed"]
    assert got["affinity"] == unsharded["tail"]["affinity"]
    assert got["wave"] == unsharded["tail"]["wave"]
    epochs = got["affinity"]["epochs"]
    assert epochs > 0 and C.tail_epochs(got["branches"]) == epochs
    assert got["branches"].get("sandwich", 0) > 0  # rounds took pods, with no collective
    assert {k: v["calls"] for k, v in got["counts"].items()} == C.summed_calls(
        C.round_calls(got["wave"]["iterations"]), C.tail_calls(got["branches"]),
        C.route_calls(got), C.fetch_calls(got))


@pytest.mark.parametrize("shards", SHARDS)
def test_plain_tail_equals_unsharded(ranks, shards):
    """The plain sharded tail against the unsharded plain version, bit for
    bit (counts, placed, AFFINITY_STATS), on every affinity segment of the
    seeded clusters of `tail_segments` (limit 16, or 4 at N 8), with the
    tail's collectives per branch; together the runs reach every branch of
    the epoch."""
    recs = ranks[shards][0]["tail"]
    total = Counter()
    for r in recs:
        assert r["same"], r
        assert C.tail_epochs(r["branches"]) == r["stats"]["epochs"] > 0, r
        assert r["calls"] == C.tail_calls(r["branches"]), r
        total.update(r["branches"])
    # accepted multi-round epochs, by both takes; a head fallback without
    # use_multi_pre; a sandwich that rejected the rounds' take
    assert total["full_rounds"] > 0 and total["rise_rounds"] > 0
    assert total["head"] > 0 and total["rejected"] > 0
    assert any(r["bootstrap"] for r in recs)
    # live SelectorSpread with zone sums from several blocks
    assert any(r["ss_live"] and r["zones"] > 2 and r["blocks_feasible"] > 1 for r in recs)
    assert any(r["cluster"] == "hostname" and r["placed"] > 0 for r in recs)
    assert all(r["ties"] for r in recs if r["cluster"] in ("open", "hostname"))
    assert any(r["blocks_feasible"] < shards for r in recs)  # a wholly infeasible block
    # ROADMAP §C3 as the unsharded run: 17 pods on the two-slot node u0
    assert [r["on_last_real"] for r in recs if r["cluster"] == "overcommit"] == [17]


def _raise_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    return mesh.rank


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(_raise_on_rank_one, 2, str(tmp_path), device="cpu", timeout_s=120)


def test_single_process_mesh_and_refusals():
    assert initialize_distributed(world_size=1) is False
    mesh = make_node_mesh(device="cpu")
    assert (mesh.shards, mesh.rank, mesh.backend, mesh.shape) == (1, 0, "none", {NODE_AXIS: 1})
    assert epoch_shards(mesh, 32) == 1 and epoch_shards(None, 32) == 1
    with pytest.raises(ValueError):
        make_node_mesh(2, device="cpu")
    # the scenario axis: one process is one scenario group; the mesh never
    # shrinks to fit, and the fan-outs need a scenario axis
    sm = make_scenario_mesh(device="cpu")
    assert (sm.axis_names, sm.shape) == ((SCENARIO_AXIS, NODE_AXIS),
                                         {SCENARIO_AXIS: 1, NODE_AXIS: 1})
    assert sm.lane_block(4) == slice(0, 4) and epoch_shards(sm, 32) == 1
    assert make_global_mesh(scenario_axis=1, device="cpu").axis_names == (NODE_AXIS,)
    with pytest.raises(ValueError, match="not divisible"):
        make_global_mesh(scenario_axis=2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_scenario_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="scenarios"):
        ShardedKernels(mesh)
    assert ShardedKernels(sm).mesh is sm
    assert choose_backend("cpu", 4) == "gloo"
    if not torch.cuda.is_available():
        assert choose_backend("cuda", 2) == "gloo"


def test_epoch_path_limits(monkeypatch):
    mesh = make_node_mesh(device="cpu")
    mesh.shards = 4  # the rule alone, without ranks
    assert epoch_shards(mesh, 32) == 4
    assert epoch_shards(mesh, 30) == 1
    assert epoch_shards(mesh, 4096) == 1
    monkeypatch.setenv("OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES", "8192")
    assert epoch_shards(mesh, 4096) == 4
    monkeypatch.setenv("OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES", "16")
    assert epoch_shards(mesh, 32) == 1


def test_round_path_limits(monkeypatch):
    """round_shards is epoch_shards' complement above the limit: a 1-D node
    mesh of more than one shard and N a multiple of it, N > the limit."""
    mesh = make_node_mesh(device="cpu")
    assert round_shards(mesh, 4096) == 1 and round_shards(None, 4096) == 1
    mesh.shards = 4  # the rule alone, without ranks
    assert round_shards(mesh, 32) == 1
    assert round_shards(mesh, 2048) == 1 and epoch_shards(mesh, 2048) == 4
    assert round_shards(mesh, 2560) == 4 and epoch_shards(mesh, 2560) == 1
    assert round_shards(mesh, 2562) == 1
    monkeypatch.setenv("OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES", "16")
    assert round_shards(mesh, 32) == 4 and epoch_shards(mesh, 32) == 1
    assert round_shards(make_scenario_mesh(device="cpu"), 32) == 1


def test_simulator_mesh_choice(monkeypatch):
    nodes, _ = C.mixed_workload()
    monkeypatch.setenv("OPEN_SIMULATOR_MESH", "0")
    assert TorchSimulator(nodes, device="cpu")._resolve_mesh() is None
    monkeypatch.setenv("OPEN_SIMULATOR_MESH", "1")
    assert TorchSimulator(nodes, device="cpu")._resolve_mesh().shards == 1
    monkeypatch.delenv("OPEN_SIMULATOR_MESH")
    assert TorchSimulator(nodes, device="cpu")._resolve_mesh() is None  # no process group
    sim = TorchSimulator(nodes, device="cpu", use_mesh=True)
    assert sim._resolve_mesh().shards == 1
    assert sim._dispatch_dims(sim.encode_batch([]))["mesh"] is True
    assert TorchSimulator(nodes, device="cpu", use_mesh=False)._resolve_mesh() is None
