"""The partitioned node layout of the PyTorch port and the serial route on it
(open_simulator_torch/parallel/mesh.py `to_device_sharded`,
`schedule_batch_on_mesh`; ops/kernels.py `schedule_batch_sharded_plain`,
the plain version of K12) against the JAX package's partitioned runs and
the port's unsharded ones, exactly: choices, carries, counters, reasons and
packed diagnostics bit for bit (tolerance 0).

Two module-scoped spawns, started together (2 and 4 gloo ranks on the CPU,
`run_ranks`), run tests/torch_mesh_cases.py `partitioned_cases` on every
rank; the JAX package's `make_node_mesh(shards)` runs on conftest's virtual
CPU devices in the test process. Held here:

- tests/test_parallel.py's three `schedule_batch_on_mesh` batches and the
  two seeded clusters below: the port's choices and final carry (the rank
  blocks in rank order) equal JAX's, padding is never placed, and the scan
  makes two all_gather_rows per pod;
- the plain sharded scan equals the unsharded `schedule_batch_plain` on
  seeded clusters that reach hostname anti-affinity overflow, the
  self-affinity bootstrap, DoNotSchedule, ScheduleAnyway on hostname and
  zone keys (one pmax more per such pod), SelectorSpread over zones cut by
  the blocks, forced nodes in every block, a block with no feasible node and
  GPU-share with Open-Local; `feasibility_jit` and `explain_jit` on the
  block, gathered, equal the unsharded diagnostics;
- the layout: node-axis leaves hold NL of the N rows or columns, the rest
  is whole, and `carry_reshard_bytes` is 0 after chained dispatches;
- the engine: `Simulator(use_mesh=True)` with `use_waves = False` places,
  fails and explains as JAX's on `make_node_mesh(shards)` and as the
  port's unsharded serial run (its xray trace too), and
  simon_reshard_bytes_total stays 0.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_mesh_cases as C
from open_simulator_torch.ops import kernels as TK
from open_simulator_torch.parallel import (NodeBlock, carry_reshard_bytes, carry_shardings,
                                           make_node_mesh, table_shardings, to_device_sharded)
from open_simulator_torch.parallel.launch import run_ranks
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_tpu.core.types import ResourceTypes as JaxResourceTypes
from open_simulator_tpu.parallel.mesh import make_node_mesh as jax_node_mesh
from open_simulator_tpu.parallel.mesh import schedule_batch_on_mesh as jax_schedule_batch_on_mesh
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from open_simulator_tpu.utils.synth import synth_cluster as jax_synth_cluster

SHARDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{shards: every rank's records}, one spawn per world size, both
    worlds at once."""
    # the directories are made before the threads: two first calls of
    # mktemp at once race to make pytest's base directory
    dirs = {w: (str(tmp_path_factory.mktemp(f"prdzv{w}")),
                str(tmp_path_factory.mktemp(f"pxray{w}"))) for w in SHARDS}

    def spawn(w):
        return run_ranks(C.partitioned_cases, w, dirs[w][0], args=("cpu", dirs[w][1]),
                         device="cpu")

    with ThreadPoolExecutor(len(SHARDS)) as pool:
        return dict(zip(SHARDS, pool.map(spawn, SHARDS)))


def _assembled(blocks: list, field: str) -> np.ndarray:
    """A carry field of every rank's block in rank order (node-axis leaves
    concatenated; whole leaves, equal on every rank, taken once)."""
    if field in ("counter", "carrier"):
        assert all(np.array_equal(b[field], blocks[0][field]) for b in blocks)
        return blocks[0][field]
    return np.concatenate([b[field] for b in blocks])


@pytest.mark.parametrize("shards", SHARDS)
def test_every_rank_agrees(ranks, shards):
    got = ranks[shards]
    assert [r["rank"] for r in got] == list(range(shards))
    for r in got[1:]:
        assert [b["choices"] for b in r["batches"]] == [b["choices"] for b in got[0]["batches"]]
        for key in ("mixed", "phantom"):
            assert r["engine"][key]["placed"] == got[0]["engine"][key]["placed"]
            assert r["engine"][key]["reasons"] == got[0]["engine"][key]["reasons"]


@pytest.mark.parametrize("case", range(len(C.JAX_BATCHES)))
@pytest.mark.parametrize("shards", SHARDS)
def test_schedule_batch_on_mesh_equals_jax(ranks, shards, case):
    """tests/test_parallel.py's batches (26 nodes padded, the simple cluster,
    padding never placed): the port's choices and final carry on `shards`
    ranks equal JAX's `schedule_batch_on_mesh` on make_node_mesh(shards)."""
    n, p, hard = C.JAX_BATCHES[case]
    nodes, pods = jax_synth_cluster(n, p, hard_predicates=hard)
    bt = JaxSimulator(nodes, use_mesh=False).encode_batch(pods)
    final, choices = jax_schedule_batch_on_mesh(bt, jax_node_mesh(shards))
    recs = [r["batches"][case] for r in ranks[shards]]
    got = recs[0]
    assert got["choices"] == np.asarray(choices).tolist()
    assert max(got["choices"]) < n  # padding is never placed
    for f in TK.Carry._fields:
        mine, theirs = _assembled([r["carry"] for r in recs], f), np.asarray(getattr(final, f))
        assert mine.shape == theirs.shape, f
        assert np.array_equal(mine.view(np.uint8), theirs.view(np.uint8)), f
    assert got["calls"] == {"pmax": 0, "all_gather_tiled": 0,
                            "all_gather_rows": 2 * got["valid"]}


@pytest.mark.parametrize("cluster", ("seeded", "extended"))
@pytest.mark.parametrize("shards", SHARDS)
def test_plain_sharded_scan_equals_unsharded(ranks, shards, cluster):
    """The plain sharded scan against `schedule_batch_plain` on the same
    seeded tables (choices, the gathered final carry), with two
    all_gather_rows per pod and a pmax per pod whose group has ScheduleAnyway
    terms; the block's gathered diagnostics against the unsharded ones."""
    rec = next(s for s in ranks[shards][0]["scans"] if s["cluster"] == cluster)
    assert rec["same_choices"] and rec["same_carry"]
    assert rec["calls"] == {"pmax": rec["sa_pods"], "all_gather_tiled": 0,
                            "all_gather_rows": 2 * rec["pods"]}
    assert rec["diag_same"] and rec["diag_cases"] > 0
    assert rec["diag_calls"]["all_gather_tiled"] == 2 * rec["diag_cases"]
    assert len(rec["placed_blocks"]) > 1  # winners from several blocks
    if cluster == "seeded":
        assert rec["sa_pods"] > 0 and rec["failed"] > 0  # ScheduleAnyway; the overflow
        assert rec["forced_blocks"] == list(range(shards))  # a forced node in every block
        if shards == 4:  # the last block is cordoned: it never has a feasible node
            assert rec["feasible_blocks"] == [0, 1, 2] and 3 not in rec["placed_blocks"]
    else:
        assert rec["flags"] == (True, True)  # GPU-share and Open-Local


@pytest.mark.parametrize("cluster", ("seeded", "extended"))
@pytest.mark.parametrize("shards", SHARDS)
def test_seeded_scan_equals_jax(ranks, shards, cluster):
    """The seeded clusters of the plain sharded scan (ScheduleAnyway on the
    hostname and zone keys with pmax #1b, SelectorSpread's zone sums cut by
    the blocks, forced nodes in every block; GPU-share with Open-Local)
    through JAX's `schedule_batch_on_mesh` on make_node_mesh(shards): the
    port's choices and final carry (the rank blocks in rank order) equal
    JAX's bit for bit."""
    _, nodes, pods, services, scs = next(c for c in C.partitioned_clusters() if c[0] == cluster)
    sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=False)
    sim.register_cluster_objects(JaxResourceTypes(services=list(services),
                                                  storage_classes=list(scs)))
    final, choices = jax_schedule_batch_on_mesh(sim.encode_batch(copy.deepcopy(pods)),
                                                jax_node_mesh(shards))
    recs = [next(s for s in r["scans"] if s["cluster"] == cluster) for r in ranks[shards]]
    assert recs[0]["choices"] == np.asarray(choices).tolist()
    if cluster == "seeded":
        assert recs[0]["sa_pods"] > 0  # the case reaches pmax #1b
    for f in TK.Carry._fields:
        mine, theirs = _assembled([r["carry"] for r in recs], f), np.asarray(getattr(final, f))
        assert mine.shape == theirs.shape, f
        assert np.array_equal(mine.view(np.uint8), theirs.view(np.uint8)), f


@pytest.mark.parametrize("shards", SHARDS)
def test_layout_holds_the_block(ranks, shards):
    """Each rank's node-axis leaves hold exactly its NL of the N rows or
    columns and every other leaf is whole; the carry stays in that layout
    through two chained dispatches (carry_reshard_bytes 0), and a full-width
    carry is out of it by its node-axis leaves' bytes."""
    for r in ranks[shards]:
        lay = r["layout"]
        N, NL = lay["N"], lay["NL"]
        assert NL * shards == N
        for f, leaf in lay["leaves"].items():
            assert leaf["same"], f
            if leaf["axis"] is None:
                assert leaf["shape"] == leaf["full"], f
            else:
                assert leaf["full"][leaf["axis"]] == N and leaf["shape"][leaf["axis"]] == NL, f
        assert {f for f, leaf in lay["leaves"].items() if leaf["axis"] is not None} >= {
            "alloc", "static_mask", "counter_dom", "carr_dom", "requested", "port_used"}
        assert lay["leaves"]["counter"]["axis"] is None
        assert lay["reshard_chained"] == 0
        assert lay["reshard_full"] == lay["node_carry_bytes"] > 0
        assert lay["bytes_block"] < lay["bytes_full"]


def _jax_engine(nodes, batches, shards):
    sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=True)
    sim.use_waves = False
    sim._mesh = jax_node_mesh(shards)  # pin the shard count, as test_mesh_sharding.py does
    failed = []
    for pods in batches:
        failed += sim.schedule_pods(copy.deepcopy(pods))
    out = C.placements(sim, failed)
    out["reasons"] = {u.pod["metadata"]["name"]: u.reason for u in failed}
    return out


@pytest.mark.parametrize("shards", SHARDS)
def test_engine_mixed_workload_equals_jax(ranks, shards):
    """tests/test_mesh_sharding.py `_mixed_workload` through
    Simulator(use_mesh=True) with use_waves = False: the port on `shards`
    ranks places as the JAX Simulator on make_node_mesh(shards) and as the
    port's unsharded serial run, and its xray trace equals the unsharded
    run's."""
    got = ranks[shards][0]["engine"]["mixed"]
    nodes, pods = C.mixed_workload()
    want = _jax_engine(nodes, [pods], shards)
    unsharded = ranks[shards][0]["engine"]["mixed_unsharded"]
    for other in (want, unsharded):
        assert got["placed"] == other["placed"] and got["failed"] == other["failed"]
        assert got["reasons"] == other["reasons"]
    assert set(got["census"]) == {"serial"}
    assert got["calls"]["all_gather_rows"] >= 2 * len(pods)  # the scan and the decision sets
    assert got["calls"]["pmax"] == 0
    assert got["same_xray"] is True


@pytest.mark.parametrize("shards", SHARDS)
def test_engine_phantom_nodes_equal_jax(ranks, shards):
    """tests/test_mesh_sharding.py's two-batch phantom test on the
    partitioned layout: every placement on a real node, the overflow fails
    with JAX's reasons, the phantom rows stay untouched."""
    got = ranks[shards][0]["engine"]["phantom"]
    want = _jax_engine(C.phantom_nodes(), [C.phantom_pods(0), C.phantom_pods(100)], shards)
    assert got["failed_per_batch"] == [0, 80 - (104 - 80)]
    assert got["placed"] == want["placed"] and got["failed"] == want["failed"]
    assert got["reasons"] == want["reasons"]
    assert got["phantom_untouched"] and got["padded"] == 32
    assert got["block_rows"] == 32 // shards
    assert got["utilization"]["cpu_used"] == 104 * 1000.0


@pytest.mark.parametrize("shards", SHARDS)
def test_reshard_bytes_counter_reads_zero(ranks, shards):
    """simon_reshard_bytes_total, counted on every partitioned dispatch of
    the engine runs, reads 0 after them."""
    for r in ranks[shards]:
        assert r["engine"]["reshard_bytes"] == 0


def test_layout_rules_in_one_process():
    """The rules alone: a node-axis rule slices its rank's block of rows or
    columns, refuses a node count the shards do not divide, and needs the
    node count to check a layout; a one-shard mesh stages everything whole
    and its scan takes the unsharded route."""
    rule = NodeBlock(axis=-1, rank=1, shards=4, device=torch.device("cpu"), nodes=8)
    a = np.arange(16).reshape(2, 8)
    assert rule(a).tolist() == [[2, 3], [10, 11]]
    assert NodeBlock(0, 3, 4, torch.device("cpu"))(np.arange(8)).tolist() == [6, 7]
    with pytest.raises(ValueError, match="do not split"):
        NodeBlock(0, 0, 3, torch.device("cpu"))(np.arange(8))
    with pytest.raises(ValueError, match="needs `nodes`"):
        NodeBlock(0, 0, 2, torch.device("cpu")).holds(torch.zeros(4))
    mesh = make_node_mesh(device="cpu")
    assert all(r.axis is None or r.shards == 1 for r in table_shardings(mesh))
    nodes, pods = C.mixed_workload()
    sim = TorchSimulator(copy.deepcopy(nodes), device="cpu", use_mesh=False)
    bt = sim.encode_batch(copy.deepcopy(pods))
    tb, cry, btp = to_device_sharded(bt, mesh)
    assert tb.alloc.shape[0] == btp.alloc.shape[0] == bt.alloc.shape[0]
    decl = carry_shardings(mesh, int(btp.alloc.shape[0]))
    assert carry_reshard_bytes(cry, decl) == 0
    args = [torch.from_numpy(x) for x in (bt.pod_group, bt.forced_node, bt.valid)]
    TK.reset_launch_counts()
    _, ch1 = TK.schedule_batch(tb, cry, *args, n_zones=bt.n_zones, mesh=mesh)
    _, ch0 = TK.schedule_batch_plain(tb, cry, *args, bt.n_zones)
    assert torch.equal(ch1, ch0)
    sim.use_waves = False
    assert sim._partition_mesh() is None  # no mesh: the replicated (unsharded) layout
