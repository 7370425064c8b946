"""The default route on the partitioned node layout of the PyTorch port
(every segment kind on the rank's block: K8 - K11 on the block, the
group-serial scan K13, the block commit K14; their plain versions
ops/kernels.py `schedule_group_serial_sharded_plain` and
`aggregate_commit_sharded_plain`) against the JAX package's node mesh and
its `schedule_group_serial` / `_aggregate_commit`, exactly (tolerance 0):
placements, failures, counts and carries bit for bit.

Two module-scoped spawns, started together (2 and 4 gloo ranks on the CPU,
`run_ranks`), run tests/torch_mesh_cases.py `default_route_cases` on every
rank; the JAX package's `make_node_mesh(shards)` runs on conftest's virtual
CPU devices in the test process. Held here:

- `Simulator(use_mesh=True)` on the default route places and fails the
  mixed (wave, affinity and serial routes) and hard-affinity workloads of
  tests/test_mesh_sharding.py (26 nodes: phantom padding) and a spread
  prefix (the group-serial route's three shapes) as JAX's
  `Simulator(use_mesh=True)` on make_node_mesh(shards), with each route's
  collectives;
- the plain block scan, assembled over the ranks, equals JAX
  `schedule_group_serial` on the JAX package's encode of the spread prefix
  (ScheduleAnyway, zoned SelectorSpread, two DoNotSchedule terms): counts,
  placed and the committed carry, with two all_gather_rows per pod and a
  pmax per ScheduleAnyway pod;
- the plain block commit, assembled, equals JAX `_aggregate_commit` with
  and without the GPU ledger (`gpu_live`);
- each rank holds 1/R of the node-axis table and carry bytes, and no carry
  leaf leaves its block over chained dispatches (simon_reshard_bytes_total
  stays 0);
- `probe_pods` on the mesh counts JAX's.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

import open_simulator_tpu.core.types as jax_types
import torch_mesh_cases as C
from open_simulator_torch.ops import kernels as TK
from open_simulator_torch.parallel.launch import run_ranks
from open_simulator_torch.utils.synth import synth_extended_cluster
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.parallel.mesh import make_node_mesh as jax_node_mesh
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator

SHARDS = (2, 4)


def _jax_batch(nodes, pods, services=(), storage_classes=()):
    """(bt, JAX tables, JAX carry, segments) of the JAX package's encode."""
    sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=False)
    sim.register_cluster_objects(jax_types.ResourceTypes(
        services=copy.deepcopy(list(services)),
        storage_classes=copy.deepcopy(list(storage_classes))))
    bt = sim.encode_batch(copy.deepcopy(pods))
    jt, jc = sim._to_device(bt)
    return bt, jt, jc, sim._segments(bt, len(pods))


def _arrays(bt) -> dict:
    return {f: np.asarray(getattr(bt, f)) for f in
            list(TK.Tables._fields) + ["seed_" + f for f in TK.Carry._fields]}


def _commits(bt, groups, gpu_live: bool, seed: int) -> list:
    """Seeded per-node counts for each group (about half the nodes, 0-3)."""
    rng = np.random.default_rng(seed)
    N = bt.alloc.shape[0]
    return [(int(g), (rng.integers(0, 4, size=N) * (rng.random(N) < 0.5)).astype(np.int32),
             gpu_live) for g in groups]


@pytest.fixture(scope="module")
def jax_tables():
    """The JAX package's encode of the spread prefix and of a small extended
    cluster, with the scan and commit specs the ranks run on them."""
    nodes, pods, services = C.spread_workload()
    sp = _jax_batch(nodes, pods, services)
    scans = []
    for seg in sp[3]:
        if seg[0] == "spread":
            _, _, m, g, cap1, ss, sa = seg
            spec = (int(g), int(m), bool(cap1), bool(ss), bool(sa),
                    sp[0].n_zones if ss else 2)
            if spec not in scans:
                scans.append(spec)
    groups = sorted({int(x) for x in sp[0].pod_group[:len(pods)]})
    e_nodes, e_pods, _, scs = synth_extended_cluster(32, 300)
    ex = _jax_batch(e_nodes, e_pods, storage_classes=scs)
    gpu_groups = sorted({int(s[3]) for s in ex[3] if s[0] == "wave" and s[5]})
    sets = [(_arrays(sp[0]), scans, _commits(sp[0], groups, False, 7)),
            (_arrays(ex[0]), [], _commits(ex[0], gpu_groups, True, 8)
             + _commits(ex[0], gpu_groups, False, 9))]
    return {"spread": sp, "extended": ex, "sets": sets}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_tables):
    """{shards: every rank's records}, one spawn per world size, both
    worlds at once."""
    # the directories are made before the threads: two first calls of
    # mktemp at once race to make pytest's base directory
    rdzv = {w: str(tmp_path_factory.mktemp(f"drdzv{w}")) for w in SHARDS}

    def spawn(w):
        return run_ranks(C.default_route_cases, w, rdzv[w], args=("cpu", jax_tables["sets"]),
                         device="cpu")

    with ThreadPoolExecutor(len(SHARDS)) as pool:
        return dict(zip(SHARDS, pool.map(spawn, SHARDS)))


def _jax_run(make, shards: int) -> dict:
    nodes, pods, *services = make()
    sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=True)
    sim.register_cluster_objects(jax_types.ResourceTypes(services=copy.deepcopy(
        services[0] if services else [])))
    sim._mesh = jax_node_mesh(shards)  # pin the shard count, as test_mesh_sharding.py does
    return C.placements(sim, sim.schedule_pods(copy.deepcopy(pods)))


def _assembled(blocks: list, field: str) -> np.ndarray:
    """A carry field of every rank's block in rank order (node-axis leaves
    concatenated; the domain counters, equal on every rank, taken once)."""
    if field in ("counter", "carrier"):
        assert all(np.array_equal(b[field], blocks[0][field]) for b in blocks)
        return blocks[0][field]
    return np.concatenate([b[field] for b in blocks])


def _same_carry(blocks: list, want) -> None:
    for f in TK.Carry._fields:
        mine, theirs = _assembled(blocks, f), np.asarray(getattr(want, f))
        assert mine.shape == theirs.shape, f
        assert np.array_equal(mine.view(np.uint8), theirs.view(np.uint8)), f


@pytest.mark.parametrize("shards", SHARDS)
def test_every_rank_agrees(ranks, shards):
    got = ranks[shards]
    assert [r["rank"] for r in got] == list(range(shards))
    strip = [{k: v for k, v in r.items() if k not in ("rank", "blocks", "layout")}
             for r in got]
    assert all(r == strip[0] for r in strip[1:])


@pytest.mark.parametrize("name,shards", [("mixed", 2), ("mixed", 4), ("hard_affinity", 2),
                                         ("hard_affinity", 4), ("spread", 2), ("spread", 4)])
def test_default_route_places_as_the_jax_mesh(ranks, name, shards):
    make = C.spread_workload if name == "spread" else C.WORKLOADS[name]
    got = ranks[shards][0][name]
    want = _jax_run(make, shards)
    assert got["shards"] == shards
    assert got["placed"] == want["placed"] and got["failed"] == want["failed"]
    if name == "mixed":
        assert {"wave", "affinity", "serial"} <= set(got["census"])
    if name == "hard_affinity":
        assert len(got["failed"]) == 4  # padding nodes 26-31 take none
    if name == "spread":
        assert {"spread", "wave"} <= set(got["census"])


@pytest.mark.parametrize("name", ("mixed", "hard_affinity", "spread"))
@pytest.mark.parametrize("shards", SHARDS)
def test_every_route_makes_its_collectives(ranks, jax_tables, name, shards):
    """The dispatches' collectives: one pmax and one all_gather_tiled per
    wave or affinity epoch, two all_gather_rows per serial or group-serial
    pod and a pmax per such pod with ScheduleAnyway terms, one
    all_gather_rows per commit; then one all_gather_tiled for the run's
    fetch of the block counts and one per failure diagnosis."""
    got = ranks[shards][0][name]
    epochs = got["wave"]["iterations"] + got["affinity"]["epochs"]
    sa_pods = (sum(s[2] for s in jax_tables["spread"][3] if s[0] == "spread" and s[6])
               if name == "spread" else 0)
    want = C.summed_calls({"pmax": epochs, "all_gather_tiled": epochs, "all_gather_rows": 0},
                          C.route_calls(got, sa_pods))
    assert got["dispatch_calls"] == want
    assert {k: v["calls"] for k, v in got["counts"].items()} == C.summed_calls(
        want, C.fetch_calls(got))
    assert got["fetches"] == 1


@pytest.mark.parametrize("shards", SHARDS)
def test_block_scan_equals_jax_group_serial(ranks, jax_tables, shards):
    bt, jt, jc, _ = jax_tables["spread"]
    scans = jax_tables["sets"][0][1]
    assert {(s[3], s[4]) for s in scans} == {(False, False), (True, False), (False, True)}
    assert int((bt.dns_t >= 0).sum(axis=1).max()) == 2  # groups with two DoNotSchedule terms
    recs = [r["blocks"][0]["scans"] for r in ranks[shards]]
    for k, (g, m, cap1, ss, sa, nz) in enumerate(scans):
        vd = np.arange(m + 3) < m
        want_c, want_j, want_p = jk.schedule_group_serial(
            jt, jc, np.int32(g), vd, np.bool_(cap1), ss_live=ss, sa_live=sa, n_zones=nz)
        blocks = [rec[k] for rec in recs]
        assert np.array_equal(np.concatenate([b["j"] for b in blocks]), np.asarray(want_j)), k
        assert all(b["placed"] == int(want_p) for b in blocks)
        _same_carry([b["carry"] for b in blocks], want_c)
        assert blocks[0]["calls"] == {"pmax": m if sa else 0, "all_gather_tiled": 0,
                                      "all_gather_rows": 2 * m}


@pytest.mark.parametrize("gpu_live", (False, True))
@pytest.mark.parametrize("shards", SHARDS)
def test_block_commit_equals_jax_aggregate_commit(ranks, jax_tables, shards, gpu_live):
    for t, key in enumerate(("spread", "extended")):
        _, jt, jc, _ = jax_tables[key]
        commits = jax_tables["sets"][t][2]
        recs = [r["blocks"][t]["commits"] for r in ranks[shards]]
        seen = 0
        for k, (g, j, gl) in enumerate(commits):
            if gl != gpu_live:
                continue
            seen += 1
            want = jk._aggregate_commit(jt, jc, jnp.int32(g), jnp.asarray(j), gl)
            _same_carry([rec[k] for rec in recs], want)
        if gpu_live and key == "extended":
            assert seen > 0


@pytest.mark.parametrize("shards", SHARDS)
def test_each_rank_holds_its_block_over_chained_dispatches(ranks, shards):
    """The counterpart of JAX's test_chained_dispatches_zero_reshard: every
    segment of the seeded workload dispatched in a chain leaves no carry
    leaf out of its block, and each rank holds 1/R of the node-axis table
    and carry bytes."""
    for r in ranks[shards]:
        lay = r["layout"]
        assert lay["segments"] > 3 and lay["moved"] == [0] * lay["segments"]
        assert lay["reshard_bytes"] == 0
        assert lay["held"] * shards == lay["full"]


@pytest.mark.parametrize("shards", SHARDS)
def test_probe_pods_counts_as_jax(ranks, shards):
    got = ranks[shards][0]["probe"]
    unsharded = C.probe_counts(None)
    for name, (nodes, pods, services) in (("mixed", (*C.mixed_workload(), [])),
                                          ("seeded", C.seeded_workload())):
        sim = JaxSimulator(copy.deepcopy(nodes), use_mesh=True)
        sim.register_cluster_objects(jax_types.ResourceTypes(services=copy.deepcopy(services)))
        sim._mesh = jax_node_mesh(shards)
        want = list(sim.probe_pods(copy.deepcopy(pods)))
        assert got[name] == want == unsharded[name], name
        assert got[name + "_utilization"] == unsharded[name + "_utilization"], name
