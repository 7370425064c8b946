"""A CPU model of the cross-CTA steps of K3c, K14 and K7 on thread-block
clusters (open_simulator_torch/ops/csrc/aggregate_commit.cu with commit.cuh
`commit_cluster`, the wave-like routes' commit, one cluster a lane;
csrc/commit_sharded.cu, the same commit on a partitioned node mesh, its
rows stage a cluster over a rank's block and its domains stage a grid; and
csrc/explain.cu, the xray diagnostic, one cluster over the N nodes), held
against the plain versions' own values and the JAX package's.

Each runs on one cluster of C CTAs, CTA r owning the node slice
[r * chunk, (r + 1) * chunk). Where a kernel crosses the CTAs it must give
what the one-block form gave:
- K3c: each CTA clears its share of the [U, D+1] per-topology sums in
  global scratch, a cluster barrier; each CTA writes its slice's node rows
  of the NEW carry (requested, nonzero, ports, the device ledger replayed
  copy by copy with gpu_live, the rest copied) and adds its slice's counts
  into the sums (the sentinel column never counts), a cluster barrier; each
  CTA updates its share of the D+1 columns of every counter and carrier row
  from the complete sums. The input carry is never written. Over lanes,
  each lane has its own sums and its own group.
- K14: on each of R ranks, K3c's rows step on the rank's block (one
  cluster, the new block carry's rows and the block's counts), the sums of
  every rank gathered in rank order (all_gather_rows), then a grid over the
  (T + Tc) x (D+1) counter and carrier elements: each element sums the R
  ranks' counts in rank order and makes one multiply and one add; every
  element is written, the sentinel column too, and the input carry never.
- K7: each CTA's maxima over its feasible nodes (the minima negated) as
  order-preserving integer keys (okey), any zoned feasible node, and its
  zone sums as integers, merged in one round (maxima by max, sums in rank
  order); each CTA's ScheduleAnyway marks in global scratch, each CTA
  counting the marked domains of its share of the D domains, the counts
  summed into the topology sizes; the relevant nodes' raw scores' maximum
  and negated minimum merged by max.
The functions below are that arithmetic in plain PyTorch, step for step as
the kernels do it, at every cluster size `choose` gives (1, 2, 4, 8, 16).
The kernels cannot run here, so this is the CPU guard of the designs: on
the commit counts of seeded wave, spread and affinity segments and seeded
counts with the device ledger live, each step gives
`aggregate_commit_plain`'s carry and the JAX `_aggregate_commit`'s (and the
plain lanes'), and K14's on blocks of 1, 2 and 4 ranks, assembled over the
ranks, those and `aggregate_commit_sharded_plain`'s on every rank; on every
group of the five explain batches of tests/test_torch_kernels.py, against a mid-run carry, a full carry (an
empty F everywhere) and carries that leave room on one CTA's slice only,
each merged value equals `explain_pod`'s own (`_score_partials` reduced,
`_sa_marks`, `_sa_partials`) and the packed rows equal `explain_pod`'s and
the JAX `explain_pod`'s, bit for bit.

The model carries eleven named mutations, each a fault the designs must
not have; `test_named_mutation_is_caught` and
`test_sharded_commit_named_mutation_is_caught` show that each one makes a
check of this file fail:
- "sentinel_counted": the sentinel domain counted in the per-topology sums;
- "own_counts": a CTA's counter columns updated from its own counts only;
- "in_place": the input carry written in place;
- "shared_seg": the lanes sharing one [U, D+1] scratch;
- "local_max": a CTA-local maximum taken as the normalizer of its nodes;
- "empty_as_zero": an empty CTA's -inf read as 0 in the merge;
- "one_cta_marks": the topology sizes counted from one CTA's marks;
- "k14_sentinel_counted": K14's sentinel column counted in the block sums;
- "from_rank_1": K14's ranks summed from rank 1;
- "unwritten_element": K14's counter and carrier sentinel column left
  unwritten (as torch.empty leaves it);
- "k14_in_place": K14's input carry written in place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_simulator_torch.ops import kernels as tk
from open_simulator_tpu.ops import kernels as jk
from test_torch_cluster_scan import okey_t, ounkey_t
from test_torch_kernels import BATCHES

SIZES = (1, 2, 4, 8, 16)  # ops/cluster.py SIZES
K3C_MUTATIONS = ("sentinel_counted", "own_counts", "in_place", "shared_seg")
K7_MUTATIONS = ("local_max", "empty_as_zero", "one_cta_marks")
MUTATIONS = K3C_MUTATIONS + K7_MUTATIONS
F32 = torch.float32
NAN = float("nan")
NINF = float("-inf")


def shares(n: int, C: int) -> list:
    """commit.cuh cta_share (and cluster.cuh cluster_setup's cut): share r
    of n items is [r * w, (r + 1) * w), w = ceil(n / C)."""
    w = -(-n // C)
    return [(min(n, r * w), min(n, r * w + w)) for r in range(C)]


def same_carry(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def jax_carry_equal(want, got) -> bool:
    for f in tk.Carry._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if w.dtype != g.dtype or not np.array_equal(w, g):
            return False
    return True


# ------------------------------------------------------------------ K3c ----

def cluster_rows(tb, cry, out, g: int, j, gpu_live: bool, C: int, seg, mutation=None) -> list:
    """The rows step of one cluster over the view's N nodes (K3c's lane,
    K14's rows stage): each CTA writes its node slice's rows of the new
    carry `out` from `cry` (requested, nonzero, ports, the device ledger
    replayed copy by copy with gpu_live, the rest copied) and adds its
    slice's counts into the flat [U * D+1] sums `seg` (the sentinel column
    never counts). Returns each CTA's own [U, D+1] counts."""
    N, D1 = tb.alloc.shape[0], cry.counter.shape[-1]
    D, U = D1 - 1, tb.topo_dom.shape[0]
    jf = j.to(F32)
    own = []
    for lo, hi in shares(N, C):
        sl = slice(lo, hi)
        out.requested[sl] = cry.requested[sl] + tb.grp_requests[g][None, :] * jf[sl, None]
        out.nonzero[sl] = cry.nonzero[sl] + tb.grp_nonzero[g][None, :] * jf[sl, None]
        out.port_used[sl] = cry.port_used[sl]
        out.vg_req[sl] = cry.vg_req[sl]
        out.sdev_alloc[sl] = cry.sdev_alloc[sl]
        used = cry.dev_used[sl].clone()
        gmem, gnum, safe_mem = tk._wave_gpu_params(tb, g)
        if gpu_live and float(gmem) > 0:  # each node replayed by its thread
            single = bool(tb.grp_gpu_num[g] == 1)
            rem = j[sl].clone()
            while bool(torch.any(rem > 0)):
                take = tk._gpu_take(tb.dev_total[sl], used, gmem, gnum, safe_mem, single)
                used = used + take * gmem * (rem > 0).to(F32)[:, None]
                rem = rem - (rem > 0).to(rem.dtype)
        out.dev_used[sl] = used
        for n in range(lo, hi):  # the group's port bits on nodes with a copy
            if int(j[n]) > 0:
                for pid in tb.grp_ports[g].tolist():
                    if pid > 0:
                        out.port_used[n, pid] = True
        # the slice's counts, integer sums into the sums
        part = torch.zeros((U, D1), dtype=torch.int64)
        for u in range(U):
            d = tb.topo_dom[u, sl].long()
            keep = (d <= D if mutation == "sentinel_counted" else d < D) & (j[sl] != 0)
            part[u].index_add_(0, d[keep], j[sl][keep].long())
        own.append(part.to(F32))
        seg += part.reshape(-1).to(F32)
    return own


def fresh_like(cry):
    """New tensors as torch.empty leaves them: poisoned."""
    return tk.Carry(*(torch.full_like(t, True) if t.dtype == torch.bool
                      else torch.full_like(t, NAN) for t in cry))


def k3c_lanes(tb, cry_s, g_s: list, j_s, gpu_live: bool, C: int, mutation=None):
    """K3c over S lanes (lane s: group g_s[s], counts j_s[s], carry lane s of
    the [S, ...] `cry_s`), phase by phase as the clusters run them: every
    CTA's clear of its share of the sums, then (after the cluster barrier)
    its node rows and its slice's counts, then (after the second) its
    columns. Returns the new [S, ...] carry."""
    S = j_s.shape[0]
    D1, U = cry_s.counter.shape[-1], tb.topo_dom.shape[0]
    out = cry_s if mutation == "in_place" else fresh_like(cry_s)
    one = torch.full((U * D1,), NAN) if mutation == "shared_seg" else None
    segs = [one if one is not None else torch.full((U * D1,), NAN) for _ in range(S)]
    for s in range(S):  # each CTA clears its share of its lane's sums
        for a, b in shares(U * D1, C):
            segs[s][a:b] = 0.0
    own = [cluster_rows(tb, tk.carry_lane(cry_s, s, copy=False), tk.carry_lane(out, s, copy=False),
                        g_s[s], j_s[s], gpu_live, C, segs[s], mutation) for s in range(S)]
    for s in range(S):
        g = g_s[s]
        match = tb.counter_sel_match_g[:, g, None].to(F32)
        for r, (d0, d1) in enumerate(shares(D1, C)):
            seg = own[s][r] if mutation == "own_counts" else segs[s].view(U, D1)
            out.counter[s, :, d0:d1] = (cry_s.counter[s, :, d0:d1]
                                        + match * seg[tb.counter_topo.long()][:, d0:d1])
            out.carrier[s, :, d0:d1] = (cry_s.carrier[s, :, d0:d1] + tb.grp_carries[g][:, None]
                                        * seg[tb.carr_topo.long()][:, d0:d1])
    return out


def k3c(tb, cry, g: int, j, gpu_live: bool, C: int, mutation=None):
    """K3c on one lane: returns the new carry."""
    out = k3c_lanes(tb, tk.carry_lanes(cry, 1), [g], j[None], gpu_live, C, mutation)
    if mutation == "in_place":  # the lane view was a copy: write the input as the kernel would
        for t, o in zip(cry, out):
            t.copy_(o[0])
    return tk.carry_lane(out, 0)


def _segment_counts(bt, jt, jc, tt, tc, segs) -> tuple:
    """(bt, JAX tables, JAX carry, port tables, port carry, [(group,
    counts, gpu_live)]): the counts of the batch's first wave, spread and
    affinity segments from the port's plain kernels on its carry."""
    N = bt.alloc.shape[0]
    out = []
    for seg in segs:
        kind, _, m, g, cap1 = seg[:5]
        if kind == "wave":
            block = tk.wave_block_for(m, N)
            j = tk.schedule_wave_plain(tt, tc, g, m, bool(cap1), block=block,
                                       kmax=tk.wave_kmax(m, N, block), gpu_live=bool(seg[5]))[0]
        elif kind == "spread":
            j = tk.schedule_group_serial_plain(tt, tc, g, torch.ones(m, dtype=torch.bool),
                                               bool(cap1), ss_live=bool(seg[5]),
                                               sa_live=bool(seg[6]),
                                               n_zones=bt.n_zones if seg[5] else 2)[0]
        elif kind == "affinity":
            j = tk.schedule_affinity_wave_plain(tt, tc, g, m, bool(cap1), bool(seg[5]),
                                                block=tk.wave_block_for(m, N),
                                                n_zones=bt.n_zones if seg[5] else 2)[0]
        else:
            continue
        if int(j.sum()) and kind not in {k for k, *_ in out}:
            out.append((kind, g, j.to(torch.int32), kind == "wave" and bool(seg[5])))
    return bt, jt, jc, tt, tc, [(g, j, gl) for _, g, j, gl in out]


def _workload_counts(name: str) -> tuple:
    """A workload of tests/test_torch_waves.py, after its pre-bound pods."""
    from test_torch_waves import _batch

    return _segment_counts(*_batch(name))


def _unzoned_counts() -> tuple:
    """The hard-predicate cluster with every seventh node without a zone
    label: counts on nodes whose zone domain is the sentinel column."""
    from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
    from open_simulator_tpu.utils.synth import synth_cluster

    nodes, pods = synth_cluster(64, 600, hard_predicates=True)
    for i, n in enumerate(nodes):
        if i % 7 == 3:
            n["metadata"]["labels"].pop("topology.kubernetes.io/zone", None)
    sim = JaxSimulator(nodes, use_mesh=False)
    bt = sim.encode_batch(pods)
    jt, jc = sim._to_device(bt)
    out = _segment_counts(bt, jt, jc, tk.tables_from_batch(bt, "cpu"),
                          tk.carry_from_batch(bt, "cpu"), sim._segments(bt, len(pods)))
    # and seeded counts of the groups whose own counters take the zone sums
    rng = np.random.default_rng(3)
    N = bt.alloc.shape[0]
    zoned = [g for g in range(bt.static_mask.shape[0])
             if bool(out[3].counter_sel_match_g[:, g].any())]
    extra = [(g, torch.from_numpy((rng.integers(0, 4, size=N) * (rng.random(N) < 0.5))
                                  .astype(np.int32)), False) for g in zoned[:3]]
    return out[:5] + (out[5] + extra,)


def _gpu_counts(seed: int):
    """The device-ledger case: random GPU and storage tables (as
    tests/test_torch_extended.py makes them) and seeded counts of every
    GPU group, committed with gpu_live."""
    from test_torch_extended import _random_tables

    jt, jc, tt, tc, G = _random_tables(seed)
    rng = np.random.default_rng(seed)
    N = tt.alloc.shape[0]
    cases = []
    for g in range(G):
        if float(tt.grp_gpu_mem[g]) > 0:
            j = (rng.integers(0, 4, size=N) * (rng.random(N) < 0.5)).astype(np.int32)
            cases.append((g, torch.from_numpy(j), True))
    return None, jt, jc, tt, tc, cases[:4]


COMMIT_SOURCES = {"hard": lambda: _workload_counts("hard"),
                  "spread": lambda: _workload_counts("spread"),
                  "affinity": lambda: _workload_counts("affinity"),
                  "unzoned": _unzoned_counts, "gpu_live": lambda: _gpu_counts(0)}
_COMMITS: dict = {}


def commit_cases(name: str):
    if name not in _COMMITS:
        bt, jt, jc, tt, tc, cases = COMMIT_SOURCES[name]()
        assert cases, name
        want = [(g, j, gl, tk.aggregate_commit_plain(tt, tc, g, j, gl),
                 jk._aggregate_commit(jt, jc, jnp.int32(g), jnp.asarray(j.numpy()), gl))
                for g, j, gl in cases]
        _COMMITS[name] = (tt, tc, want)
    return _COMMITS[name]


def k3c_mismatches(name: str, C: int, mutation=None) -> list:
    """Where the model of K3c at C differs from the plain version, the JAX
    `_aggregate_commit` or leaves its input carry changed."""
    tt, tc, want = commit_cases(name)
    bad = []
    for g, j, gl, plain, jax_c in want:
        cry = tk.Carry(*(t.clone() for t in tc))
        got = k3c(tt, cry, g, j, gl, C, mutation)
        if not same_carry(got, plain):
            bad.append((name, C, g, "plain"))
        if not jax_carry_equal(jax_c, got):
            bad.append((name, C, g, "jax"))
        if not same_carry(cry, tc):
            bad.append((name, C, g, "input written"))
    return bad


@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("name", sorted(COMMIT_SOURCES))
def test_commit_cluster_steps_equal_plain_and_jax(name, C):
    assert k3c_mismatches(name, C) == []


def test_commit_cases_cross_the_ctas():
    """The inputs reach what the cross-CTA steps guard: counts on the nodes
    of several CTAs at C 16, domains shared by nodes of different CTAs (the
    zone topologies), columns of several CTAs' shares, and the device ledger
    replayed more than one copy on a node."""
    for name in sorted(COMMIT_SOURCES):
        tt, _, want = commit_cases(name)
        N = tt.alloc.shape[0]
        for g, j, gl, *_ in want[:1]:
            owners = {r for r, (lo, hi) in enumerate(shares(N, 16)) if int(j[lo:hi].sum())}
            assert len(owners) >= 2, name
    crossing = set()
    for name in sorted(COMMIT_SOURCES):
        tt, _, want = commit_cases(name)
        N = tt.alloc.shape[0]
        for _, j, *_ in want:
            for u in range(tt.topo_dom.shape[0]):
                dom = tt.topo_dom[u]
                for d in set(dom[j > 0].tolist()):
                    ctas = {r for r, (lo, hi) in enumerate(shares(N, 4))
                            if bool(((dom[lo:hi] == d) & (j[lo:hi] > 0)).any())}
                    if len(ctas) > 1:
                        crossing.add(name)
    assert crossing >= {"affinity", "gpu_live"}, crossing
    tt, tc, want = commit_cases("unzoned")  # counts on nodes of the sentinel domain
    D = tc.counter.shape[1] - 1
    assert any(bool(((tt.topo_dom[tt.counter_topo.long()] == D) & (j > 0)[None, :]
                     & tt.counter_sel_match_g[:, g, None]).any()) for g, j, *_ in want)
    _, _, want = commit_cases("gpu_live")
    assert any(int(j.max()) > 1 for _, j, *_ in want)


LANES = 3


def _lane_inputs():
    tt, tc, want = commit_cases("hard")
    cry_s = tk.carry_lanes(tc, LANES)
    gs = [want[s % len(want)][0] for s in range(LANES)]
    rng = np.random.default_rng(5)
    N = tt.alloc.shape[0]
    j_s = torch.from_numpy((rng.integers(0, 4, size=(LANES, N))
                            * (rng.random((LANES, N)) < 0.5)).astype(np.int32))
    return tt, cry_s, gs, j_s


def k3c_lanes_mismatches(C: int, mutation=None) -> list:
    tt, cry_s, gs, j_s = _lane_inputs()
    before = tk.Carry(*(t.clone() for t in cry_s))
    g_t = torch.tensor(gs, dtype=torch.int32)
    got = k3c_lanes(tt, cry_s, gs, j_s, False, C, mutation)
    bad = []
    if not same_carry(got, tk.aggregate_commit_lanes_plain(tt, before, g_t, j_s)):
        bad.append(("lanes", C, "plain"))
    if not same_carry(cry_s, before):
        bad.append(("lanes", C, "input written"))
    return bad


@pytest.mark.parametrize("C", SIZES)
def test_commit_lanes_cluster_steps_equal_plain(C):
    """K3c over lanes, a group per lane: each lane's new carry is the plain
    lane's, and the lanes' input carry is unchanged."""
    assert len(set(_lane_inputs()[2])) > 1
    assert k3c_lanes_mismatches(C) == []


# ------------------------------------------------------------------ K14 ----

K14_MUTATIONS = ("k14_sentinel_counted", "from_rank_1", "unwritten_element", "k14_in_place")
RANKS = (1, 2, 4)


class _Rank:
    """Rank r of an R-rank node mesh, as parallel/mesh.py block_of reads
    it."""

    def __init__(self, rank: int, shards: int):
        self.rank, self.shards, self.device = rank, shards, "cpu"


def k14(tb, cry, g: int, j, gpu_live: bool, R: int, C: int, mutation=None) -> list:
    """K14 on R ranks, each its block of N / R nodes and a cluster of C
    CTAs for its rows stage: every rank's rows stage (the new block carry's
    rows, the block's counts into its [U, D+1] sums, cluster_rows), the one
    all_gather_rows (the sums stacked in rank order), then every rank's
    domains grid over the (T + Tc) x (D+1) counter and carrier elements (the
    ranks' counts summed in rank order, one multiply and one add). Returns
    [(block tables, block input carry, its copy before the call, new block
    carry)] in rank order."""
    from open_simulator_torch.parallel.mesh import block_of

    N, D1 = tb.alloc.shape[0], cry.counter.shape[-1]
    U, D, NL = tb.topo_dom.shape[0], D1 - 1, N // R
    rows_mut = {"k14_sentinel_counted": "sentinel_counted"}.get(mutation)
    ranks, sums = [], []
    for r in range(R):
        tbl, cryl = block_of(tb, cry, _Rank(r, R))
        before = tk.Carry(*(t.clone() for t in cryl))
        out = cryl if mutation == "k14_in_place" else fresh_like(cryl)
        seg = torch.full((U * D1,), NAN)
        for a, b in shares(U * D1, C):  # each CTA clears its share
            seg[a:b] = 0.0
        cluster_rows(tbl, cryl, out, g, j[r * NL:(r + 1) * NL], gpu_live, C, seg, rows_mut)
        ranks.append((tbl, cryl, before, out))
        sums.append(seg.view(U, D1))
    rows = torch.stack(sums)  # all_gather_rows: [R, U, D+1] in rank order
    for tbl, cryl, before, out in ranks:
        x = rows[0] if mutation != "from_rank_1" else torch.zeros_like(rows[0])
        for q in range(1, R):
            x = x + rows[q]
        src = before if mutation == "k14_in_place" else cryl
        counter = src.counter + tb.counter_sel_match_g[:, g, None].to(F32) * x[
            tb.counter_topo.long()]
        carrier = src.carrier + tb.grp_carries[g][:, None] * x[tb.carr_topo.long()]
        cols = slice(0, D) if mutation == "unwritten_element" else slice(0, D1)
        out.counter[:, cols] = counter[:, cols]
        out.carrier[:, cols] = carrier[:, cols]
    return ranks


def k14_mismatches(name: str, C: int, R: int, mutation=None) -> list:
    """Where the model of K14 at C on R ranks, assembled over the ranks,
    differs from `aggregate_commit_sharded_plain` on each rank (its one
    all_gather_rows given every rank's block sums), the plain full-width
    commit and the JAX `_aggregate_commit`, or leaves a block's input carry
    or the carry changed."""
    from open_simulator_torch.parallel import collectives

    tt, tc, want = commit_cases(name)
    N = tt.alloc.shape[0]
    assert N % R == 0, (name, N, R)
    NL = N // R
    bad = []
    real = collectives.all_gather_rows
    for g, j, gl, plain, jax_c in want:
        cry = tk.Carry(*(t.clone() for t in tc))
        ranks = k14(tt, cry, g, j, gl, R, C, mutation)
        got = tk.Carry(*(torch.cat([o[3][i] for o in ranks]) if f not in ("counter", "carrier")
                         else ranks[0][3][i] for i, f in enumerate(tk.Carry._fields)))
        if not same_carry(got, plain):
            bad.append((name, C, R, g, "plain"))
        if not jax_carry_equal(jax_c, got):
            bad.append((name, C, R, g, "jax"))
        stack = torch.stack([tk._topo_seg(tbl, cryl, j[r * NL:(r + 1) * NL])
                             for r, (tbl, cryl, *_) in enumerate(ranks)])
        collectives.all_gather_rows = lambda t, mesh: stack.clone()
        try:
            for r, (tbl, cryl, before, out) in enumerate(ranks):
                sp = tk.aggregate_commit_sharded_plain(tbl, before, g, j[r * NL:(r + 1) * NL], gl,
                                                       _Rank(r, R))
                if not same_carry(out, sp):
                    bad.append((name, C, R, g, r, "sharded plain"))
                if not same_carry(cryl, before):
                    bad.append((name, C, R, g, r, "block input written"))
        finally:
            collectives.all_gather_rows = real
        if not same_carry(cry, tc):
            bad.append((name, C, R, g, "input written"))
    return bad


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("name", sorted(COMMIT_SOURCES))
def test_sharded_commit_steps_equal_plain_and_jax(name, C, R):
    assert k14_mismatches(name, C, R) == []


def test_sharded_commit_cases_cross_the_ranks():
    """The inputs reach what K14's cross-rank step guards at R 4: counts on
    the blocks of several ranks in one domain (a zone's counts summed over
    the ranks), on the zoned, the partly unzoned and the device-ledger
    sources."""
    crossing = set()
    for name in sorted(COMMIT_SOURCES):
        tt, _, want = commit_cases(name)
        NL = tt.alloc.shape[0] // 4
        for _, j, *_ in want:
            for u in range(tt.topo_dom.shape[0]):
                dom = tt.topo_dom[u]
                for d in set(dom[j > 0].tolist()):
                    owners = {r for r in range(4)
                              if bool(((dom[r * NL:(r + 1) * NL] == d)
                                       & (j[r * NL:(r + 1) * NL] > 0)).any())}
                    if len(owners) > 1:
                        crossing.add(name)
    assert crossing >= {"affinity", "gpu_live", "unzoned"}, crossing


@pytest.mark.parametrize("mutation", K14_MUTATIONS)
def test_sharded_commit_named_mutation_is_caught(mutation):
    found = []
    for name in sorted(COMMIT_SOURCES):
        found += k14_mismatches(name, 4, 2, mutation)
        if found:
            break
    assert found, f"the mutation {mutation!r} went unnoticed"


# ------------------------------------------------------------------- K7 ----

_EXPLAIN: dict = {}
_PACKED: dict = {}    # explain_pod's packed rows (bits) by batch, carry, group, forced
_JAX_ROWS: dict = {}  # the JAX explain_pod's, alike


def explain_batch(name: str):
    """(bt, JAX tables, port tables, [carry kind: (JAX carry, port carry)],
    groups, flags) of an explain batch of tests/test_torch_kernels.py: the
    mid-run carry and the full carry of tests/test_torch_xray.py."""
    if name not in _EXPLAIN:
        sim, pods = BATCHES[name]()
        bt = sim.encode_batch(pods)
        jt, jc = sim._to_device(bt)
        P = len(pods)
        ext = name == "extended"
        flags = dict(enable_gpu=ext, enable_storage=ext)
        valid = np.arange(bt.pod_group.shape[0]) < P // 2
        mid, _ = jk.schedule_batch(jt, jc, bt.pod_group, bt.forced_node, valid,
                                   n_zones=bt.n_zones, **flags)
        carries = {"mid": (mid, tk.carry_from_numpy(
            {f: np.asarray(v) for f, v in mid._asdict().items()}, "cpu"))}
        groups = sorted({int(g) for g in bt.pod_group[:P]})
        _EXPLAIN[name] = (bt, jt, tk.tables_from_batch(bt, "cpu"), carries, groups, flags)
    return _EXPLAIN[name]


def full_outside(tt, tc, lo: int, hi: int):
    """The carry with every node outside [lo, hi) full (requested = alloc):
    room only on that slice."""
    keep = torch.zeros(tt.alloc.shape[0], dtype=torch.bool)
    keep[lo:hi] = True
    return tc._replace(requested=torch.where(keep[:, None], tc.requested, tt.alloc))


def k7_merge(tb, loc: dict, Z: int, C: int, mutation=None):
    """Round B: each CTA's 9 maxima as okey (-inf keys for a CTA without a
    feasible node; read as 0 with "empty_as_zero"), its zoned flag and its
    integer zone sums; merged by max and by an integer sum in rank order.
    Returns (merged head [11 + Z] in PART_HEAD's layout, [C] per-CTA heads)."""
    F = loc["F"]
    N = F.shape[0]
    st = loc["st"]["raw"] if loc["st"] is not None else torch.zeros(N)
    vals = torch.stack([loc["simon_s"], loc["na_raw"], loc["t_raw"], loc["ip_raw"],
                        loc["pernode"], -loc["simon_s"], -loc["ip_raw"], st, -st])
    zone = tb.node_zone.long()
    heads = []
    for lo, hi in shares(N, C):
        f = F[lo:hi]
        keys = okey_t(torch.where(f[None, :], vals[:, lo:hi], NINF)).amax(dim=1) \
            if hi > lo else okey_t(torch.full((9,), NINF))
        if mutation == "empty_as_zero" and not bool(f.any()):
            keys = okey_t(torch.zeros(9))
        zs = torch.zeros(Z, dtype=torch.int64)
        zl = zone[lo:hi]
        ok = f & (zl >= 0) & (zl < Z)
        zs.index_add_(0, zl[ok], loc["pernode"][lo:hi][ok].long())
        flags = torch.tensor([bool(f.any()), bool((f & (zl > 0)).any())], dtype=torch.int64)
        heads.append((keys, flags, zs))
    keys = torch.stack([h[0] for h in heads]).amax(dim=0)
    flags = torch.stack([h[1] for h in heads]).amax(dim=0)
    zs = heads[0][2].clone()
    for h in heads[1:]:  # rank order, integers
        zs = zs + h[2]

    def head_of(k, fl, z):
        return torch.cat([ounkey_t(k), fl.to(F32), z.to(F32)])

    return head_of(keys, flags, zs), [head_of(*h) for h in heads]


def k7_topology_sizes(loc: dict, D1: int, C: int, mutation=None) -> torch.Tensor:
    """Round C: every CTA stores the marks of its relevant nodes (one array:
    a union), each CTA counts the marked domains of its share of the D
    domains, the counts add ("one_cta_marks": CTA 0's marks counted
    alone)."""
    N, Ss, D = loc["F"].shape[0], loc["sa_dom"].shape[0], D1 - 1
    marks = torch.zeros((Ss, D1), dtype=torch.bool)
    for r, (lo, hi) in enumerate(shares(N, C)):
        if mutation == "one_cta_marks" and r > 0:
            continue
        rel = loc["relevantF"][lo:hi]
        for s in range(Ss):
            marks[s, loc["sa_dom"][s, lo:hi][rel]] = True
    counts = torch.zeros(Ss, dtype=torch.int64)
    for d0, d1 in shares(D, C):
        counts += marks[:, d0:d1].sum(dim=1)
    return counts.to(F32)


def k7_sa(tb, g: int, loc: dict, sizes: torch.Tensor, C: int):
    """Round D: the relevant nodes' raw scores (the model's topology
    weights), each CTA's maximum and negated minimum as okey, merged by
    max. Returns (raw [N], [max, max of the negated])."""
    tpw = tk.topology_weight(sizes)
    contrib = loc["sa_at"] * tpw[:, None] + (tb.sa_maxskew[g][:, None] - 1.0)
    raw = tk._flr(tk._masked_sum(loc["svalid"], contrib))
    rel = loc["relevantF"]
    keys = []
    for lo, hi in shares(rel.shape[0], C):
        r = rel[lo:hi]
        keys.append(okey_t(torch.stack([torch.where(r, raw[lo:hi], NINF),
                                        torch.where(r, -raw[lo:hi], NINF)])).amax(dim=1)
                    if hi > lo else okey_t(torch.full((2,), NINF)))
    return raw, ounkey_t(torch.stack(keys).amax(dim=0))


def k7(tb, cry, g: int, forced: int, n_zones: int, flags: dict, C: int, mutation=None) -> dict:
    """K7's phases at C: the merged values and the packed rows."""
    storage = flags["enable_storage"]
    F, stages = tk.feasibility(tb, cry, g, forced, True, tk.DEFAULT_FILTERS, **flags)
    loc = tk._score_locals(tb, cry, g, F, storage)
    Z = max(2, n_zones)
    head, cta_heads = k7_merge(tb, loc, Z, C, mutation)
    sa = tk._has_sa(tb, g)
    sizes = k7_topology_sizes(loc, cry.counter.shape[1], C, mutation)
    if sa:
        raw, sa_red = k7_sa(tb, g, loc, sizes, C)
    else:  # no rounds C and D: every relevant node scores 100
        raw, sa_red = torch.zeros(F.shape[0]), torch.zeros(2)
    N = F.shape[0]
    if mutation == "local_max":  # each CTA normalizes its nodes by its own head
        comp = {k: torch.zeros(N) for k in tk.COMPONENT_ORDER}
        for (lo, hi), h in zip(shares(N, C), cta_heads):
            part = tk._score_final(tb, g, loc, h, sa_red, raw, n_zones, tk.DEFAULT_WEIGHTS,
                                   storage)
            for k, v in part.items():
                comp[k][lo:hi] = torch.as_tensor(v, dtype=F32).expand(N)[lo:hi]
    else:
        comp = tk._score_final(tb, g, loc, head, sa_red, raw, n_zones, tk.DEFAULT_WEIGHTS,
                               storage)
        comp = {k: torch.as_tensor(v, dtype=F32).expand(N) for k, v in comp.items()}
    packed = tk.pack_explain(F, {k: stages[k] for k in tk.EXPLAIN_STAGES},
                             tk.components_total(comp), comp)
    return dict(head=head, sizes=sizes, sa_red=sa_red, sa=sa, loc=loc, packed=packed)


def plain_values(tb, cry, g: int, loc: dict, Z: int) -> dict:
    """explain_pod's own values: the reduced partials, the marks' topology
    sizes and ScheduleAnyway's extrema (score_components's steps)."""
    D = cry.counter.shape[1] - 1
    part = tk._score_partials(tb, loc, Z, D, True)
    red = tk._reduce_partials(part[None], Z)
    marks = red[tk.PART_HEAD + Z:].view(-1, D + 1)
    sa_raw = tk._sa_raw(loc["sa_at"], marks, loc["svalid"], tb.sa_maxskew[g])
    return dict(head=red[:tk.PART_HEAD + Z], sizes=marks[:, :D].sum(dim=1),
                sa_red=tk._sa_partials(sa_raw, loc["relevantF"]))


def _bits(t) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(t, np.float32)).view(np.uint32)


def k7_mismatches(name: str, C: int, mutation=None, jax_check: bool = True) -> list:
    """Where the model of K7 at C differs from explain_pod's own values, its
    packed rows or the JAX explain_pod's, over every group, forced and not,
    against the mid-run carry, the full carry (an empty F everywhere), room
    on the last CTA's slice only and room everywhere but CTA 1's slice."""
    bt, jt, tt, carries, groups, flags = explain_batch(name)
    N = tt.alloc.shape[0]
    _, tc = carries["mid"]
    sl = shares(N, C)
    # (carry, the slice that defines it): the plain and JAX rows depend on
    # these, not on C, and are kept across the cluster sizes
    cases = {("mid",): tc, ("full",): full_outside(tt, tc, 0, 0),
             ("last_only",) + sl[-1]: full_outside(tt, tc, *sl[-1])}
    if C > 1:
        hole = tc._replace(requested=tc.requested.clone())
        hole.requested[sl[1][0]:sl[1][1]] = tt.alloc[sl[1][0]:sl[1][1]]
        cases[("hole",) + sl[1]] = hole
    Z = max(2, bt.n_zones)
    bad = []
    for kind, cry in cases.items():
        jc = None
        for g in groups:
            for forced in (-1, (7 * g + 3) % N):
                got = k7(tt, cry, g, forced, bt.n_zones, flags, C, mutation)
                want = plain_values(tt, cry, g, got["loc"], Z)
                where = (name, kind, C, g, forced)
                head = torch.cat([got["head"][:9], got["head"][10:]])
                whead = torch.cat([want["head"][:9], want["head"][10:]])
                if not np.array_equal(_bits(head), _bits(whead)):
                    bad.append(where + ("head",))
                if got["sa"]:
                    svalid = tt.sa_t[g] >= 0
                    if not torch.equal(got["sizes"][svalid], want["sizes"][svalid]):
                        bad.append(where + ("topology sizes",))
                    if not np.array_equal(_bits(got["sa_red"]), _bits(want["sa_red"])):
                        bad.append(where + ("sa extrema",))
                key = (name,) + kind + (g, forced)
                if key not in _PACKED:
                    _PACKED[key] = _bits(tk.pack_explain(*tk.explain_pod(
                        tt, cry, g, forced, True, bt.n_zones, **flags)))
                if not np.array_equal(_bits(got["packed"]), _PACKED[key]):
                    bad.append(where + ("packed",))
                if jax_check and forced < 0:
                    if key not in _JAX_ROWS:
                        if jc is None:
                            jc = jk.Carry(*(jnp.asarray(t.numpy()) for t in cry))
                        jf, js, jtot, jcomp = jk.explain_jit(
                            jt, jc, jnp.int32(g), jnp.int32(forced), jnp.asarray(True),
                            n_zones=bt.n_zones, **flags)
                        rows = ([np.asarray(jf), np.asarray(jtot)]
                                + [np.asarray(js[k]) for k in tk.EXPLAIN_STAGES]
                                + [np.broadcast_to(np.asarray(jcomp[k], np.float32), (N,))
                                   for k in tk.COMPONENT_ORDER])
                        _JAX_ROWS[key] = _bits(np.stack(rows).astype(np.float32))
                    if not np.array_equal(_JAX_ROWS[key], _bits(got["packed"])):
                        bad.append(where + ("jax",))
    return bad


@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_explain_cluster_steps_equal_plain_and_jax(name, C):
    assert k7_mismatches(name, C) == []


def test_explain_cases_cross_the_ctas():
    """The inputs reach what the cross-CTA steps guard at C 4: an empty F
    everywhere, F in the last CTA's slice only, a CTA without a feasible
    node beside CTAs with some, zone sums from nodes of several CTAs,
    ScheduleAnyway groups whose relevant nodes lie in several CTAs, and the
    GPU-share and Open-Local branches (EXT)."""
    seen = dict(empty=0, last_only=0, hole=0, zones=0, sa=0)
    for name in sorted(BATCHES):
        bt, jt, tt, carries, groups, flags = explain_batch(name)
        N = tt.alloc.shape[0]
        sl = shares(N, 4)
        _, tc = carries["mid"]
        for g in groups:
            for kind, cry in (("mid", tc), ("full", full_outside(tt, tc, 0, 0)),
                              ("last", full_outside(tt, tc, *sl[-1]))):
                F, _ = tk.feasibility(tt, cry, g, -1, True, tk.DEFAULT_FILTERS, **flags)
                per = [bool(F[lo:hi].any()) for lo, hi in sl]
                seen["empty"] += not any(per)
                seen["last_only"] += kind == "last" and per == [False] * 3 + [True]
                seen["hole"] += any(per) and not all(per)
                zoned = [bool((F[lo:hi] & (tt.node_zone[lo:hi] > 0)).any()) for lo, hi in sl]
                seen["zones"] += sum(zoned) > 1
                if kind == "mid" and tk._has_sa(tt, g):
                    loc = tk._score_locals(tt, cry, g, F, flags["enable_storage"])
                    seen["sa"] += sum(bool(loc["relevantF"][lo:hi].any()) for lo, hi in sl) > 1
    assert all(v > 0 for v in seen.values()), seen
    assert explain_batch("extended")[5]["enable_storage"]


# ------------------------------------------------------------ mutations ----

@pytest.mark.parametrize("mutation", MUTATIONS)
def test_named_mutation_is_caught(mutation):
    found = []
    for C in (2, 4):
        if mutation == "shared_seg":
            found += k3c_lanes_mismatches(C, mutation)
        elif mutation in K3C_MUTATIONS:
            for name in sorted(COMMIT_SOURCES):
                found += k3c_mismatches(name, C, mutation)
        else:
            for name in sorted(BATCHES):
                found += k7_mismatches(name, C, mutation, jax_check=False)
                if found:
                    break
        if found:
            break
    assert found, f"the mutation {mutation!r} went unnoticed"
