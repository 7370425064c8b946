"""A CPU model of K9's tail on a thread-block cluster
(open_simulator_torch/ops/csrc/affinity_sharded.cu `affinity_sharded_tail`),
held against the plain affinity wave's epochs.

The tail runs on one cluster of C CTAs over the mesh's N nodes, CTA r
owning the node slice [r * chunk, (r + 1) * chunk) of the gathered rows.
Where it crosses the CTAs, it must give what the one-block tail gave:
- round 1's zone sums: each CTA's integer partial sums of the counts over
  F_start, added as integers (exact in any grouping, rounded to f32 once);
- the two-largest-bound cut: each CTA's two best (bound, node) pairs,
  merged with ties on the GLOBAL node;
- the candidates: each CTA counts its nodes' entries at or above the K_EP-th
  key, the CTAs' totals give each CTA its offset in rank order, and a CTA
  lays its nodes' entries out in node order there, so the list every CTA
  holds before its sort is the selected entries in flat (n * B + k) order;
  sorted, it is lax.top_k's order;
- the rounds, replicated on every CTA on that list (the compacted rounds of
  tests/test_torch_rounds_compact.py `compact_rounds`);
- the head fallback: each CTA's first maximum, merged with ties on the
  global node.
The functions below are that arithmetic in plain Python, step for step as
the kernel does it, at every cluster size `choose` gives the tail (2, 4, 8,
16). The kernel cannot run here, so this is the CPU guard of the design:
on every epoch of the seeded clusters of test_torch_rounds_compact.py
`_segments`, run by the unsharded plain affinity wave (whose epochs the
sharded epoch path's tail repeats on the gathered rows), each step gives
the plain epoch's value, read through the plain version's own helpers
(ops/kernels.py `_zone_sums`, `_affinity_usable_bound`, `_guarded`,
`_top_k`, `_affinity_round`, `_first_head`).
"""

import copy
import struct

import pytest
import torch

import test_torch_rounds_compact as RC
from open_simulator_torch.ops import kernels as K

SIZES = (2, 4, 8, 16)  # the tail's cluster sizes (ops/cluster.py SIZES past 1)


def cta_slices(N: int, C: int) -> list:
    """cluster.cuh cluster_setup's cut: CTA r owns [r * chunk, (r + 1) * chunk)."""
    chunk = -(-N // C)
    return [(min(N, r * chunk), min(N, r * chunk + chunk)) for r in range(C)]


def entry_key(v: float, n: int, k: int, B: int) -> int:
    """select.cuh entry_key: score desc, then flat index asc (-0 as +0)."""
    u = struct.unpack("<I", struct.pack("<f", 0.0 if v == 0.0 else v))[0]
    ob = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (ob << 32) | (0xFFFFFFFF - (n * B + k))


def cluster_zone_sums(pernode0, F, zn, Z: int, C: int) -> torch.Tensor:
    """Round 1's zone sums: each CTA's integer partials over its slice,
    added as integers over the CTAs in rank order, then one f32 rounding."""
    pn, f, z = pernode0.tolist(), F.tolist(), zn.tolist()
    total = [0] * Z
    for lo, hi in cta_slices(len(pn), C):
        part = [0] * Z
        for n in range(lo, hi):
            if f[n]:
                part[z[n]] += int(pn[n])
        total = [a + b for a, b in zip(total, part)]
    return torch.tensor(total, dtype=torch.float64).to(torch.float32)


def cta_rows(table_ext, avail, k_cap, F_hi, B: int):
    """Each F_hi node's usable prefix u and first hidden entry (the tail's
    per-node loop, avail clamped to B + 1 as the payload carries it)."""
    rows, av, kc, fh = table_ext.tolist(), avail.tolist(), k_cap.tolist(), F_hi.tolist()
    us, bounds = [], []
    for n, row in enumerate(rows):
        u, bound = 0, float("-inf")
        if fh[n]:
            first_bad, prev = B, 0.0
            for k in range(B + 1):
                if 0 < k < B and first_bad == B and row[k] > prev:
                    first_bad = k
                prev = row[k]
            a = min(int(av[n]), B + 1)
            u = max(0, min(a, int(kc[n]), first_bad))
            k_hid = min(first_bad, int(kc[n]))
            if k_hid < a:
                bound = row[k_hid]
        us.append(u)
        bounds.append(bound)
    return us, bounds


def _before(a, b, lo_a: int, lo_b: int) -> bool:
    """(value, node) pair a before b in first-max order: value desc, then
    the global node asc (wave_cluster.cuh top2_update, argmax_update);
    lo_a and lo_b are the first nodes of the pairs' CTAs, whose local
    indices (node - lo) order no tie."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def cta_top2(vals, lo: int, hi: int) -> list:
    """One CTA's two best (value, node) pairs (top2_update over its slice)."""
    best = [(float("-inf"), 2 ** 31 - 1), (float("-inf"), 2 ** 31 - 1)]
    for n in range(lo, hi):
        p = (vals[n], n)
        if _before(p, best[0], lo, lo):
            best = [p, best[0]]
        elif _before(p, best[1], lo, lo):
            best[1] = p
    return best


def merge_top2(tops: list, slices: list) -> list:
    """cluster_top2's merge of the CTAs' pairs: the first max over the
    firsts, then over the others' firsts and the winner's second."""
    win = 0
    for r in range(1, len(tops)):
        if _before(tops[r][0], tops[win][0], slices[r][0], slices[win][0]):
            win = r
    second, s_lo = tops[win][1], slices[win][0]
    for r in range(len(tops)):
        if r != win and _before(tops[r][0], second, slices[r][0], s_lo):
            second, s_lo = tops[r][0], slices[r][0]
    return [tops[win][0], second]


def cluster_head(vals, F, C: int) -> int:
    """The head fallback: each CTA's first max over F, merged (cluster_argmax)."""
    v, f = vals.tolist(), F.tolist()
    masked = [v[n] if f[n] else float("-inf") for n in range(len(v))]
    slices = cta_slices(len(v), C)
    firsts = [cta_top2(masked, lo, hi)[0] for lo, hi in slices]
    return merge_top2([[p, p] for p in firsts], slices)[0][1]


def cluster_candidates(table, us, bounds, B: int, K_EP: int, C: int):
    """The cut, the selection and the CTA compaction: (each node's guarded
    usable count, the list every CTA holds before its sort as (key, node, k)
    in the order it was laid out)."""
    N = len(us)
    slices = cta_slices(N, C)
    tops = [cta_top2(bounds, lo, hi) for lo, hi in slices]
    (b1, i1), (b2, i2) = merge_top2(tops, slices)
    uu = []
    for n in range(N):
        cut_s, cut_i = (b2, i2) if n == i1 else (b1, i1)
        row, k = table[n], 0
        while k < us[n] and (row[k] > cut_s or (row[k] == cut_s and n < cut_i)):
            k += 1
        uu.append(k)
    keys = sorted((entry_key(table[n][k], n, k, B) for n in range(N) for k in range(uu[n])),
                  reverse=True)
    U = len(keys)
    n_cand = min(U, K_EP)
    T = keys[n_cand - 1] if U > K_EP else 0
    counts = []
    for n in range(N):
        c = 0
        while c < uu[n] and entry_key(table[n][c], n, c, B) >= T:
            c += 1
        counts.append(c)
    totals = [sum(counts[lo:hi]) for lo, hi in slices]
    offsets = [sum(totals[:r]) for r in range(C)]  # cluster_offset: the CTAs before, in rank order
    laid = [None] * n_cand
    for r, (lo, hi) in enumerate(slices):
        p = offsets[r]
        for n in range(lo, hi):  # block_exclusive_scan: the slice's nodes in order
            for k in range(counts[n]):
                laid[p] = (entry_key(table[n][k], n, k, B), n, k)
                p += 1
    return uu, laid


def _record(monkeypatch):
    """Spies on the plain version's helpers: while `on[0]`, each call is
    appended to `events` as (name, args, result)."""
    events, on = [], [False]
    for name in ("_zone_sums", "_affinity_usable_bound", "_guarded", "_top_k",
                 "_affinity_round", "_first_head"):
        real = getattr(K, name)

        def spy(*args, _real=real, _name=name):
            res = _real(*args)
            if on[0]:  # the rounds' ep is one dict, updated in place every epoch
                events.append((_name, (args[0], dict(args[1])) if _name == "_affinity_round"
                               else args, res))
            return res

        monkeypatch.setattr(K, name, spy)
    return events, on


def _epochs(monkeypatch) -> list:
    """Every epoch of the plain unsharded affinity wave on the seeded
    segments: (label, N, B, its events)."""
    events, on = _record(monkeypatch)
    out = []
    for label, tb, cry, seg, block, n_zones in RC._segments():
        _, _, m, g, cap1, ss_live = seg[:6]
        events.clear()
        on[0] = True
        K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1), ss_live=bool(ss_live),
                                       block=block, n_zones=n_zones)
        on[0] = False
        out.append((label, int(tb.alloc.shape[0]), block, list(events)))
    return out


@pytest.fixture(scope="module")
def epochs():
    mp = pytest.MonkeyPatch()
    try:
        yield _epochs(mp)
    finally:
        mp.undo()


def _selections(evs: list) -> list:
    """Each multi-pod epoch's selection: (usable_bound's args and result,
    _guarded's result, _top_k's result, the first round's ep, the last
    round's result)."""
    out, cur = [], None
    for name, args, res in evs:
        if name == "_affinity_usable_bound":
            cur = {"ub": (args, res)}
            out.append(cur)
        elif cur is not None and name == "_guarded" and "guard" not in cur:
            cur["guard"] = res
        elif cur is not None and name == "_top_k" and "top" not in cur:
            cur["top"] = res
        elif cur is not None and name == "_affinity_round":
            cur.setdefault("ep", args[1])
            cur["rs"] = res
    return out


@pytest.mark.parametrize("C", SIZES)
def test_cluster_zone_sums_equal_plain(epochs, C):
    """Round 1's zone sums, CTA partials added as integers, are the plain
    epoch's on every SelectorSpread epoch."""
    n = 0
    for label, _, _, evs in epochs:
        for name, args, res in evs:
            if name != "_zone_sums":
                continue
            pernode0, F, zn, Z = args
            assert torch.equal(cluster_zone_sums(pernode0, F, zn, Z, C), res), label
            n += 1
    assert n > 0


def test_cluster_zone_sums_are_integer_sums():
    """The zone sums are exact integer sums rounded once, whatever the CTAs'
    grouping: counts past f32's integers (2^24 and two ones in three CTAs)
    keep both ones, where f32 partials added in rank order would lose them."""
    pn = torch.tensor([2.0 ** 24, 1.0, 1.0, 0.0], dtype=torch.float32)
    F = torch.ones(4, dtype=torch.bool)
    zn = torch.tensor([1, 1, 1, 1])
    for C in (2, 4):
        got = cluster_zone_sums(pn, F, zn, 2, C)
        assert got.tolist() == [0.0, float(2 ** 24 + 2)]


@pytest.mark.parametrize("C", SIZES)
def test_cluster_selection_equals_plain(epochs, C):
    """On every epoch that selected candidates: the per-node usable prefixes
    and bounds, the guard from the merged CTA pairs, the list the CTAs lay
    out (the selected entries in flat order), its sort (lax.top_k's order)
    and the rounds replicated on it are the plain epoch's."""
    n_sel = 0
    for label, N, B, evs in epochs:
        K_EP = min(N * B, K.K_EP_MAX)
        for sel in _selections(evs):
            (table_ext, avail, k_cap, F_hi, _), (usable, bound) = sel["ub"]
            us, bounds = cta_rows(table_ext, avail, k_cap, F_hi, B)
            assert us == usable.sum(dim=1).tolist(), label
            assert bounds == bound.tolist(), label
            table = table_ext[:, :B].tolist()
            uu, laid = cluster_candidates(table, us, bounds, B, K_EP, C)
            guarded = sel["guard"][0]
            assert uu == guarded.sum(dim=1).tolist(), label
            vals, flat = sel["top"]
            n_cand = len(laid)
            assert n_cand == min(int(guarded.sum()), K_EP), label
            want = [int(p) for p in flat[:n_cand].tolist()]
            assert [n * B + k for _, n, k in laid] == sorted(want), label  # node order
            srt = sorted(laid, reverse=True)  # the CTAs' bitonic sort, keys desc
            assert [n * B + k for _, n, k in srt] == want, label
            assert [table[n][k] for _, n, k in srt] == vals[:n_cand].tolist(), label
            if "ep" in sel:
                ep = dict(sel["ep"], N=N)
                want_rs = sel["rs"]
                # the rounds on every CTA: the same list, the same compacted state
                got = RC.compact_rounds(copy.copy(ep))
                assert torch.equal(got["counts"], want_rs["counts"]), label
                assert got["got"] == want_rs["got"] and got["rounds"] == want_rs["rounds"]
                assert torch.equal(got["everb_d"], want_rs["everb_d"]), label
            n_sel += 1
    assert n_sel > 20


@pytest.mark.parametrize("C", SIZES)
def test_cluster_head_equals_plain(epochs, C):
    """The head fallback, each CTA's first max merged on the global node,
    is the plain epoch's pick on every head epoch."""
    n = 0
    for label, _, _, evs in epochs:
        for name, args, res in evs:
            if name == "_first_head":
                assert cluster_head(args[0], args[1], C) == res, label
                n += 1
    assert n > 0


def test_cluster_tail_cases_cross_the_ctas(epochs):
    """The epochs reach what the cluster form must keep: heads and bounds
    whose maximum is held by nodes of different CTAs (a tie broken on a
    local index would move them), and selections whose candidates span
    several CTAs (an offset out of rank order would reorder the list)."""
    head_ties = bound_ties = spans = 0
    for _, N, B, evs in epochs:
        for C in SIZES:
            slices = cta_slices(N, C)
            for name, args, res in evs:
                if name == "_first_head":
                    v, f = args[0].tolist(), args[1].tolist()
                    best = max(v[n] for n in range(N) if f[n]) if any(f) else None
                    owners = {r for r, (lo, hi) in enumerate(slices)
                              for n in range(lo, hi) if f[n] and v[n] == best}
                    head_ties += len(owners) > 1
            for sel in _selections(evs):
                (table_ext, avail, k_cap, F_hi, _), _ = sel["ub"]
                us, bounds = cta_rows(table_ext, avail, k_cap, F_hi, B)
                top = max(bounds)
                owners = {r for r, (lo, hi) in enumerate(slices)
                          for n in range(lo, hi) if bounds[n] == top and top > float("-inf")}
                bound_ties += len(owners) > 1
                _, laid = cluster_candidates(table_ext[:, :B].tolist(), us, bounds, B,
                                             min(N * B, K.K_EP_MAX), C)
                spans += len({r for _, n, _ in laid for r, (lo, hi) in enumerate(slices)
                              if lo <= n < hi}) > 1
    assert head_ties > 0 and bound_ties > 0 and spans > 0
