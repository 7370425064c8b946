"""A CPU model of the cross-CTA steps of K13 and K8 on thread-block clusters
(open_simulator_torch/ops/csrc/group_serial_sharded.cu, the group-serial
scan on a rank's block, and wave_sharded.cu `wave_sharded_tail`, the wave's
epoch selection over the mesh's N nodes), held against the plain versions'
own intermediate values.

Each stage runs on one cluster of C CTAs, CTA r owning the node slice
[r * chunk, (r + 1) * chunk). Where a stage crosses the CTAs it must give
what the one-block form gave:
- K13's DoNotSchedule minima: each CTA the minimum over its share of the
  D+1 domains of the live rows, merged as the maximum of the negations'
  order-preserving keys (okey), after the previous pod's commit;
- K13's partial vector: each CTA's maxima as okey, `any` and `zoned` as
  maxima of 0 / 1, its zone sums as integers (added as integers, rounded
  to f32 once), its ScheduleAnyway marks, merged as a union;
- K13's topology sizes: each CTA counts the marked domains of its share of
  the D domains, the counts add; the raw scores' extrema as okey maxima;
- K13's first max: each CTA's first maximum of the masked score, merged on
  (okey, GLOBAL node);
- K8's tail: each node's usable prefix and first hidden entry, each CTA's
  two best bounds merged with ties on the global node, the guard, the usable
  and guarded counts, the key select over the flat order n * B + k of global
  nodes, the end normalizers, the stop at the first exhausting pick, and the
  head fallback merged on the global node.
The functions below are that arithmetic in plain Python and PyTorch, step
for step as the kernels do it, at every cluster size `choose` gives (1, 2,
4, 8, 16). The kernels cannot run here, so this is the CPU guard of the
designs: pod by pod on the spread cluster's group-serial segments, each step
gives `schedule_group_serial_sharded_plain`'s value (on a one-rank mesh, so
that the block is the node axis; its partial vector and best row through
the collectives, its marks and raw scores through `_sa_raw`, its masked
score through `torch.argmax`), and epoch by epoch on the seeded wave
segments of tests/torch_mesh_cases.py `_round_wave_segments`, each step
gives the plain wave's (`_usable_and_bound`, `_guarded`, `_top_k`,
`_wave_iteration`), whose epochs K8's tail repeats on the gathered rows.

The model carries four named mutations, each a fault the designs must not
have; `test_named_mutation_is_caught` shows that each one makes a check of
this file fail:
- "local_tie": a tie between CTAs broken on a CTA-local index;
- "f32_zone_sums": the zone sums added in f32 in CTA order;
- "stale_minimum": a DoNotSchedule minimum read before the commit;
- "block_flat": the flat index n * B + k over a rank's block of N / 2 nodes,
  not over the global nodes.
"""

import struct

import pytest
import torch

import torch_mesh_cases as MC
from open_simulator_torch.ops import kernels as K
from open_simulator_torch.parallel import collectives
from open_simulator_torch.parallel.mesh import make_node_mesh

SIZES = (1, 2, 4, 8, 16)  # ops/cluster.py SIZES
MUTATIONS = ("local_tie", "f32_zone_sums", "stale_minimum", "block_flat")
INF = float("inf")
BIG = 2 ** 31 - 1  # cluster.cuh INT_HI: no node


def cta_slices(N: int, C: int) -> list:
    """cluster.cuh cluster_setup's cut: CTA r owns [r * chunk, (r + 1) * chunk)."""
    chunk = -(-N // C)
    return [(min(N, r * chunk), min(N, r * chunk + chunk)) for r in range(C)]


def okey_t(x: torch.Tensor) -> torch.Tensor:
    """cluster.cuh okey on an f32 tensor: int keys whose order is the floats'."""
    i = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def ounkey_t(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).to(torch.int32).view(torch.float32)


def okey(v: float) -> int:
    return int(okey_t(torch.tensor([v], dtype=torch.float32))[0])


def entry_key(v: float, n: int, k: int, B: int) -> int:
    """select.cuh entry_key: score desc, then flat index asc (-0 as +0)."""
    u = struct.unpack("<I", struct.pack("<f", 0.0 if v == 0.0 else v))[0]
    ob = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (ob << 32) | (0xFFFFFFFF - (n * B + k))


def first_max_merge(pairs: list, slices: list, local: bool) -> tuple:
    """The merge of the CTAs' first-max pairs (key, node) (cluster_argmax,
    cluster_top2's firsts): the largest key, then the lowest GLOBAL node; a
    CTA-local index with `local` (the mutation)."""
    def idx(r):
        n = pairs[r][1]
        return n - slices[r][0] if local and n < BIG else n

    win = 0
    for r in range(1, len(pairs)):
        if pairs[r][0] > pairs[win][0] or (pairs[r][0] == pairs[win][0] and idx(r) < idx(win)):
            win = r
    return pairs[win], win


def cta_first_max(keys: list, lo: int, hi: int) -> tuple:
    """One CTA's first max (key desc, node asc) over its slice."""
    best = (okey(-INF), BIG)
    for n in range(lo, hi):
        if keys[n] > best[0] or (keys[n] == best[0] and n < best[1]):
            best = (keys[n], n)
    return best


# ------------------------------------------------------------------ K13 ----

def k13_context(tb, cry, g: int, cap1: bool, ss_live: bool, sa_live: bool, n_zones: int) -> dict:
    """The run constants K13's setup hoists (the plain version's, from its
    helpers), and the live rows and counts it starts from."""
    D = cry.counter.shape[1] - 1
    base_feas, _ = K.feasibility(tb, cry, g, -1, True, K.DEFAULT_FILTERS, include_dns=False)
    st = K._wave_statics(tb, cry, g, K.DEFAULT_WEIGHTS)
    capacity = K._base_capacity(tb, cry, g, cap1, base_feas, K.DEFAULT_FILTERS)
    dvalid, dids = K._slot_ids(tb.dns_t[g])
    svalid, sidx = K._slot_ids(tb.sa_t[g])
    sa_dom = tb.counter_dom[sidx].long()
    ss_id = torch.clamp(tb.ss_t[g], min=0).reshape(1).long()
    return dict(
        D=D, Z=max(2, n_zones), ss_live=ss_live, sa_live=sa_live, base_feas=base_feas, st=st,
        capacity=capacity, dvalid=dvalid, dom=tb.counter_dom[dids].long(), edom=tb.dns_edom[g],
        dself=tb.dns_self[g][:, None], dskew=tb.dns_maxskew[g][:, None],
        dmatch=(tb.counter_sel_match_g[dids, g] & dvalid).to(torch.float32),
        svalid=svalid, sa_dom=sa_dom, sa_ign=torch.any(svalid[:, None] & (sa_dom >= D), dim=0),
        sa_match=(tb.counter_sel_match_g[sidx, g] & svalid).to(torch.float32),
        pern0=K.counter_rows_at(tb, cry, ss_id)[1][0], zone=tb.node_zone.long(),
        cnt=cry.counter[dids].clone(), cnt_sa=cry.counter[sidx].clone(),
        j=torch.zeros(tb.alloc.shape[0], dtype=torch.int32))


def k13_commit(cx: dict, row) -> None:
    """gs_commit: the winner's row (score, global node, its DoNotSchedule
    and ScheduleAnyway domains) into the live rows and j, by CTA 0."""
    if row is None or row[0] == -INF:
        return
    Sd = cx["cnt"].shape[0]
    dd = torch.tensor([int(x) for x in row[2:2 + Sd]], dtype=torch.long)
    cx["cnt"][torch.arange(Sd), dd] += cx["dmatch"]
    if cx["sa_live"]:
        sd = torch.tensor([int(x) for x in row[2 + Sd:]], dtype=torch.long)
        cx["cnt_sa"][torch.arange(sd.shape[0]), sd] += cx["sa_match"] * (sd < cx["D"])
    cx["j"][int(row[1])] += 1


def k13_minima(cx: dict, C: int) -> torch.Tensor:
    """The front's DoNotSchedule minima: each CTA's minimum over its share
    of the D+1 domains, merged as the max of okey(-min); 0 where none."""
    cnt, edom = cx["cnt"], cx["edom"]
    merged = torch.full((cnt.shape[0],), okey(-INF), dtype=torch.int64)
    for d0, d1 in cta_slices(cnt.shape[1], C):
        if d1 > d0:
            m = torch.amin(torch.where(edom[:, d0:d1], cnt[:, d0:d1], INF), dim=1)
            merged = torch.maximum(merged, okey_t(-m))
    mn = -ounkey_t(merged)
    return torch.where(torch.isfinite(mn), mn, 0.0)


def k13_front(cx: dict, prev_row, C: int, mutation=None):
    """The front of one pod on C CTAs: the commit, the minima, the live
    filter and the partial vector. Returns (F, the vector)."""
    if mutation == "stale_minimum":
        mins = k13_minima(cx, C)
        k13_commit(cx, prev_row)
    else:
        k13_commit(cx, prev_row)
        mins = k13_minima(cx, C)
    j, st = cx["j"], cx["st"]
    at = torch.gather(cx["cnt"], 1, cx["dom"])
    ok = (cx["dom"] < cx["D"]) & (at + cx["dself"] - mins[:, None] <= cx["dskew"])
    F = cx["base_feas"] & (cx["capacity"] - j > 0) & torch.all(ok | ~cx["dvalid"][:, None], dim=0)
    N = F.shape[0]
    pern = cx["pern0"] + j.to(torch.float32)
    heads = torch.stack([st["simon_s"], st["na_raw"], st["t_raw"], st["ip_raw"], pern,
                         -st["simon_s"], -st["ip_raw"]])
    keys = okey_t(torch.where(F[None, :], heads, -INF))
    zoned = F & (cx["zone"] > 0)
    head = torch.full((7,), okey(-INF), dtype=torch.int64)
    flags = [0, 0]
    Z = cx["Z"]
    zs_int = torch.zeros(Z, dtype=torch.int64)
    zs_f32 = torch.zeros(Z, dtype=torch.float32)
    relF = F & ~cx["sa_ign"]
    marks = torch.zeros_like(cx["cnt_sa"])
    for lo, hi in cta_slices(N, C):
        if hi == lo:
            continue
        head = torch.maximum(head, keys[:, lo:hi].amax(dim=1))
        flags = [max(flags[0], int(F[lo:hi].any())), max(flags[1], int(zoned[lo:hi].any()))]
        if cx["ss_live"]:
            part = torch.where(F[lo:hi], pern[lo:hi], 0.0)
            zs_int += torch.zeros(Z, dtype=torch.int64).index_add_(
                0, cx["zone"][lo:hi], part.to(torch.int64))  # integer atomics
            zs_f32 = zs_f32 + torch.zeros(Z, dtype=torch.float32).index_add_(
                0, cx["zone"][lo:hi], part)
        mine = torch.zeros_like(marks)
        for k in torch.nonzero(cx["svalid"]).flatten().tolist():
            mine[k, cx["sa_dom"][k, lo:hi][relF[lo:hi]]] = 1.0
        marks = torch.maximum(marks, mine)  # the union of the CTAs' stores of 1.0
    vec = [ounkey_t(head), torch.tensor(flags, dtype=torch.float32)]
    if cx["ss_live"]:
        vec.append(zs_f32 if mutation == "f32_zone_sums" else zs_int.to(torch.float32))
    if cx["sa_live"]:
        vec.append(marks.reshape(-1))
    return F, torch.cat(vec)


def k13_sa(cx: dict, marks: torch.Tensor, C: int) -> list:
    """The sa stage's topology sizes: each CTA counts the marked domains of
    its share of the D domains (the sentinel excluded), the counts add."""
    D = cx["D"]
    sizes = [0] * marks.shape[0]
    for d0, d1 in cta_slices(D, C):
        for k in range(marks.shape[0]):
            sizes[k] += int((marks[k, d0:d1] != 0).sum())
    return sizes


def k13_extrema(raw: torch.Tensor, relF: torch.Tensor, C: int) -> torch.Tensor:
    """The raw scores' max and negated min over the relevant nodes, each
    CTA's as okey, merged by max."""
    keys = okey_t(torch.stack([torch.where(relF, raw, -INF), torch.where(relF, -raw, -INF)]))
    out = torch.full((2,), okey(-INF), dtype=torch.int64)
    for lo, hi in cta_slices(raw.shape[0], C):
        if hi > lo:
            out = torch.maximum(out, keys[:, lo:hi].amax(dim=1))
    return ounkey_t(out)


def k13_argmax(masked: torch.Tensor, C: int, local: bool = False) -> int:
    """The score stage's first max: each CTA's (okey score, global node)
    first max, merged by cluster_argmax; BIG where no node is feasible."""
    keys = okey_t(masked).tolist()
    slices = cta_slices(len(keys), C)
    pairs = [cta_first_max(keys, lo, hi) for lo, hi in slices]
    (key, n), _ = first_max_merge(pairs, slices, local)
    return n if key > okey(-INF) else BIG


def _spy(monkeypatch, obj, name: str, events: list, on: list, real=None) -> None:
    """Record each call of obj.name while on[0] as (name, args, result),
    running `real` in its place where given."""
    real = real or getattr(obj, name)

    def spy(*args, **kw):
        res = real(*args, **kw)
        if on[0]:
            events.append((name, args, res))
        return res

    monkeypatch.setattr(obj, name, spy)


def _k13_runs(monkeypatch) -> list:
    """Every group-serial segment of the spread cluster's first 600 pods
    (tests/torch_mesh_cases.py `spread_workload`, 64 and 16 zoned nodes), each run
    from the seed carry by the plain sharded scan on a one-rank mesh:
    (label, the run's arguments, its per-pod records)."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.engine import Simulator

    events, on = [], [False]
    for name in ("all_gather_rows", "pmax"):  # one rank: every rank's rows are its own
        _spy(monkeypatch, collectives, name, events, on, real=lambda t, mesh: t.clone())
    _spy(monkeypatch, K, "_sa_raw", events, on)
    _spy(monkeypatch, torch, "argmax", events, on)
    mesh = make_node_mesh(device="cpu")
    out = []
    for n_nodes in (64, 16):  # 16 nodes: the hostname minimum rises within a segment
        nodes, pods, services = MC.spread_workload(n_nodes=n_nodes)
        sim = Simulator(nodes, device="cpu", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services)))
        bt = sim.encode_batch(pods)
        tb, cry = sim._to_device(bt)
        for seg in sim._segments(bt, len(pods)):
            if seg[0] != "spread":
                continue
            _, _, m, g, cap1, ss, sa = seg[:7]
            n_zones = bt.n_zones if ss else 2
            args = (tb, cry, g, bool(cap1), bool(ss), bool(sa), n_zones)
            events.clear()
            on[0] = True
            j, placed = K.schedule_group_serial_sharded_plain(
                tb, cry, g, MC._seg_valid(m), bool(cap1), mesh, ss_live=bool(ss),
                sa_live=bool(sa), n_zones=n_zones)
            on[0] = False
            pods_ = []
            for name, a, res in events:
                if name == "all_gather_rows" and (not pods_ or "row" in pods_[-1]):
                    pods_.append({"vec": res[0].clone()})
                elif name == "all_gather_rows":
                    pods_[-1]["row"] = res[0].tolist()
                elif name == "pmax":
                    pods_[-1]["sa_red"] = a[0].clone()
                elif name == "_sa_raw":
                    pods_[-1]["marks"], pods_[-1]["raw"] = a[1].clone(), res.clone()
                elif name == "argmax" and pods_ and "row" not in pods_[-1]:
                    pods_[-1]["masked"] = a[0].clone()
            assert len(pods_) == m and all("row" in p and "masked" in p for p in pods_)
            label = "sa_live" if sa else "ss_live" if ss else "dns"
            out.append((label, args, pods_, (j, placed)))
    return out


@pytest.fixture(scope="module")
def k13_runs():
    mp = pytest.MonkeyPatch()
    try:
        yield _k13_runs(mp)
    finally:
        mp.undo()


def k13_mismatches(runs: list, C: int, mutation=None) -> list:
    """Replays every run's pods through the model on C CTAs and lists every
    step whose value differs from the plain version's."""
    bad = []
    for label, args, pods, (j, placed) in runs:
        cx = k13_context(*args)
        prev = None
        for p, rec in enumerate(pods):
            where = f"{label} pod {p} C {C}"
            F, vec = k13_front(cx, prev, C, mutation)
            want_F = torch.isfinite(rec["masked"])
            if not torch.equal(F, want_F):
                bad.append(f"{where}: the feasible set")
            want = rec["vec"]
            head = want[:K.GS_HEAD]
            if not torch.equal(vec[:K.GS_HEAD].view(torch.int32), head.view(torch.int32)):
                bad.append(f"{where}: the partial vector's head")
            if cx["ss_live"]:
                Z = cx["Z"]
                if not torch.equal(vec[K.GS_HEAD:K.GS_HEAD + Z], want[K.GS_HEAD:K.GS_HEAD + Z]):
                    bad.append(f"{where}: the zone sums")
            if cx["sa_live"]:
                o = K.GS_HEAD + (cx["Z"] if cx["ss_live"] else 0)
                Ss, D1 = cx["cnt_sa"].shape
                sv = cx["svalid"]
                got_m, want_m = vec[o:].view(Ss, D1), want[o:].view(Ss, D1)
                if not torch.equal(got_m[sv], want_m[sv]):
                    bad.append(f"{where}: the marks")
                sizes = k13_sa(cx, want_m, C)
                want_sizes = torch.sum(rec["marks"][:, :cx["D"]], dim=1).to(torch.int64).tolist()
                if [s for s, v in zip(sizes, sv.tolist()) if v] != \
                        [s for s, v in zip(want_sizes, sv.tolist()) if v]:
                    bad.append(f"{where}: the topology sizes")
                ext = k13_extrema(rec["raw"], F & ~cx["sa_ign"], C)
                if not torch.equal(ext.view(torch.int32), rec["sa_red"].view(torch.int32)):
                    bad.append(f"{where}: the raw scores' extrema")
            c = k13_argmax(rec["masked"], C, mutation == "local_tie")
            row = rec["row"]
            if row[0] == -INF:
                if c != BIG:
                    bad.append(f"{where}: a winner where the plain finds none")
            elif c != int(torch.argmax(rec["masked"])) or c != int(row[1]):
                bad.append(f"{where}: the first max {c}, the plain's {int(row[1])}")
            prev = row
        k13_commit(cx, prev)  # the finish launch
        if not torch.equal(cx["j"], j) or int(cx["j"].sum()) != placed:
            bad.append(f"{label} C {C}: the counts after the finish")
    return bad


@pytest.mark.parametrize("C", SIZES)
def test_group_serial_cluster_steps_equal_plain(k13_runs, C):
    """Pod by pod on the spread cluster's ScheduleAnyway, SelectorSpread and
    DoNotSchedule segments: the commit and the split minima give the plain
    scan's feasible set, the CTAs' partial vectors merged give its vector
    bit for bit (okey maxima, integer zone sums, the marks' union), the
    split domain counts its topology sizes, the CTAs' extrema its pmax
    input, and the merged first max its winner; the counts after the
    finish are its counts."""
    assert {label for label, *_ in k13_runs} == {"sa_live", "ss_live", "dns"}
    assert sum(len(pods) for _, _, pods, _ in k13_runs) > 100
    assert k13_mismatches(k13_runs, C) == []


def test_group_serial_cases_cross_the_ctas(k13_runs):
    """The pods reach what the cluster form must keep: first maxima held by
    nodes of several CTAs (a tie broken on a local index would move them)
    and DoNotSchedule minima that a commit raises (a minimum read before the
    commit would let a node through)."""
    ties = rises = 0
    for label, args, pods, _ in k13_runs:
        chunk = -(-int(args[0].alloc.shape[0]) // 16)  # C 16
        for rec in pods:
            m = rec["masked"]
            top = torch.amax(m)
            if torch.isfinite(top):
                holders = torch.nonzero(m == top).flatten().tolist()
                ties += len({n // chunk for n in holders}) > 1
        if label == "dns":
            cx = k13_context(*args)
            for rec in pods:
                before = k13_minima(cx, 1)
                k13_commit(cx, rec["row"])
                rises += not torch.equal(before, k13_minima(cx, 1))
    assert ties > 0 and rises > 0


def k13_zone_sums(pern: list, C: int, mutation=None) -> float:
    """The front's zone sum of one zone: each CTA's integer partial over its
    slice, added as integers and rounded to f32 once (f32 partials added in
    CTA order with the mutation)."""
    t = torch.tensor(pern, dtype=torch.float32)
    total_i, total_f = 0, torch.zeros((), dtype=torch.float32)
    for lo, hi in cta_slices(len(pern), C):
        total_i += int(t[lo:hi].to(torch.int64).sum())
        total_f = total_f + t[lo:hi].sum()
    return float(total_f) if mutation == "f32_zone_sums" else float(torch.tensor(
        float(total_i), dtype=torch.float32))


def test_group_serial_zone_sums_are_integer_sums():
    """The zone sums are exact integer sums rounded once, whatever the CTAs'
    grouping: counts past f32's integers (2^24 and two ones in two CTAs)
    keep both ones, where f32 partials added in CTA order would lose them."""
    pern = [2.0 ** 24, 1.0, 1.0, 0.0]
    for C in (2, 4):
        assert k13_zone_sums(pern, C) == float(2 ** 24 + 2)


# ------------------------------------------------------------------- K8 ----

def k8_tail(it: dict, C: int, mutation=None) -> dict:
    """K8's tail on C CTAs over one epoch's gathered rows (`it`: the plain
    iteration's arguments): every step's value."""
    table_ext, F, avail, st, norms = it["table_ext"], it["F"], it["avail"], it["st"], it["norms"]
    B, K_, placed, m = it["B"], it["K"], it["placed"], it["m"]
    N, B1 = table_ext.shape[0], B + 1
    rows, f = table_ext.tolist(), F.tolist()
    av = torch.clamp(avail, max=B1).tolist()  # the payload's min(avail, B+1)
    NL = N // 2
    local = mutation == "local_tie"

    def flat(n):
        return n % NL if mutation == "block_flat" else n

    slices = cta_slices(N, C)
    # ---- each node's usable prefix and first hidden entry
    u, bound = [], []
    for n in range(N):
        first_bad, prev = B, 0.0
        for k in range(B1):
            if 0 < k < B and first_bad == B and rows[n][k] > prev:
                first_bad = k
            prev = rows[n][k]
        u.append(min(av[n], first_bad) if f[n] else 0)
        bound.append(rows[n][first_bad] if f[n] and first_bad < av[n] else -INF)
    # ---- each CTA's two best bounds (top2_update), merged (cluster_top2)
    tops = []
    for lo, hi in slices:
        b = [(-INF, BIG), (-INF, BIG)]
        for n in range(lo, hi):
            p = (bound[n], n)
            if p[0] > b[0][0] or (p[0] == b[0][0] and n < b[0][1]):
                b = [p, b[0]]
            elif p[0] > b[1][0] or (p[0] == b[1][0] and n < b[1][1]):
                b[1] = p
        tops.append(b)
    first, win = first_max_merge([t[0] for t in tops], slices, local)
    others = [tops[r][0] for r in range(C) if r != win] + [tops[win][1]]
    olos = [slices[r][0] for r in range(C) if r != win] + [slices[win][0]]
    second, _ = first_max_merge(others, [(lo, 0) for lo in olos], local)
    (b1, i1), (b2, i2) = first, second
    # ---- the guard
    uu, gsum = [], 0
    for n in range(N):
        cut_s, cut_i = (b2, i2) if n == i1 else (b1, i1)
        k = 0
        while k < u[n] and (rows[n][k] > cut_s or (rows[n][k] == cut_s and n < cut_i)):
            k += 1
        uu.append(k)
        gsum += u[n] - k
    keys = {n: [entry_key(rows[n][k], flat(n), k, B) for k in range(uu[n])] for n in range(N)}
    allk = sorted((x for n in range(N) for x in keys[n]), reverse=True)
    U = len(allk)
    m_rem = m - placed
    m_cand = min(m_rem, K_, U)
    take_all = 0 < m_cand == U
    T = allk[m_cand - 1] if m_cand > 0 and not take_all else 0

    def at_least(n, x):
        return sum(1 for y in keys[n] if y >= x)

    c0 = [uu[n] if take_all else (at_least(n, T) if m_cand > 0 else 0) for n in range(N)]
    # ---- the end normalizers and the best exhausting key
    ms = st["max_stack"].tolist()
    e_mx, e_simon, e_ip, ex_best = [-INF] * 4, INF, INF, 0
    for n in range(N):
        if f[n] and c0[n] < max(av[n], 1):
            e_mx = [max(e_mx[r], ms[r][n]) for r in range(4)]
            e_simon, e_ip = min(e_simon, ms[0][n]), min(e_ip, ms[3][n])
        if m_cand > 0 and av[n] >= 1 and uu[n] == av[n]:
            kx = entry_key(rows[n][av[n] - 1], flat(n), av[n] - 1, B)
            if kx >= T and kx > ex_best:
                ex_best = kx
    nm = [float(x) for x in norms]
    same = (e_mx[0] == nm[0] and e_simon == nm[1] and max(e_mx[1], 0.0) == nm[2]
            and max(e_mx[2], 0.0) == nm[3] and max(e_mx[3], 0.0) == nm[4]
            and min(e_ip, 0.0) == nm[5])
    m_take, cut = m_cand, 0
    if not same and ex_best:
        above = 0 if allk and ex_best == allk[0] else sum(1 for x in allk if x > ex_best)
        if above + 1 < m_cand:
            m_take, cut = above + 1, ex_best
    # ---- the head fallback
    head = -1
    if m_take == 0 and any(f) and m_rem > 0:
        hk = okey_t(torch.where(F, table_ext[:, 0], -INF)).tolist()
        pairs = [cta_first_max(hk, lo, hi) for lo, hi in slices]
        head = first_max_merge(pairs, slices, local)[0][1]
        m_take = 1
    counts = [(1 if n == head else 0) if head >= 0 else (at_least(n, cut) if cut else c0[n])
              for n in range(N)]
    return dict(u=u, bound=bound, top2=(b1, i1, b2, i2), uu=uu, guarded=gsum, m_cand=m_cand,
                c0=c0, m_take=m_take, head=head, counts=counts)


def _k8_epochs(monkeypatch) -> list:
    """Every epoch of the plain unsharded wave (whose epochs K8's tail
    repeats on the gathered rows) on the seeded wave segments of
    tests/torch_mesh_cases.py `_round_wave_segments` and their variants
    (table depth, kmax, fit off): (label, the iteration's arguments, its
    helpers' values, its result)."""
    events, on = [], [False]
    for name in ("_usable_and_bound", "_guarded", "_top_k", "_wave_iteration"):
        _spy(monkeypatch, K, name, events, on)
    out = []
    for label, tb, cry, m, g, cap1, gpu_live, variants in MC._round_wave_segments("cpu"):
        for filters, block, kmax in variants:
            events.clear()
            on[0] = True
            K.schedule_wave_plain(tb, cry, g, m, cap1, filters=filters, block=block, kmax=kmax,
                                  gpu_live=gpu_live)
            on[0] = False
            cur = {}
            for name, args, res in events:
                if name != "_wave_iteration":
                    cur.setdefault(name, (args, res))
                    continue
                st, norms, table_ext, F, avail, j, placed, m_, B, K_ = args
                it = dict(st=st, norms=norms, table_ext=table_ext, F=F, avail=avail, j=j,
                          placed=placed, m=m_, B=B, K=K_)
                out.append((f"{label} g{g} B{block} K{kmax}", it, cur, res))
                cur = {}
    return out


@pytest.fixture(scope="module")
def k8_epochs():
    mp = pytest.MonkeyPatch()
    try:
        yield _k8_epochs(mp)
    finally:
        mp.undo()


def k8_mismatches(epochs: list, C: int, mutation=None) -> list:
    """Every epoch through the model on C CTAs; lists every step whose value
    differs from the plain wave's."""
    bad = []
    for e, (label, it, helpers, res) in enumerate(epochs):
        where = f"{label} epoch {e} C {C}"
        got = k8_tail(it, C, mutation)
        (_, _, usable, bound) = helpers["_usable_and_bound"][1]
        if got["u"] != usable.sum(dim=1).tolist() or got["bound"] != bound.tolist():
            bad.append(f"{where}: the usable prefixes or bounds")
        # the plain cut's pairs (_wave_candidates_from); a node index rides
        # only with a finite bound (an -inf cut admits every entry)
        b = torch.tensor(got["bound"])
        i1 = int(torch.argmax(b))
        b_2 = b.clone()
        b_2[i1] = -INF
        i2 = int(torch.argmax(b_2))
        b1, gi1, b2, gi2 = got["top2"]
        if (b1, b2) != (float(b[i1]), float(b_2[i2])) or (b1 > -INF and gi1 != i1) \
                or (b2 > -INF and gi2 != i2):
            bad.append(f"{where}: the two largest bounds")
        guarded_mask, guarded = helpers["_guarded"][1]
        if got["uu"] != guarded_mask.sum(dim=1).tolist() or got["guarded"] != guarded:
            bad.append(f"{where}: the guard")
        _, pos = helpers["_top_k"][1]
        N, B = it["table_ext"].shape[0], it["B"]
        want_c0 = torch.zeros(N, dtype=torch.int64).index_add_(
            0, pos[:got["m_cand"]] // B, torch.ones(got["m_cand"], dtype=torch.int64))
        if got["c0"] != want_c0.tolist():
            bad.append(f"{where}: the selected entries")
        j_new, _, m_take, stats = res
        if got["counts"] != (j_new - it["j"]).tolist() or got["m_take"] != m_take \
                or (got["head"] >= 0) != bool(stats["head_fallbacks"]):
            bad.append(f"{where}: the epoch's take")
    return bad


@pytest.mark.parametrize("C", SIZES)
def test_wave_tail_cluster_steps_equal_plain(k8_epochs, C):
    """Epoch by epoch on the seeded wave segments: each node's usable prefix
    and first hidden entry, the CTAs' two best bounds merged on the global
    node, the guard, the key select over the global flat order, the end
    normalizers, the stop at the first exhausting pick and the head
    fallback give the plain wave's values and its take."""
    assert len(k8_epochs) > 20
    assert k8_mismatches(k8_epochs, C) == []


def test_wave_tail_cases_cross_the_ctas(k8_epochs):
    """The epochs reach what the cluster form must keep: the guard deferring
    entries, head fallbacks, a selection that cuts through the usable
    entries (the radix select runs), and bounds or heads whose maximum is
    held by nodes of different CTAs."""
    guarded = heads = cuts = ties = 0
    for _, it, helpers, res in k8_epochs:
        guarded += res[3]["guarded"] > 0
        heads += res[3]["head_fallbacks"]
        got = k8_tail(it, 16)
        cuts += 0 < got["m_cand"] < sum(got["uu"])
        b = torch.tensor(got["bound"])
        top = torch.amax(b)
        if torch.isfinite(top):
            N = b.shape[0]
            chunk = -(-N // 16)
            ties += len({n // chunk for n in torch.nonzero(b == top).flatten().tolist()}) > 1
    assert guarded > 0 and heads > 0 and cuts > 0 and ties > 0


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_named_mutation_is_caught(k13_runs, k8_epochs, mutation):
    """Each named fault, put into the model, makes a check of this file
    fail at some cluster size (the checks above pass without it)."""
    if mutation == "f32_zone_sums":
        assert any(k13_zone_sums([2.0 ** 24, 1.0, 1.0, 0.0], C, mutation) != float(2 ** 24 + 2)
                   for C in (2, 4))
        return
    found = []
    for C in SIZES[1:]:
        if mutation in ("local_tie", "stale_minimum"):
            found += k13_mismatches(k13_runs, C, mutation)
        if mutation in ("local_tie", "block_flat"):
            found += k8_mismatches(k8_epochs, C, mutation)
    assert found, f"the mutation {mutation!r} went unnoticed"
