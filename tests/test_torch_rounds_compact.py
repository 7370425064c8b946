"""A CPU model of K11's round bookkeeping on the compacted domain state
(open_simulator_torch/ops/csrc/affinity_rounds.cu `affinity_rounds_compact`),
held against the unchanged plain rounds.

K11's merge walks, in each round, only the distinct domains of the epoch's
candidates; every other eligible domain enters the round's minimum as one
fixed value (smin), its level histogram as a histogram of its counts above
smin shifted by smin - min_c, the rise scan as "at the minimum, never
reached" exactly when smin == min_c, and its sandwich bit once after the
rounds, from the first round's minimum and whether any round took the
multi-level path. `compact_rounds` below is that bookkeeping in plain
PyTorch, step for step as the kernel does it. The kernel itself cannot run
here, so this is the CPU guard of the design's exactness: on every epoch of
the sharded tail's seeded clusters (tests/torch_mesh_cases.py
`_tail_segments`), run by the unsharded plain affinity wave, whose `epoch`
and the sharded tail's `epoch_rounds` share one `run_rounds` (ops/kernels.py
`_affinity_round`), the model gives the plain rounds' counts, taken pods,
sandwich bits (`everb_d`) and productive rounds.
"""

import copy

import pytest
import torch

import torch_mesh_cases as C
from open_simulator_torch.ops import kernels as K

LMAX = K.LMAX


def _budget_q(ep, cnow, min_c, d):
    """The per-domain budget of a round (plain _affinity_round's q)."""
    if d == ep["D"] or not ep["has_budget"]:
        return float("inf")
    if ep["dns_live"]:
        return float(torch.clamp(ep["skew_live"] - ep["self_live"] + min_c - cnow + 1.0,
                                 min=0.0))
    return 0.0 if float(cnow) > 0 else 1.0


def compact_rounds(ep: dict) -> dict:
    """The rounds of one epoch on the compacted state (see the module's
    docstring), from the plain epoch's inputs `ep`: the same outputs as
    the plain `run_rounds` (counts [N], got, rounds, everb_d [D+1])."""
    f32 = torch.float32
    D, INF_P, m_rem = ep["D"], ep["INF_P"], ep["m_rem"]
    cand, pos_k = ep["cand"], ep["pos_k"]
    dom, node, occ = ep["dom_srt"].long(), ep["idx_srt"].long(), ep["occ_all"]
    cl, edom, inc = ep["cnt_live"], ep["edom_live"], ep["inc_live"]
    N = ep["N"]
    P = int(cand.sum())  # the candidates are a prefix of the positions
    assert bool(cand[:P].all()) and not bool(cand[P:].any())
    # compact indices: the candidates' distinct domains in ascending order
    cdom = sorted(set(dom[:P].tolist()))
    ci = torch.tensor([cdom.index(d) for d in dom[:P].tolist()], dtype=torch.long)
    nd = len(cdom)
    mark = torch.zeros(D + 1, dtype=torch.bool)
    mark[cdom] = True
    static = edom & ~mark
    smin = torch.amin(cl[static]) if bool(static.any()) else torch.tensor(float("inf"))
    h0 = torch.zeros(LMAX + 2, dtype=torch.long)
    if torch.isfinite(smin):
        for v in cl[static].tolist():
            h0[int(min(v - float(smin), LMAX + 1))] += 1
    c_cl = cl[cdom].clone()
    c_edom = edom[cdom].clone()
    c_taken = torch.zeros(nd, dtype=f32)
    c_everb = torch.zeros(nd, dtype=torch.bool)
    counts = torch.zeros(N, dtype=torch.int32)
    got, rounds, last, ran, any_full = 0, 0, 1, False, False
    min_c1 = None
    while last > 0 and got < m_rem:
        for _ in range(4):
            m_left = m_rem - got
            cnow_c = c_cl + c_taken * inc
            mn = torch.amin(torch.where(c_edom, cnow_c, float("inf"))) if nd else smin
            mn = torch.minimum(mn, smin)
            min_c = mn if torch.isfinite(mn) else torch.tensor(0.0)
            if not ran:
                min_c1 = min_c
            ran = True
            # the level histogram: candidates' eligible domains, then the
            # fixed histogram shifted by smin - min_c
            hist = torch.zeros(LMAX + 2, dtype=torch.long)
            for i in range(nd):
                if bool(c_edom[i]):
                    delta = float(cnow_c[i] - min_c)
                    hist[int(min(max(delta, 0.0), LMAX + 1))] += 1
            if torch.isfinite(smin):
                for k in range(LMAX + 2):
                    if h0[k]:
                        hist[int(min(k + float(smin - min_c), LMAX + 1))] += h0[k]
            # per-position budgets
            q_c = [_budget_q(ep, cnow_c[i], min_c, cdom[i]) for i in range(nd)]
            prise = [-1] * (LMAX + 2)
            prov = [0] * (LMAX + 2)
            first = [INF_P] * nd
            rem, cons, l_e = [False] * P, [False] * P, [1.0] * P
            for p in range(P):
                x = int(ci[p])
                qe = q_c[x]
                r_e = float(occ[p] - c_taken[x])
                rem[p] = r_e >= 0.0
                cons[p] = rem[p] and r_e < qe
                l_e[p] = max(1.0, r_e - qe + 2.0)
                lc = float(cnow_c[x]) + r_e + 1.0 - float(min_c)
                if rem[p] and bool(c_edom[x]) and 1.0 <= lc <= LMAX:
                    li = int(min(max(lc, 0.0), LMAX + 1))
                    prise[li] = max(prise[li], p)
                    prov[li] += 1
                if cons[p]:
                    first[x] = min(first[x], p)
            # the multi-level take
            needed, L_used, P_L = int(hist[0]), 0, prise[0]
            for lvl in range(1, LMAX + 1):
                if prov[lvl] != needed:
                    break
                needed += int(hist[lvl])
                P_L = max(P_L, prise[lvl])
                L_used = lvl
            tf = [rem[p] and l_e[p] <= L_used and p <= P_L for p in range(P)]
            n_full = sum(tf)
            use_full = ep["dns_live"] and L_used >= 1 and 0 < n_full <= m_left
            # the single rise: eligible domains at the minimum
            rise, unreached, at_min = -1, False, False
            if ep["dns_live"]:
                for i in range(nd):
                    if bool(c_edom[i]) and bool(cnow_c[i] == min_c):
                        at_min = True
                        if first[i] >= INF_P:
                            unreached = True
                        else:
                            rise = max(rise, first[i])
                if bool(smin == min_c):  # a domain without candidates: never reached
                    at_min = unreached = True
            p_rise = rise if at_min and not unreached else INF_P
            take_pre = [cons[p] and p <= p_rise for p in range(P)]
            rank, take_one = 0, [False] * P
            for p in range(P):
                rank += take_pre[p]
                take_one[p] = take_pre[p] and rank <= m_left
            n_take = n_full if use_full else min(m_left, sum(take_pre))
            take = tf if use_full else take_one
            consumed = torch.zeros(nd, dtype=f32)
            for p in range(P):
                if take[p]:
                    counts[node[p]] += 1
                    consumed[ci[p]] += 1.0
            # the candidates' domains' sandwich bits and consumption
            for i in range(nd):
                qd, cd = q_c[i], float(consumed[i])
                blocked = (qd < 1.0 or (cd >= qd and qd != float("inf"))
                           or (use_full and (bool(c_edom[i]) or cd > 0.0)))
                if blocked and ep["has_budget"]:
                    c_everb[i] = True
                if cdom[i] < D:
                    c_taken[i] = c_taken[i] + consumed[i]
            any_full = any_full or use_full
            got += n_take
            last = n_take
            rounds += int(n_take > 0)
    # every domain's sandwich bit
    everb = torch.zeros(D + 1, dtype=torch.bool)
    for d in range(D + 1):
        if bool(mark[d]):
            everb[d] = c_everb[cdom.index(d)]
        elif ep["has_budget"] and ran:
            cnow = cl[d] + torch.tensor(0.0) * inc
            everb[d] = _budget_q(ep, cnow, min_c1, d) < 1.0 or (any_full and bool(edom[d]))
    return {"counts": counts, "got": got, "rounds": rounds, "everb_d": everb}


def static_domain_workloads():
    """Spreads whose eligible domains include some that hold no candidate,
    the part the compaction keeps aside, with counts above the open
    domains', so that the fixed minimum is reached after rounds of rises: a
    zone DoNotSchedule spread (maxSkew 3) over six zones whose last two are
    cordoned and already hold one and two of its pods (a multi-level round
    marks the first, then it holds the minimum, never reached, while the
    open zones take their budgets), and a hostname spread over 64
    nodes, a quarter of them cordoned and holding two of its pods each.
    Yields (label, nodes, bound pods, pods)."""
    zones = [C.make_node(f"c{i}", cpu="16", memory="32Gi", labels={C.ZONE: f"z{i % 6}"},
                         unschedulable=i % 6 >= 4) for i in range(48)]
    bound = [C.make_pod(f"cb-{i}", cpu="100m", memory="64Mi", labels={"app": "cz"},
                        node_name="c4" if i < 1 else "c5") for i in range(3)]
    pods = [C._spread(C.make_pod(f"cz-{i}", cpu="100m", memory="64Mi", labels={"app": "cz"}),
                      "cz", C.ZONE, 3) for i in range(60)]
    yield "cordoned_zones", zones, bound, pods
    hosts = [C.make_node(f"h{i}", cpu="8", memory="16Gi", pods="8", unschedulable=i % 4 == 3)
             for i in range(64)]
    bound = [C.make_pod(f"hb-{i}", cpu="100m", memory="64Mi", labels={"app": "ch"},
                        node_name=f"h{4 * (i // 2) + 3}") for i in range(32)]
    pods = [C._spread(C.make_pod(f"ch-{i}", cpu="100m", memory="64Mi", labels={"app": "ch"}),
                      "ch", C.HOST, 1) for i in range(150)]
    yield "cordoned_hosts", hosts, bound, pods


def _segments():
    """`_tail_segments`' affinity segments, then those of
    `static_domain_workloads`, chained from the seed carry the same way:
    (label, tables, carry, segment, block, n_zones)."""
    from open_simulator_torch.simulator.engine import Simulator

    for label, _, tb, cry, seg, block, n_zones in C._tail_segments("cpu"):
        yield label, tb, cry, seg, block, n_zones
    for label, nodes, bound, pods in static_domain_workloads():
        sim = Simulator(copy.deepcopy(nodes), device="cpu", use_mesh=False)
        sim.schedule_pods(copy.deepcopy(bound))
        bt = sim.encode_batch(copy.deepcopy(pods))
        tb, cry = sim._to_device(bt)
        for seg in sim._segments(bt, len(pods)):
            kind, _, m, g, cap1 = seg[:5]
            assert kind == "affinity"
            block = K.wave_block_for(m, sim.na.N)
            n_zones = bt.n_zones if seg[5] else 2
            yield label, tb, cry, seg, block, n_zones
            j = K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1), ss_live=bool(seg[5]),
                                               block=block, n_zones=n_zones)[0]
            cry = K.aggregate_commit(tb, cry, g, j)


def _epochs(monkeypatch):
    """Every epoch of the plain unsharded affinity wave on `_segments` that
    ran the rounds: (cluster, D+1, N, the epoch's inputs, the plain rounds'
    result, whether the epoch fell back to the head after rounds that took
    pods, i.e. the sandwich rejected them)."""
    out = []
    real_round, real_state = K._affinity_round, K.AffinityWaveState
    calls, states = {}, []

    def spy_round(rs, ep):
        key = id(ep["cand"])
        if key not in calls:
            calls[key] = {"ep": dict(ep), "epoch": len(states)}
        calls[key]["rs"] = res = real_round(rs, ep)
        return res

    def spy_state(*args, **kw):
        st = real_state(*args, **kw)
        states.append(st.ep_stats)
        return st

    monkeypatch.setattr(K, "_affinity_round", spy_round)
    monkeypatch.setattr(K, "AffinityWaveState", spy_state)
    for label, tb, cry, seg, block, n_zones in _segments():
        _, _, m, g, cap1, ss_live = seg[:6]
        calls.clear()
        states.clear()
        K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1), ss_live=bool(ss_live),
                                       block=block, n_zones=n_zones)
        N, D1 = int(tb.alloc.shape[0]), int(cry.counter.shape[1])
        for rec in calls.values():
            ep = dict(rec["ep"], N=N)
            e = rec["epoch"]  # states[e - 1] before the epoch, states[e] after it
            rejected = rec["rs"]["got"] > 0 and states[e][1] > states[e - 1][1]
            out.append((label, D1, N, ep, rec["rs"], rejected))
    return out


@pytest.fixture(scope="module")
def epochs():
    mp = pytest.MonkeyPatch()
    try:
        yield _epochs(mp)
    finally:
        mp.undo()


def test_compact_rounds_equal_plain_rounds(epochs):
    """On every epoch that ran the rounds: the compacted bookkeeping gives
    the plain rounds' per-node counts, taken pods, productive rounds and
    every domain's sandwich bit."""
    assert len(epochs) > 20
    for label, _, _, ep, want, _ in epochs:
        got = compact_rounds(copy.copy(ep))
        where = f"{label} m_rem={ep['m_rem']}"
        assert torch.equal(got["counts"], want["counts"]), where
        assert got["got"] == want["got"] and got["rounds"] == want["rounds"], where
        assert torch.equal(got["everb_d"], want["everb_d"]), where


def _static_eligible(ep) -> int:
    """Eligible domains that hold no candidate (the compaction's fixed part)."""
    P = int(ep["cand"].sum())
    held = set(ep["dom_srt"][:P].tolist())
    return sum(1 for d in range(ep["D"] + 1) if bool(ep["edom_live"][d]) and d not in held)


def test_compact_rounds_cases_cover_the_design(epochs):
    """The epochs reach what the compaction must keep: zone spreads whose
    epochs take several pods over several rounds, with and without eligible
    domains that hold no candidate, one whose fixed minimum is reached after
    the open zones rose and one with a multi-level round; a hostname spread
    whose domain axis has a domain a node (D + 1 = N + 1), with cordoned
    nodes' domains eligible; DoNotSchedule budgets whose rounds the sandwich
    rejects; ROADMAP §C3's overcommit (the sentinel domain unmetered: u0 takes
    pods)."""
    zone = [e for e in epochs if e[0] in ("seeded", "open", "levels", "cordoned_zones")]
    assert any(e[4]["got"] > 1 and e[4]["rounds"] > 1 and e[3]["dns_live"] for e in zone)
    assert any(e[4]["full"] > 0 for e in zone)  # a multi-level round
    cz = [e for e in zone if e[0] == "cordoned_zones"]
    assert cz and all(_static_eligible(e[3]) == 2 for e in cz)
    assert any(e[4]["got"] > 1 and e[4]["rounds"] > 1 and bool(e[4]["everb_d"].any()) for e in cz)
    host = [e for e in epochs if e[0] == "hostname"]
    assert host and all(e[1] == e[2] + 1 for e in host)
    assert any(e[4]["got"] > 1 for e in host)
    ch = [e for e in epochs if e[0] == "cordoned_hosts"]
    assert ch and all(_static_eligible(e[3]) == 16 for e in ch)
    assert any(e[4]["got"] > 1 and e[4]["rounds"] > 1 for e in ch)
    assert any(e[5] and e[3]["has_budget"] for e in epochs)  # a sandwich rejection
    over = [e for e in epochs if e[0] == "overcommit"]
    assert over and any(int(e[4]["counts"][6]) > 0 for e in over)
    assert all(not e[3]["dns_live"] and e[3]["has_budget"] for e in over)
