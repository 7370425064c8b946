"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX (the GPU host need not have it), so it runs there as

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

and skips on a host without a CUDA device: the kernels have no CPU mode.
"""

import pytest
import torch

from open_simulator_torch.ops import kernels as K
from open_simulator_torch.simulator.engine import Simulator
from open_simulator_torch.utils.synth import synth_cluster


@pytest.mark.cuda
def test_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    nodes, pods = synth_cluster(256, 1500, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    kc, kch = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones)
    pc, pch = K.schedule_batch_plain(tb, seed, *args, bt.n_zones)
    assert torch.equal(kch, pch)
    for f in ("requested", "nonzero", "port_used", "counter", "carrier"):
        assert torch.equal(getattr(kc, f), getattr(pc, f)), f
    for g in sorted({int(g) for g in bt.pod_group[:len(pods)]}):
        for cry in (seed, kc):
            kf, ks = K.feasibility_kernel(tb, cry, g, -1, True)
            pf, ps = K.feasibility(tb, cry, g, -1, True)
            assert torch.equal(kf, pf)
            for k in K.STAGE_KEYS:
                assert torch.equal(ks[k], ps[k]), k


@pytest.mark.cuda
def test_topology_weight_on_the_card_matches_the_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.arange(0, 1 << 20, dtype=torch.float32)
    assert torch.equal(K.topology_weight(x.cuda()).cpu(), K.topology_weight(x))


def _segments_of(sim, pods):
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    return bt, tb, seed, sim._segments(bt, len(pods))


def _same_carry(a, b):
    for f in K.Carry._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
def test_wave_kernels_match_plain_versions():
    """K3 (counts, placed, loop statistics) and K3c (the whole carry) against
    their plain versions, at the engine's block/kmax and at a forced block 8
    / kmax 16 that makes the guard and more iterations fire."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    nodes, pods = synth_cluster(256, 3000, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt, tb, seed, segs = _segments_of(sim, pods)
    waves = [s for s in segs if s[0] == "wave"]
    assert any(s[4] for s in waves) and any(not s[4] for s in waves)  # cap1 and not
    for _, _, m, g, cap1, _ in waves:
        block = K.wave_block_for(m, sim.na.N)
        for blk, kmax in ((block, K.wave_kmax(m, sim.na.N, block)), (8, 16)):
            kj, kp, kst = K.schedule_wave_kernel(tb, seed, g, m, cap1, block=blk, kmax=kmax)
            pj, pp, pst = K.schedule_wave_plain(tb, seed, g, m, cap1, block=blk, kmax=kmax)
            assert torch.equal(kj, pj), (g, blk)
            assert int(kp) == pp
            assert kst.tolist() == [pst[k] for k in K.WAVE_STATS]
            _same_carry(K.aggregate_commit_kernel(tb, seed, g, kj),
                        K.aggregate_commit_plain(tb, seed, g, pj))


@pytest.mark.cuda
def test_group_serial_kernel_matches_plain_version():
    """K4 on every spread flag (live ScheduleAnyway, live zoned
    SelectorSpread, two DoNotSchedule terms) against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.utils.synth import synth_spread_cluster

    nodes, pods, services = synth_spread_cluster(256, 1200)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt, tb, seed, segs = _segments_of(sim, pods)
    spread = [s for s in segs if s[0] == "spread"]
    assert {(s[5], s[6]) for s in spread} == {(True, False), (False, True), (False, False)}
    for _, _, m, g, cap1, ss_live, sa_live in spread[:6]:
        valid = torch.arange(m + 5, device="cuda") < m
        nz = bt.n_zones if ss_live else 2
        kj, kp = K.schedule_group_serial_kernel(tb, seed, g, valid, cap1, ss_live=ss_live,
                                                sa_live=sa_live, n_zones=nz)
        pj, pp = K.schedule_group_serial_plain(tb, seed, g, valid, cap1, ss_live=ss_live,
                                               sa_live=sa_live, n_zones=nz)
        assert torch.equal(kj, pj), (g, ss_live, sa_live)
        assert int(kp) == pp


@pytest.mark.cuda
def test_wave_kernel_branches_match_plain_version():
    """K3's other branches against the plain version: rising score columns
    (the guard and the head fallback), NodeResourcesFit off, and an
    overflowing cluster whose exhausting picks stop iterations early."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fixtures import make_node, make_pod

    rising = [make_node(f"r{i}", cpu="4", memory="8Gi") for i in range(2)]
    hogs = [make_pod(f"hog{i}", cpu="2500m", memory="100Mi", node_name=f"r{i}") for i in range(2)]
    mem = [make_pod(f"mem-{i}", cpu="100m", memory="1Gi", labels={"app": "mem"})
           for i in range(12)]
    over_nodes, over_pods = synth_cluster(8, 600, hard_predicates=True)
    totals = {k: 0 for k in K.WAVE_STATS}
    for nodes, bound, pods in ((rising, hogs, mem), (over_nodes, [], over_pods)):
        sim = Simulator(nodes, device="cuda")
        sim.schedule_pods(bound)
        bt, tb, seed, segs = _segments_of(sim, pods)
        for _, _, m, g, cap1, _ in (s for s in segs if s[0] == "wave"):
            for filters in (K.DEFAULT_FILTERS, K.FilterFlags(fit=False)):
                for blk, kmax in ((K.wave_block_for(m, sim.na.N), 0), (8, 16)):
                    kj, kp, kst = K.schedule_wave_kernel(tb, seed, g, m, cap1, filters=filters,
                                                         block=blk, kmax=kmax)
                    pj, pp, pst = K.schedule_wave_plain(tb, seed, g, m, cap1, filters=filters,
                                                        block=blk, kmax=kmax)
                    assert torch.equal(kj, pj), (g, filters, blk)
                    assert int(kp) == pp
                    assert kst.tolist() == [pst[k] for k in K.WAVE_STATS]
                    for k in K.WAVE_STATS:
                        totals[k] += pst[k]
    assert totals["head_fallbacks"] > 0 and totals["guarded"] > 0


def _affinity_cases():
    """(label, nodes, pods, services) of the affinity route: every shape of
    synth_affinity_cluster (live SelectorSpread among them) and the affinity
    segments of the hard-predicate cluster."""
    from open_simulator_torch.utils.synth import synth_affinity_cluster

    nodes, pods, services = synth_affinity_cluster(256, 1200)
    yield "affinity", nodes, pods, services
    nodes, pods = synth_cluster(256, 3000, hard_predicates=True)
    yield "hard", nodes, pods, []
    # zone self-anti-affinity with an unlabeled two-slot node: the sentinel
    # domain's entries are re-taken every round (the JAX result, ROADMAP §C)
    from fixtures import make_node, make_pod

    zone = "topology.kubernetes.io/zone"
    nodes = [make_node(f"n{i}", labels={zone: f"z{i % 3}"}) for i in range(6)]
    nodes.append(make_node("u0", pods="2"))
    term = {"labelSelector": {"matchLabels": {"app": "ao"}}, "topologyKey": zone}
    pods = [make_pod(f"ao-{i}", cpu="400m", memory="128Mi", labels={"app": "ao"})
            for i in range(20)]
    for p in pods:
        p["spec"]["affinity"] = {
            "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [term]}}
    yield "overcommit", nodes, pods, []


@pytest.mark.cuda
def test_affinity_wave_kernel_matches_plain_version():
    """K5 (counts, placed, epoch statistics) against its plain version on
    every affinity segment, at the engine's block and at a forced block 2
    (depth caps and the hidden-continuation cut bind), and with each filter
    flag off; K3c then commits equal counts equally."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from open_simulator_torch.core.types import ResourceTypes

    totals = dict.fromkeys(K.AFFINITY_STATS, 0)
    for label, nodes, pods, services in _affinity_cases():
        sim = Simulator(nodes, device="cuda")
        sim.register_cluster_objects(ResourceTypes(services=services))
        bt, tb, seed, segs = _segments_of(sim, pods)
        aff = [s for s in segs if s[0] == "affinity"]
        assert aff, label
        variants = [(None, K.DEFAULT_FILTERS), (2, K.DEFAULT_FILTERS)]
        variants += [(None, K.FilterFlags(**{f: False})) for f in ("fit", "interpod", "spread")]
        for k, (_, _, m, g, cap1, ss_live) in enumerate(aff):
            nz = bt.n_zones if ss_live else 2
            for blk, filters in (variants if k < 5 else variants[:1]):
                blk = blk or K.wave_block_for(m, sim.na.N)
                kj, kp, kst = K.schedule_affinity_wave_kernel(
                    tb, seed, g, m, cap1, ss_live=ss_live, filters=filters, block=blk,
                    n_zones=nz)
                pj, pp, pst = K.schedule_affinity_wave_plain(
                    tb, seed, g, m, cap1, ss_live=ss_live, filters=filters, block=blk,
                    n_zones=nz)
                assert torch.equal(kj, pj), (label, g, blk, filters)
                assert int(kp) == pp
                assert kst.tolist() == [pst[s] for s in K.AFFINITY_STATS], (label, g, blk)
                for s in K.AFFINITY_STATS:
                    totals[s] += pst[s]
            _same_carry(K.aggregate_commit_kernel(tb, seed, g, kj),
                        K.aggregate_commit_plain(tb, seed, g, pj))
    # both epoch kinds ran: head fallbacks and multi-round takes
    assert totals["head_fallbacks"] > 0 and totals["multi_rounds"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_pods", [1200, 2400])
def test_extended_kernels_match_plain_versions(n_pods):
    """The GPU-share and Open-Local branches on two 256-node extended
    clusters (the second overflows further): K2 (choices, every carry field
    with the device and storage ledgers) and K1 (every stage, seed and end
    carry) with both branches on, and K3 + K3c with gpu_live on every
    shared-GPU wave segment, at the engine's block and at block 8 / kmax 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.utils.synth import synth_extended_cluster

    nodes, pods, _, scs = synth_extended_cluster(256, n_pods)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(storage_classes=scs))
    bt, tb, seed, segs = _segments_of(sim, pods)
    flags = dict(enable_gpu=True, enable_storage=True)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    kc, kch = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones, **flags)
    pc, pch = K.schedule_batch_plain(tb, seed, *args, bt.n_zones, **flags)
    assert torch.equal(kch, pch)
    assert bool((kch[:len(pods)] < 0).any())
    _same_carry(kc, pc)
    for g in sorted({int(g) for g in bt.pod_group[:len(pods)]}):
        for cry in (seed, kc):
            kf, ks = K.feasibility_kernel(tb, cry, g, -1, True, **flags)
            pf, ps = K.feasibility(tb, cry, g, -1, True, **flags)
            assert torch.equal(kf, pf), g
            for k in K.STAGE_KEYS:
                assert torch.equal(ks[k], ps[k]), (g, k)
    waves = [s for s in segs if s[0] == "wave" and s[5]]
    assert {int(bt.grp_gpu_num[s[3]]) for s in waves} == {1, 2}
    for _, _, m, g, cap1, _ in waves:
        block = K.wave_block_for(m, sim.na.N)
        for blk, kmax in ((block, K.wave_kmax(m, sim.na.N, block)), (8, 16)):
            kj, kp, kst = K.schedule_wave_kernel(tb, kc, g, m, cap1, block=blk, kmax=kmax,
                                                 gpu_live=True)
            pj, pp, pst = K.schedule_wave_plain(tb, kc, g, m, cap1, block=blk, kmax=kmax,
                                                gpu_live=True)
            assert torch.equal(kj, pj), (g, blk)
            assert int(kp) == pp
            assert kst.tolist() == [pst[k] for k in K.WAVE_STATS]
        _same_carry(K.aggregate_commit_kernel(tb, kc, g, kj, gpu_live=True),
                    K.aggregate_commit_plain(tb, kc, g, pj, gpu_live=True))


def _capacity_session(n_base=48, n_pods=600, n_new=40):
    """A capacity probe session on the card over synth_capacity_cluster
    (every segment kind of the router), with its segments by kind."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.probe import ProbeSession
    from open_simulator_torch.utils.synth import synth_capacity_cluster

    base, tpl, pods, services = synth_capacity_cluster(n_base, n_pods)
    ses = ProbeSession.try_build(base, tpl, pods, ResourceTypes(services=services),
                                 n_new=n_new, device="cuda")
    assert ses is not None
    kinds = {}
    for s in ses._segs:
        kinds.setdefault(s[0], s)
    assert set(kinds) == {"serial", "wave", "spread", "affinity"}
    return ses, kinds


def _lane_masks(ses, S):
    """S node-active masks: prefixes of growing candidate counts, and (for
    S > 1) one arbitrary mask as the last lane."""
    import numpy as np

    rng = np.random.default_rng(5)
    a = np.zeros((S, ses._n_pad), bool)
    for i in range(S):
        a[i, :ses.n_base + (ses.n_new * i) // max(S - 1, 1)] = True
    if S > 1:
        a[-1] = rng.random(ses._n_pad) < 0.7
        a[-1, ses.n_base + ses.n_new:] = False
    return torch.from_numpy(a).cuda()


def _fanout_cases(ses, seg, active):
    """(kernel dispatcher, plain fan-out, args, kwargs) of one segment: the
    plain fan-out is the plain lanes then the plain commit over lanes, run on
    the card's tensors."""
    from open_simulator_torch.simulator.encode import bucket_capped

    tb, bt = ses._tables, ses._bt
    cry_s = K.carry_lanes(ses._seed, active.shape[0])
    n_real = ses.n_base + ses.n_new
    kind, start, length = seg[:3]
    if kind == "serial":
        pad = bucket_capped(length, 2048)
        pg = torch.zeros(pad, dtype=torch.int32)
        pg[:length] = torch.from_numpy(bt.pod_group[start:start + length])
        fn = torch.full((pad,), -1, dtype=torch.int32)
        fn[:length] = torch.from_numpy(bt.forced_node[start:start + length])
        vd = torch.arange(pad) < length
        args = (tb, cry_s, active, pg.cuda(), fn.cuda(), vd.cuda(), bt.n_zones, *ses._flags)

        def plain(*a):
            enable_gpu, enable_storage = a[7:]
            carry_s, choices = K.schedule_batch_lanes_plain(*a[:7], enable_gpu=enable_gpu,
                                                            enable_storage=enable_storage)
            return carry_s, (choices >= 0).sum(dim=1, dtype=torch.int32)

        return K.probe_serial_fanout, plain, args, {}
    g, cap1 = seg[3], bool(seg[4])
    block = K.wave_block_for(length, n_real)
    if kind == "wave":
        kw = dict(gpu_live=seg[5], block=block, kmax=K.wave_kmax(length, n_real, block))
        lanes, args = K.schedule_wave_lanes_plain, (tb, cry_s, active, g, length, cap1)
        commit_kw = dict(gpu_live=seg[5])
        dispatch = K.probe_wave_fanout
    elif kind == "spread":
        vd = (torch.arange(bucket_capped(length, 2048)) < length).cuda()
        kw = dict(ss_live=seg[5], sa_live=seg[6], n_zones=bt.n_zones if seg[5] else 2)
        lanes, args = K.schedule_group_serial_lanes_plain, (tb, cry_s, active, g, vd, cap1)
        commit_kw, dispatch = {}, K.probe_group_serial_fanout
    else:
        kw = dict(ss_live=seg[5], block=block, n_zones=bt.n_zones if seg[5] else 2)
        lanes, args = K.schedule_affinity_wave_lanes_plain, (tb, cry_s, active, g, length, cap1)
        commit_kw, dispatch = {}, K.probe_affinity_wave_fanout

    def plain(*a, **k):
        out = lanes(*a, **k)
        return K.aggregate_commit_lanes_plain(tb, cry_s, g, out[0], **commit_kw), out[1]

    return dispatch, plain, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 8])
def test_lane_kernels_match_plain_fanouts(S):
    """Each fan-out on the card (K2-K5 over lanes, then K3c over lanes)
    against its plain fan-out: placed per lane and every carry field of
    every lane, one segment of each kind, prefix masks and an arbitrary one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ses, kinds = _capacity_session(16, 600)
    active = _lane_masks(ses, S)
    for kind, seg in sorted(kinds.items()):
        kfn, pfn, args, kw = _fanout_cases(ses, seg, active)
        kc, kp = kfn(*args, **kw)
        pc, pp = pfn(*args, **kw)
        assert torch.equal(kp, pp), kind
        _same_carry(kc, pc)


@pytest.mark.cuda
def test_lane_kernels_equal_single_lane_kernels():
    """Lane s of each lane kernel equals the single-lane kernel on the
    tables with lane s's mask folded into static_mask (loop statistics
    included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ses, kinds = _capacity_session(16, 600)
    active = _lane_masks(ses, 4)
    tb = ses._tables
    cry_s = K.carry_lanes(ses._seed, 4)
    n_real = ses.n_base + ses.n_new
    _, _, m, g, cap1, gpu_live = kinds["wave"]
    block = K.wave_block_for(m, n_real)
    kw = dict(block=block, kmax=K.wave_kmax(m, n_real, block), gpu_live=gpu_live)
    j_s, p_s, st_s = K.schedule_wave_lanes_kernel(tb, cry_s, active, g, m, cap1, **kw)
    _, _, m5, g5, cap5, ss5 = kinds["affinity"]
    b5 = K.wave_block_for(m5, n_real)
    j5, p5, st5 = K.schedule_affinity_wave_lanes_kernel(tb, cry_s, active, g5, m5, cap5, ss5,
                                                        block=b5)
    for s in range(4):
        masked = K._mask_active(tb, active[s])
        lane = K.carry_lane(cry_s, s)
        j, p, st = K.schedule_wave_kernel(masked, lane, g, m, cap1, **kw)
        assert torch.equal(j_s[s], j) and int(p_s[s]) == int(p)
        assert torch.equal(st_s[s], st)
        j, p, st = K.schedule_affinity_wave_kernel(masked, lane, g5, m5, cap5, ss5, block=b5)
        assert torch.equal(j5[s], j) and int(p5[s]) == int(p)
        assert torch.equal(st5[s], st)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 37])
def test_extend_kernel_matches_plain_version(pad):
    """K6 against extend_tables_plain, every field, with and without a
    phantom pad after the copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ses, _ = _capacity_session(16, 600)
    tb = ses._tables
    n_real = ses.n_base + ses.n_new
    k = 3 * tb.alloc.shape[0] - n_real - pad
    sentinel = ses._seed.counter.shape[1] - 1
    got = K.extend_tables_kernel(tb, n_real, k, ses.n_base, n_real + k + pad, sentinel)
    want = K.extend_tables_plain(tb, n_real, k, ses.n_base, n_real + k + pad, sentinel)
    for f in K.Tables._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _serve_sweep_inputs(ses, S):
    """Inputs of the four serve and sweep fan-outs on a capacity session:
    a union batch with a dense and a sparse valid row per lane, per-lane wave
    groups with one m = 0 lane and m = 1 beside the largest m, a K = 4 chain
    with padding segments, and per-lane pod streams of other lengths."""
    import numpy as np

    from open_simulator_torch.simulator.encode import bucket_capped

    bt = ses._bt
    rng = np.random.default_rng(9 + S)
    waves = sorted({(s[3], bool(s[4])) for s in ses._segs if s[0] == "wave"},
                   key=lambda gc: gc[1])
    n_rows = min(400, len(bt.pod_group))
    pad = bucket_capped(n_rows, 2048)
    pg = np.zeros(pad, np.int32)
    fn = np.full(pad, -1, np.int32)
    pg[:n_rows], fn[:n_rows] = bt.pod_group[:n_rows], bt.forced_node[:n_rows]
    valid = np.zeros((S, pad), bool)
    for s in range(S):
        lo, hi = s * n_rows // S, (s + 1) * n_rows // S
        valid[s, lo:hi if s % 2 == 0 else lo + 3] = True
    g_s = np.array([waves[s % len(waves)][0] for s in range(S)], np.int32)
    cap1_s = np.array([waves[s % len(waves)][1] for s in range(S)], bool)
    m_s = np.array([[500, 0, 1, 200, 64, 9, 333, 17][s] for s in range(S)], np.int32)
    depth = 4
    g_sk = np.zeros((S, depth), np.int32)
    m_sk = np.zeros((S, depth), np.int32)
    c_sk = np.zeros((S, depth), bool)
    for s in range(S):
        for k in range(depth - 1 - s % 2):
            g, c = waves[int(rng.integers(len(waves)))]
            g_sk[s, k], m_sk[s, k], c_sk[s, k] = g, int(rng.integers(1, 300)), c
    lengths = [int(rng.integers(50, 400)) for _ in range(S)]
    P = bucket_capped(max(lengths), 2048)
    pg_s = np.zeros((S, P), np.int32)
    fn_s = np.full((S, P), -1, np.int32)
    vd_s = np.zeros((S, P), bool)
    for s, L in enumerate(lengths):
        rows = np.sort(rng.choice(len(bt.pod_group), size=L, replace=False))
        pg_s[s, :L], fn_s[s, :L], vd_s[s, :L] = bt.pod_group[rows], bt.forced_node[rows], True
    n_real = ses.n_base + ses.n_new

    def wave_kw(m):
        block = K.wave_block_for(int(m.max()), n_real)
        return dict(block=block, kmax=K.wave_kmax(int(m.max()), n_real, block))

    return {
        "serve_whatif_fanout": ((pg, fn, valid, bt.n_zones, False, False), {}),
        "serve_wave_fanout": ((g_s, m_s, cap1_s), wave_kw(m_s)),
        "sweep_wave_fanout": ((g_sk, m_sk, c_sk), wave_kw(m_sk)),
        "sweep_whatif_fanout": ((pg_s, fn_s, vd_s, bt.n_zones, False, False), {}),
    }


def _plain_fanout(name, tb, cry_s, active, args, kw):
    """The plain reference of one serve or sweep fan-out, composed of the
    plain lane functions on the card's tensors: K2's plain lanes for the two
    what-if fan-outs, the plain K3 and K3c lanes (one segment, or the chain)
    for the two wave fan-outs."""
    import numpy as np

    on = [torch.from_numpy(a).to(tb.alloc.device) if isinstance(a, np.ndarray) else a
          for a in args]
    if name.endswith("whatif_fanout"):
        carry_s, choices = K.schedule_batch_lanes_plain(tb, cry_s, active, *on[:4],
                                                        enable_gpu=on[4], enable_storage=on[5])
        if name == "serve_whatif_fanout":
            return carry_s, (choices >= 0).sum(dim=1, dtype=torch.int32)
        return carry_s, choices
    g, m, c = on if name == "sweep_wave_fanout" else (a[:, None] for a in on)
    carry_s, counts, placed = K._wave_chain(tb, cry_s, active, g, m, c, K.DEFAULT_WEIGHTS,
                                            K.DEFAULT_FILTERS, kw["block"], kw["kmax"],
                                            K.schedule_wave_lanes_plain,
                                            K.aggregate_commit_lanes_plain)
    return (carry_s, counts) if name == "sweep_wave_fanout" else (carry_s, placed[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 8])
def test_serve_and_sweep_fanouts_match_plain_versions(S):
    """The four serve and sweep fan-outs on the card (K2, K3 and K3c over
    lanes with per-lane inputs) against their plain versions on the same
    card tensors: placed, counts or choices, every carry field of every
    lane; the base carry is left as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ses, _ = _capacity_session(16, 600)
    active = _lane_masks(ses, S)
    cry_s = K.carry_lanes(ses._seed, S)
    before = [t.clone() for t in cry_s]
    for name, (args, kw) in _serve_sweep_inputs(ses, S).items():
        fn = getattr(K, name)
        kc, kout = fn(ses._tables, cry_s, active, *args, **kw)
        pc, pout = _plain_fanout(name, ses._tables, cry_s, active, args, kw)
        assert torch.equal(kout, pout), name
        _same_carry(kc, pc)
        for a, b in zip(before, cry_s):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_per_lane_wave_equals_single_lane_kernel():
    """Lane s of serve_wave_fanout's K3 over lanes, with its own group, m
    and cap1, equals the single-lane K3 on lane s's masked tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ses, _ = _capacity_session(16, 600)
    active = _lane_masks(ses, 8)
    cry_s = K.carry_lanes(ses._seed, 8)
    (g_s, m_s, cap1_s), kw = _serve_sweep_inputs(ses, 8)["serve_wave_fanout"]
    gt, mt, ct = (torch.as_tensor(a).cuda() for a in (g_s, m_s, cap1_s))
    j_s, p_s, st_s = K.schedule_wave_lanes_kernel(ses._tables, cry_s, active, gt, mt, ct, **kw)
    for s in range(8):
        j, p, st = K.schedule_wave_kernel(K._mask_active(ses._tables, active[s]),
                                          K.carry_lane(cry_s, s), int(g_s[s]), int(m_s[s]),
                                          bool(cap1_s[s]), **kw)
        assert torch.equal(j_s[s], j) and int(p_s[s]) == int(p) and torch.equal(st_s[s], st)


def _same_explain(k_packed, p):
    """K7's packed rows against the plain explain_pod four-tuple, bit for bit."""
    kf, ks, ktot, kcomp = K.unpack_explain(k_packed)
    pf, ps, ptot, pcomp = p
    assert torch.equal(kf, pf)
    for k in K.EXPLAIN_STAGES:
        assert torch.equal(ks[k], ps[k]), k
    assert torch.equal(ktot.view(torch.int32), ptot.view(torch.int32))
    for k in K.COMPONENT_ORDER:
        assert torch.equal(kcomp[k].view(torch.int32), pcomp[k].contiguous().view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hard", "extended"])
def test_explain_kernel_matches_plain_version(kind):
    """K7 against plain explain_pod on every group, with and without a forced
    node, against the seed carry, a mid-run carry and a full carry (no node
    feasible); the extended cluster with the GPU-share and Open-Local
    branches on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.utils.synth import synth_extended_cluster

    if kind == "hard":
        nodes, pods = synth_cluster(256, 1500, hard_predicates=True)
        scs = []
    else:
        nodes, pods, _, scs = synth_extended_cluster(256, 1200)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(storage_classes=scs))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    ext = kind == "extended"
    flags = dict(enable_gpu=ext, enable_storage=ext)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    mid, _ = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones, **flags)
    full = seed._replace(requested=tb.alloc.clone())
    N = int(tb.alloc.shape[0])
    for cry in (seed, mid, full):
        for g in sorted({int(g) for g in bt.pod_group[:len(pods)]}):
            for forced in (-1, (7 * g + 3) % N):
                got = K.explain_kernel(tb, cry, g, forced, True, bt.n_zones, **flags)
                _same_explain(got, K.explain_pod(tb, cry, g, forced, True, bt.n_zones, **flags))
