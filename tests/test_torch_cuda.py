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


def _capacity_session(n_base=48, n_pods=600, n_new=40, sched_config=None):
    """A capacity probe session on the card over synth_capacity_cluster
    (every segment kind of the router), with its segments by kind."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.probe import ProbeSession
    from open_simulator_torch.utils.synth import synth_capacity_cluster

    base, tpl, pods, services = synth_capacity_cluster(n_base, n_pods)
    ses = ProbeSession.try_build(base, tpl, pods, ResourceTypes(services=services),
                                 n_new=n_new, device="cuda", sched_config=sched_config)
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


def _fanout_cases(ses, seg, active, wf=None):
    """(kernel dispatcher, plain fan-out, args, kwargs) of one segment: the
    plain fan-out is the plain lanes then the plain commit over lanes, run on
    the card's tensors. `wf`: score weights and filter flags (w=, filters=)
    joining the kwargs."""
    wf = wf or {}
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

        def plain(*a, **k):
            enable_gpu, enable_storage = a[7:]
            carry_s, choices = K.schedule_batch_lanes_plain(*a[:7], enable_gpu=enable_gpu,
                                                            enable_storage=enable_storage, **k)
            return carry_s, (choices >= 0).sum(dim=1, dtype=torch.int32)

        return K.probe_serial_fanout, plain, args, dict(wf)
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

    return dispatch, plain, args, {**kw, **wf}


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


@pytest.mark.cuda
def test_sharded_kernels_match_plain_sharded_on_two_ranks(tmp_path):
    """K8 and K9 on two ranks that share cuda:0 over gloo (CUDA tensors
    staged through host memory) against their plain sharded versions on the
    same ranks and the unsharded K3 / K5, on every wave and affinity segment
    of the seeded workload (the upper shard's block all cordoned)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    got = run_ranks(C.card_kernels, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    assert {r["kind"] for r in got[0]} == {"wave", "affinity"}
    for r in got[0]:
        assert r["same_plain"] and r["same_unsharded"], r


@pytest.mark.cuda
def test_round_kernel_matches_plain_rounds_on_two_ranks(tmp_path):
    """K10 on two ranks that share cuda:0 over gloo against its plain
    per-round version on the same ranks and the unsharded K3, bit for bit
    (counts, placed, WAVE_STATS), on every run of the seeded per-round cases
    (tests/torch_mesh_cases.py `round_segments`, the epoch limit at 16),
    with two pmax and two all_gather_rows per round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    got = run_ranks(C.card_round_kernels, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    for r in got[0]:
        assert r["same_plain"] and r["same_unsharded"], r
        rounds = r["stats"][0]
        assert r["calls"] == {"pmax": 2 * rounds, "all_gather_tiled": 0,
                              "all_gather_rows": 2 * rounds}, r
    assert sum(r["stats"][1] for r in got[0]) > 0 and sum(r["stats"][2] for r in got[0]) > 0
    assert sum(r["sched"] for r in got[0]) == 1  # one run under custom weights and flags


@pytest.mark.cuda
def test_tail_kernel_matches_plain_tail_on_two_ranks(tmp_path):
    """K11 on two ranks that share cuda:0 over gloo against its plain
    sharded-tail version on the same ranks and the unsharded K5, bit for bit
    (counts, placed, AFFINITY_STATS), on every affinity segment of the
    seeded tail cases (tests/torch_mesh_cases.py `_tail_segments`, the epoch
    limit lowered), with the same branches and the tail's collectives per
    branch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    got = run_ranks(C.card_tail_kernels, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    for r in got[0]:
        assert r["same_plain"] and r["same_unsharded"] and r["same_branches"], r
        assert C.tail_epochs(r["branches"]) == r["stats"][0], r
        assert r["calls"] == C.tail_calls(r["branches"]), r
    assert sum(r["stats"][1] for r in got[0]) > 0 and sum(r["stats"][2] for r in got[0]) > 0
    assert sum(r["branches"].get("rejected", 0) for r in got[0]) > 0


@pytest.mark.cuda
def test_round_stage_smem_models_hold():
    """The library's K8 - K13 stage shared memory (wave_sharded_smem,
    wave_rounds_smem, affinity_rounds_smem,
    affinity_sharded_smem, affinity_sharded_tail_smem, batch_sharded_smem,
    gs_sharded_smem and K8's, K9's, K11's, K12's and K13's bounds) is
    tests/test_torch_cluster_shape.py `rounds_smem_model` at every cluster
    size, on the view of a batch whose zone axis, carriers and
    ScheduleAnyway slots are the encoder's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import ctypes

    import test_torch_cluster_shape as CS
    from open_simulator_torch.ops import build, cluster

    lib = build.library()
    nodes, pods = synth_cluster(64, 256, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    v = K._view(tb, seed, bt.n_zones, K.DEFAULT_WEIGHTS, K.DEFAULT_FILTERS)
    assert lib.affinity_rounds_smem_max() == CS.K11_SMEM_MAX
    assert lib.affinity_sharded_smem_max() == CS.K9_SMEM_MAX
    assert lib.batch_sharded_smem_max() == CS.K12_SMEM_MAX
    assert lib.wave_sharded_smem_max() == CS.K8_SMEM_MAX
    assert lib.gs_sharded_smem_max() == CS.K13_SMEM_MAX
    vr = ctypes.byref(v)
    for C in cluster.SIZES:
        assert lib.wave_sharded_smem(C) == CS.rounds_smem_model("k8", C) \
            == CS.rounds_smem_model("k8_tail", C)
        assert lib.gs_sharded_smem(vr, C) == CS.rounds_smem_model("k13", C, Z=v.Z, Ss=v.Ss,
                                                                  Sd=v.Sd)
        assert lib.wave_rounds_smem(C) == CS.rounds_smem_model("k10", C)
        assert lib.affinity_rounds_smem(vr, C) == CS.rounds_smem_model("k11", C, Cw=v.Cw, Z=v.Z)
        assert lib.affinity_sharded_smem(vr, C) == CS.rounds_smem_model("k9", C, Cw=v.Cw)
        assert lib.affinity_sharded_tail_smem(vr, C) == CS.rounds_smem_model("k9_tail", C, Z=v.Z)
        assert lib.batch_sharded_smem(vr, C) == CS.rounds_smem_model("k12", C, Z=v.Z, Ss=v.Ss)


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", ["K10/K11", "K9"])
def test_round_and_tail_kernels_on_every_cluster_size(tmp_path, kernels):
    """K10 and K11, and K9, on two ranks that share cuda:0 over gloo, at
    blocks whose stages take clusters of 2, 4, 8 and 16 CTAs
    (tests/torch_mesh_cases.py `card_cluster_sizes`; K9's blocks, not a
    multiple of C, and its tail over N: `card_k9_cluster_sizes`), against
    their plain versions on the same ranks and the unsharded K3 / K5, bit
    for bit; K9 with live SelectorSpread, head fallbacks and zone spreads,
    one pmax and one all-gather an epoch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    fn = C.card_cluster_sizes if kernels == "K10/K11" else C.card_k9_cluster_sizes
    got = run_ranks(fn, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    for r in got[0]:
        assert r["C"] == r["want_C"], r
        assert r["same_plain"] and r["same_unsharded"] and r.get("same_branches", True), r
    if kernels == "K9":
        assert {r["C"][0] for r in got[0]} == {1, 2, 4, 8, 16}
        assert {r["C"][1] for r in got[0]} == {2, 4, 8, 16}
        for r in got[0]:
            epochs = r["stats"][0]
            assert r["calls"] == {"pmax": epochs, "all_gather_tiled": epochs,
                                  "all_gather_rows": 0}, r
        assert any(r["ss_live"] for r in got[0])
        assert sum(r["stats"][1] for r in got[0]) > 0 and sum(r["stats"][2] for r in got[0]) > 0
        return
    assert {r["C"] for r in got[0] if r["kernel"] == "K10"} == {2, 4, 8, 16}
    assert {r["C"] for r in got[0] if r["kernel"] == "K11"} == {2, 4, 8, 16}


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", ["seeded", "every_cluster_size"])
def test_partitioned_scan_kernel_matches_plain_on_two_ranks(tmp_path, blocks):
    """K12 on two ranks that share cuda:0 over gloo, each holding its block
    of the node axis, against the plain sharded scan on the same ranks and
    the unsharded K2, bit for bit (choices, carry), on the seeded clusters of
    tests/torch_mesh_cases.py `partitioned_scans` (EXT false and true) and,
    at blocks whose stages take clusters of 2, 4, 8 and 16 CTAs (not a
    multiple of C: `card_k12_cluster_sizes`), on the same shapes of cluster,
    with two all_gather_rows per pod and a pmax per ScheduleAnyway pod; K1 on
    the block and K12's explain mode against K1, K7 and the plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    fn = C.card_partitioned if blocks == "seeded" else C.card_k12_cluster_sizes
    got = run_ranks(fn, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    for r in got[0]:
        assert r["same_plain"] and r["same_unsharded"] and r["diag_same"], r
        assert r["calls"] == {"pmax": r["sa_pods"], "all_gather_tiled": 0,
                              "all_gather_rows": 2 * r["pods"]}, r
    if blocks == "seeded":
        assert [r["flags"] for r in got[0]] == [(False, False), (True, True)]
        assert got[0][0]["sa_pods"] > 0 and got[0][0]["failed"] > 0
        return
    for r in got[0]:
        assert r["C"] == r["want_C"] and r["NL"] % r["C"] != 0, r
    assert {r["C"] for r in got[0]} == {2, 4, 8, 16}
    seeded = [r for r in got[0] if r["cluster"] == "seeded"]
    assert all(r["sa_pods"] > 0 and r["forced_blocks"] == [0, 1] for r in seeded)
    assert all(r["flags"] == (True, True) for r in got[0] if r["cluster"] == "extended")


@pytest.mark.cuda
def test_default_route_kernels_match_plain_on_two_ranks(tmp_path):
    """K13 and K14 on two ranks that share cuda:0 over gloo, each holding its
    block of the node axis, against their plain versions on the same ranks
    and the unsharded K4 / K3c, bit for bit (the block's counts and placed;
    the block's carry), on every segment of the spread prefix and of the
    extended cluster's GPU waves, with exactly two all_gather_rows per pod,
    a pmax per ScheduleAnyway pod and one all_gather_rows per commit; then
    the engine's default route on the partitioned layout places the mixed,
    hard-affinity and spread workloads as the unsharded engine on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    got = run_ranks(C.card_default_route, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    segs = got[0]["segments"]
    spread = [r for r in segs if r["kind"] == "spread"]
    assert {(r["ss_live"], r["sa_live"]) for r in spread} == {(False, False), (True, False),
                                                              (False, True)}
    for r in spread:
        assert r["same_plain"] and r["same_unsharded"], r
        assert r["calls"] == {"pmax": r["m"] if r["sa_live"] else 0, "all_gather_tiled": 0,
                              "all_gather_rows": 2 * r["m"]}, r
    for r in segs:
        assert r["commit_plain"] and r["commit_unsharded"], r
        assert r["commit_calls"] == {"pmax": 0, "all_gather_tiled": 0, "all_gather_rows": 1}, r
    assert any(r["gpu_live"] for r in segs)
    for name, r in got[0]["engine"].items():
        assert r["same"], (name, r)
        assert r["launches"]["aggregate_commit_sharded"] > 0, (name, r)
    assert got[0]["engine"]["spread"]["launches"]["schedule_group_serial_sharded"] > 0


@pytest.mark.cuda
def test_group_serial_scan_kernel_on_cluster_blocks(tmp_path):
    """K13 on two ranks that share cuda:0 over gloo, at blocks of 1,024 and
    2,560 nodes (tests/torch_mesh_cases.py `card_k13_blocks`: clusters of 2
    and 8 CTAs, as `last_shape` reports), against its plain version on the
    same ranks and the unsharded K4, bit for bit (the block's counts and
    placed), on segments with and without ScheduleAnyway terms, with two
    all_gather_rows a pod and a pmax a ScheduleAnyway pod."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    got = run_ranks(C.card_k13_blocks, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    for r in got[0]:
        assert r["C"] == r["want_C"], r
        assert r["same_plain"] and r["same_unsharded"] and r["placed"] > 0, r
        assert r["calls"] == {"pmax": r["m"] if r["sa_live"] else 0, "all_gather_tiled": 0,
                              "all_gather_rows": 2 * r["m"]}, r
    for NL in (1_024, 2_560):
        assert {r["sa_live"] for r in got[0] if r["NL"] == NL} == {False, True}, NL


@pytest.mark.cuda
def test_wave_epoch_kernel_on_cluster_shapes(tmp_path):
    """K8 on two ranks that share cuda:0 over gloo at N 128, 2,048 (EXT)
    and 10,240 (tests/torch_mesh_cases.py `card_k8_clusters`: its block
    stages and its tail on clusters of 1 / 1, 2 / 4 and 16 / 16 CTAs, as
    `last_shape` reports), against its plain sharded version on the same
    ranks and the unsharded K3, bit for bit (counts, placed, WAVE_STATS),
    with one pmax and one tiled all-gather an epoch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as C
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    got = run_ranks(C.card_k8_clusters, 2, str(tmp_path), device="cuda", backend="gloo")
    assert got[0] == got[1]
    for r in got[0]:
        assert tuple(r["C"]) == tuple(r["want_C"]), r
        assert r["same_plain"] and r["same_unsharded"], r
        epochs = r["stats"][0]
        assert r["calls"] == {"pmax": epochs, "all_gather_tiled": epochs,
                              "all_gather_rows": 0}, r
    assert {r["N"] for r in got[0]} == {128, 2_048, 10_240}
    assert any(r["gpu_live"] for r in got[0])


LANE_FANOUTS = ("probe_serial_fanout", "probe_wave_fanout", "probe_group_serial_fanout",
                "probe_affinity_wave_fanout", "serve_whatif_fanout", "serve_wave_fanout",
                "sweep_wave_fanout", "sweep_whatif_fanout")


@pytest.mark.cuda
@pytest.mark.parametrize("fanout", LANE_FANOUTS)
def test_lane_block_equals_full_launch(fanout):
    """A scenario mesh's rank runs its block of a fan-out's lanes through the
    same lane kernel: for every block of 2 and of 4 (of S = 8 lanes), the
    block launch equals the same lanes of one launch over all S, bit for bit
    on every output and carry leaf (tests/torch_scenario_cases.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_scenario_cases as SC

    for blocks in (2, 4):
        got = SC.lane_block_cases("cuda", blocks, names=(fanout,))
        assert got == {fanout: {"lanes": 8 // blocks, "same": True}}


# ---- K2 and K4 on thread-block clusters (csrc/cluster.cuh) ----
#
# One lane at N nodes takes the smallest cluster whose threads hold one
# node each (ops/cluster.py), two a thread at 10,240: these N make the rule
# pick every size it can return, none of them (but the first) a multiple of
# its C.
CLUSTER_NODES = ((300, 1), (701, 2), (1_501, 4), (3_001, 8), (5_000, 16), (10_240, 16))


def _unzone_some(nodes):
    """Every seventh node loses its zone label (a node without a zone)."""
    for i, n in enumerate(nodes):
        if i % 7 == 3:
            n["metadata"]["labels"].pop("topology.kubernetes.io/zone", None)
    return nodes


def _edge_pods(n_nodes, start):
    """Pods every K2 scan must get right: one with nothing feasible (too
    large for any node), one forced onto a node (a daemon pin), and a
    replica run spreading ScheduleAnyway on hostname domains (D1 = N + 1)."""
    from open_simulator_torch.utils.synth import synth_pod

    huge = synth_pod(start, cpu_milli=10_000_000)
    pinned = synth_pod(start + 1)
    pin = {"key": "metadata.name", "operator": "In", "values": ["node-00003"]}
    pinned["spec"]["affinity"] = {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchFields": [pin]}]}}}
    host = []
    for i in range(40):
        pod = synth_pod(start + 2 + i, labels={"app": "sa-host"})
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
            "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": "sa-host"}}}]
        host.append(pod)
    return [huge, pinned] + host


def _unpadded_tables(sim, pods):
    """The batch's tables over exactly the cluster's nodes (no phantom node
    padding, so N need not be a multiple of anything) and the seed carry."""
    from open_simulator_torch.simulator.encode import pad_encoder_axes

    bt = pad_encoder_axes(sim.encode_batch_raw(pods))
    tb, seed = sim._to_device(bt)
    return bt, tb, seed


def _two_term_pods(start, n=12):
    """A replica run spreading ScheduleAnyway on hostname and zone at once:
    two ScheduleAnyway slots, and the encoder's widest domain axis."""
    from open_simulator_torch.utils.synth import synth_pod

    out = []
    for i in range(n):
        pod = synth_pod(start + i, labels={"app": "sa-two"})
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": key, "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": "sa-two"}}}
            for key in ("kubernetes.io/hostname", "topology.kubernetes.io/zone")]
        out.append(pod)
    return out


def _k2_cluster(n_nodes, ext, n_pods=260, two_terms=False):
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.utils.synth import synth_extended_cluster

    if ext:
        nodes, pods, _, scs = synth_extended_cluster(n_nodes, n_pods)
    else:
        nodes, pods = synth_cluster(n_nodes, n_pods, hard_predicates=True)
        scs = []
    sim = Simulator(_unzone_some(nodes), device="cuda")
    sim.register_cluster_objects(ResourceTypes(storage_classes=scs))
    half = n_pods // 2
    pods = pods[:half] + _edge_pods(n_nodes, len(pods)) + pods[half:]
    if two_terms:
        pods += _two_term_pods(len(pods))
    bt, tb, seed = _unpadded_tables(sim, pods)
    assert tb.alloc.shape[0] == n_nodes
    return bt, tb, seed, len(pods)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("n_nodes,C", CLUSTER_NODES)
def test_cluster_schedule_batch_matches_plain(n_nodes, C, ext):
    """K2 on one cluster of C CTAs against its plain version: choices and
    every carry field bit for bit, with padded pod rows, a pod with nothing
    feasible, a forced pod, nodes without a zone and a ScheduleAnyway run on
    hostname domains; with EXT the GPU-share and Open-Local branches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    bt, tb, seed, P = _k2_cluster(n_nodes, ext)
    flags = dict(enable_gpu=ext, enable_storage=ext)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    assert not bool(args[2].all())  # padded rows
    kc, kch = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones, **flags)
    pc, pch = K.schedule_batch_plain(tb, seed, *args, bt.n_zones, **flags)
    assert K.schedule_batch.last_shape.C == C
    assert torch.equal(kch, pch), int((kch != pch).sum())
    _same_carry(kc, pc)
    assert int(kch[130]) == -1 and int(kch[131]) == 3  # nothing feasible; forced
    rounds, barriers, steps = K.schedule_batch.last_stats.tolist()
    assert steps == P and steps < rounds <= 3 * steps and barriers <= steps


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("n_nodes", [1_501, 5_000])
def test_cluster_schedule_batch_lanes_match_plain(n_nodes, S):
    """K2 over S lanes (one cluster a lane) against the plain lanes: per-lane
    pod streams with per-lane valid rows, arbitrary node-active masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np

    bt, tb, seed, P = _k2_cluster(n_nodes, False)
    rng = np.random.default_rng(n_nodes + S)
    Pp = bt.pod_group.shape[0]
    pg = np.stack([np.roll(bt.pod_group, 3 * s) for s in range(S)])
    fn = np.stack([np.roll(bt.forced_node, 3 * s) for s in range(S)])
    vd = np.stack([np.roll(bt.valid, 3 * s) & (rng.random(Pp) < 0.9) for s in range(S)])
    active = torch.from_numpy(rng.random((S, n_nodes)) < 0.8).cuda()
    active[0] = True
    cry_s = K.carry_lanes(seed, S)
    args = [torch.from_numpy(a).cuda() for a in (pg, fn, vd)]
    kc, kch = K.schedule_batch_lanes_kernel(tb, cry_s, active, *args, bt.n_zones)
    pc, pch = K.schedule_batch_lanes_plain(tb, cry_s, active, *args, bt.n_zones)
    shape = K.probe_serial_fanout.last_shape
    assert shape.C > 1 and K.probe_serial_fanout.last_stats.shape == (S, 3)
    assert torch.equal(kch, pch), int((kch != pch).sum())
    _same_carry(kc, pc)


def _spread_cluster(n_nodes, device="cuda", two_terms=False):
    """synth_spread_cluster (live ScheduleAnyway on zones, live zoned
    SelectorSpread, two DoNotSchedule terms) with nodes without a zone, a
    ScheduleAnyway run on hostname domains and a ScheduleAnyway zone run of
    pods so large that a node holds one (before it, with `two_terms`, a run
    spreading on hostname and zone at once), on unpadded tables, with its
    spread segments."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.utils.synth import synth_pod, synth_spread_cluster

    nodes, pods, services = synth_spread_cluster(n_nodes, 480)
    sim = Simulator(_unzone_some(nodes), device=device)
    sim.register_cluster_objects(ResourceTypes(services=services))
    big = []
    for i in range(20):
        pod = synth_pod(len(pods) + i, cpu_milli=24_000, labels={"app": "big"})
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": "big"}}}]
        big.append(pod)
    pods = pods + _edge_pods(n_nodes, len(pods) + 20)[2:]
    if two_terms:
        pods += _two_term_pods(len(pods) + 100)
    pods += big
    bt, tb, seed = _unpadded_tables(sim, pods)
    assert tb.alloc.shape[0] == n_nodes
    spread = [s for s in sim._segments(bt, len(pods)) if s[0] == "spread"]
    return bt, tb, seed, spread


def _k4_cases(tb, spread):
    """The first spread segment of each flag pair, the first ScheduleAnyway
    run on hostname domains and the last run (the large pods)."""
    firsts = {}
    for s in spread:
        firsts.setdefault((s[5], s[6]), s)
    assert set(firsts) == {(True, False), (False, True), (False, False)}
    host = [s for s in spread if s[6] and any(
        int(i) >= 0 and tb.counter_dom[int(i)].unique().numel() > 64 for i in tb.sa_t[s[3]])]
    assert host, "no ScheduleAnyway run on hostname domains"
    return list(firsts.values()) + [host[0], spread[-1]]


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,C", CLUSTER_NODES)
def test_cluster_group_serial_matches_plain(n_nodes, C):
    """K4 on one cluster of C CTAs against its plain version on every spread
    flag (sa_live, ss_live, two DoNotSchedule terms) and on a ScheduleAnyway
    run on hostname domains (with padded pod rows), and on the large pods'
    run given more rows than the nodes hold, which stops when nothing is
    feasible: counts and placed bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    bt, tb, seed, spread = _spread_cluster(n_nodes)
    cases = _k4_cases(tb, spread)
    for case, (_, _, m, g, cap1, ss_live, sa_live) in enumerate(cases):
        full = case == len(cases) - 1
        rows = m + n_nodes + 10 if full else m + 5
        valid = torch.arange(rows, device="cuda") < (rows if full else m)
        nz = bt.n_zones if ss_live else 2
        kj, kp = K.schedule_group_serial_kernel(tb, seed, g, valid, cap1, ss_live=ss_live,
                                                sa_live=sa_live, n_zones=nz)
        pj, pp = K.schedule_group_serial_plain(tb, seed, g, valid, cap1, ss_live=ss_live,
                                               sa_live=sa_live, n_zones=nz)
        assert K.schedule_group_serial.last_shape.C == C
        assert torch.equal(kj, pj), (g, ss_live, sa_live, int((kj != pj).sum()))
        assert int(kp) == pp
        rounds, barriers, steps = K.schedule_group_serial.last_stats.tolist()
        assert 2 * steps - 1 <= rounds <= 3 * steps and barriers <= steps
        if full:
            assert pp == n_nodes < rows  # stopped: nothing feasible


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("n_nodes", [1_501, 5_000])
def test_cluster_group_serial_lanes_match_plain(n_nodes, S):
    """K4 over S lanes (one cluster a lane) against the plain lanes on each
    spread flag, arbitrary node-active masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np

    bt, tb, seed, spread = _spread_cluster(n_nodes)
    rng = np.random.default_rng(n_nodes + S)
    active = torch.from_numpy(rng.random((S, n_nodes)) < 0.8).cuda()
    active[0] = True
    cry_s = K.carry_lanes(seed, S)
    for _, _, m, g, cap1, ss_live, sa_live in _k4_cases(tb, spread)[:4]:
        valid = torch.arange(m + 5, device="cuda") < m
        kw = dict(ss_live=ss_live, sa_live=sa_live, n_zones=bt.n_zones if ss_live else 2)
        kj, kp = K.schedule_group_serial_lanes_kernel(tb, cry_s, active, g, valid, cap1, **kw)
        pj, pp = K.schedule_group_serial_lanes_plain(tb, cry_s, active, g, valid, cap1, **kw)
        assert K.probe_group_serial_fanout.last_shape.C > 1
        assert torch.equal(kj, pj), (g, ss_live, sa_live)
        assert torch.equal(kp.cpu(), torch.as_tensor(pp).reshape(kp.shape).cpu().to(kp.dtype))


# ---- K3 and K5 on thread-block clusters (csrc/wave.cu, csrc/affinity_wave.cu) ----


def _wave_cluster(n_nodes, n_pods):
    """synth_cluster's hard-predicate cluster with nodes without a zone, on
    unpadded tables, with its wave segments (cap1 and not)."""
    nodes, pods = synth_cluster(n_nodes, n_pods, hard_predicates=True)
    sim = Simulator(_unzone_some(nodes), device="cuda")
    bt, tb, seed = _unpadded_tables(sim, pods)
    assert tb.alloc.shape[0] == n_nodes
    return tb, seed, [s for s in sim._segments(bt, len(pods)) if s[0] == "wave"]


def _same_wave(tb, seed, g, m, cap1, **kw):
    """K3 against its plain version: counts, placed and loop statistics bit
    for bit; returns the plain statistics."""
    kj, kp, kst = K.schedule_wave_kernel(tb, seed, g, m, cap1, **kw)
    pj, pp, pst = K.schedule_wave_plain(tb, seed, g, m, cap1, **kw)
    assert torch.equal(kj, pj), (g, cap1, kw, int((kj != pj).sum()))
    assert int(kp) == pp, (g, cap1, kw)
    assert kst.tolist() == [pst[k] for k in K.WAVE_STATS], (g, cap1, kw)
    placed, iters, heads, guarded, rounds = K.schedule_wave.last_cluster_stats.tolist()
    assert (placed, iters) == (pp, pst["iterations"]) and rounds >= 3 * iters
    return pst


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,C", CLUSTER_NODES)
def test_cluster_wave_matches_plain(n_nodes, C):
    """K3 on one cluster of C CTAs against its plain version on cap1 and
    other wave segments, at the engine's block and kmax, at block 8 / kmax 16
    (the guard, more iterations) and on waves larger than the cluster holds
    (they stop when nothing is feasible)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tb, seed, waves = _wave_cluster(n_nodes, 2 * n_nodes)
    cap1 = [s for s in waves if s[4]][:2]
    other = [s for s in waves if not s[4]][:2]
    assert cap1 and other
    for _, _, m, g, c1, _ in cap1 + other:
        block = K.wave_block_for(m, n_nodes)
        for blk, kmax in ((block, K.wave_kmax(m, n_nodes, block)), (8, 16)):
            _same_wave(tb, seed, g, m, c1, block=blk, kmax=kmax)
            assert K.schedule_wave.last_shape.C == C
    for _, _, m, g, c1, _ in other:
        _same_wave(tb, seed, g, 50 * n_nodes, c1, block=64)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
def test_cluster_wave_lanes_match_plain(S):
    """K3 over S lanes (one cluster a lane) against the plain lanes, with
    per-lane g, m and cap1 (the sweep's and serve's form) and arbitrary
    node-active masks: counts, placed and loop statistics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np

    n_nodes = 1_501
    tb, seed, waves = _wave_cluster(n_nodes, 2 * n_nodes)
    rng = np.random.default_rng(S)
    active = torch.from_numpy(rng.random((S, n_nodes)) < 0.8).cuda()
    active[0] = True
    cry_s = K.carry_lanes(seed, S)
    picks = [waves[i % len(waves)] for i in range(S)]
    g_s = torch.tensor([p[3] for p in picks], dtype=torch.int32).cuda()
    m_s = torch.tensor([0 if s == 1 else p[2] for s, p in enumerate(picks)],
                       dtype=torch.int32).cuda()
    c_s = torch.tensor([p[4] for p in picks], dtype=torch.bool).cuda()
    block = K.wave_block_for(int(m_s.max()), n_nodes)
    kw = dict(block=block, kmax=K.wave_kmax(int(m_s.max()), n_nodes, block))
    kj, kp, kst = K.schedule_wave_lanes_kernel(tb, cry_s, active, g_s, m_s, c_s, **kw)
    pj, pp, pst = K.schedule_wave_lanes_plain(tb, cry_s, active, g_s, m_s, c_s, **kw)
    assert K.probe_wave_fanout.last_shape.C >= 1
    assert torch.equal(kj, pj)
    assert torch.equal(kp.cpu(), torch.as_tensor(pp).reshape(kp.shape).cpu().to(kp.dtype))
    assert torch.equal(kst.cpu(), torch.as_tensor(pst).reshape(kst.shape).cpu().to(kst.dtype))


@pytest.mark.cuda
def test_cluster_wave_at_large_node_count():
    """K3 at bench.py's node count, a cluster of 16 with each CTA's rows in
    global scratch: a cap1 and another wave bit for bit against the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import test_torch_cluster_shape as CS

    n_nodes = LARGE_NODES[0]
    tb, seed, waves = _wave_cluster(n_nodes, 3_000)
    cases = [s for s in waves if s[4]][:1] + [s for s in waves if not s[4]][:1]
    assert len(cases) == 2
    for _, _, m, g, c1, _ in cases:
        block = K.wave_block_for(m, n_nodes)
        _same_wave(tb, seed, g, m, c1, block=block, kmax=K.wave_kmax(m, n_nodes, block))
        shape = K.schedule_wave.last_shape
        assert shape.C == 16 and shape.smem < 4 * 8 * shape.chunk  # the rows in scratch
        assert shape.smem == CS.wave_smem_model("k3", n_nodes, 16, 2, 2)


def _affinity_cluster(n_nodes, n_pods):
    """synth_affinity_cluster (zone self-affinity with its bootstrap, a
    hostname and a zone DoNotSchedule spread, zone self-anti-affinity, the
    zoned Service-backed `svc-web`) with nodes without a zone, on unpadded
    tables, with its affinity segments."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.utils.synth import synth_affinity_cluster

    nodes, pods, services = synth_affinity_cluster(n_nodes, n_pods)
    sim = Simulator(_unzone_some(nodes), device="cuda")
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt, tb, seed = _unpadded_tables(sim, pods)
    assert tb.alloc.shape[0] == n_nodes
    return bt, tb, seed, [s for s in sim._segments(bt, len(pods)) if s[0] == "affinity"]


def _same_affinity(bt, tb, seed, seg, **kw):
    """K5 against its plain version on one affinity segment: counts, placed
    and epoch statistics bit for bit; returns the plain statistics."""
    _, _, m, g, cap1, ss_live = seg
    kw = dict(ss_live=ss_live, n_zones=bt.n_zones if ss_live else 2, **kw)
    kj, kp, kst = K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1, **kw)
    pj, pp, pst = K.schedule_affinity_wave_plain(tb, seed, g, m, cap1, **kw)
    assert torch.equal(kj, pj), (g, kw, int((kj != pj).sum()))
    assert int(kp) == pp, (g, kw)
    assert kst.tolist() == [pst[k] for k in K.AFFINITY_STATS], (g, kw)
    placed, epochs, heads, multi, rounds = K.schedule_affinity_wave.last_cluster_stats.tolist()
    assert (placed, epochs) == (pp, pst["epochs"]) and rounds >= epochs
    return pst


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,C", CLUSTER_NODES)
def test_cluster_affinity_wave_matches_plain(n_nodes, C):
    """K5 on one cluster of C CTAs against its plain version on each of the
    five affinity shapes (bootstrap, DoNotSchedule levels on hostname and
    zone domains, self-anti-affinity past the zones, zoned SelectorSpread's
    head fallbacks), at the engine's block and at block 2 (depth caps and
    the cut bind, more multi-pod epochs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    bt, tb, seed, aff = _affinity_cluster(n_nodes, 1_000)
    totals = dict.fromkeys(K.AFFINITY_STATS, 0)
    for seg in aff[:5]:
        for blk in (K.wave_block_for(seg[2], n_nodes), 2):
            st = _same_affinity(bt, tb, seed, seg, block=blk)
            assert K.schedule_affinity_wave.last_shape.C == C
            for k in K.AFFINITY_STATS:
                totals[k] += st[k]
    assert totals["head_fallbacks"] > 0 and totals["multi_rounds"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
def test_cluster_affinity_wave_lanes_match_plain(S):
    """K5 over S lanes (one cluster a lane) against the plain lanes on each
    affinity shape, arbitrary node-active masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np

    n_nodes = 1_501
    bt, tb, seed, aff = _affinity_cluster(n_nodes, 1_000)
    rng = np.random.default_rng(S)
    active = torch.from_numpy(rng.random((S, n_nodes)) < 0.8).cuda()
    active[0] = True
    cry_s = K.carry_lanes(seed, S)
    for _, _, m, g, cap1, ss_live in aff[:5]:
        kw = dict(ss_live=ss_live, n_zones=bt.n_zones if ss_live else 2,
                  block=K.wave_block_for(m, n_nodes))
        kj, kp, kst = K.schedule_affinity_wave_lanes_kernel(tb, cry_s, active, g, m, cap1, **kw)
        pj, pp, pst = K.schedule_affinity_wave_lanes_plain(tb, cry_s, active, g, m, cap1, **kw)
        assert K.probe_affinity_wave_fanout.last_shape.C >= 1
        assert torch.equal(kj, pj), (g, ss_live)
        assert torch.equal(kp.cpu(), torch.as_tensor(pp).reshape(kp.shape).cpu().to(kp.dtype))
        assert torch.equal(kst.cpu(), torch.as_tensor(pst).reshape(kst.shape).cpu().to(kst.dtype))


@pytest.mark.cuda
def test_cluster_affinity_wave_at_large_node_count():
    """K5 at bench.py's node count, a cluster of 16 with each CTA's node
    rows and live rows in global scratch: each affinity shape bit for bit
    against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import test_torch_cluster_shape as CS

    n_nodes = LARGE_NODES[0]
    bt, tb, seed, aff = _affinity_cluster(n_nodes, 200)
    for seg in aff[:5]:
        _same_affinity(bt, tb, seed, seg, block=K.wave_block_for(seg[2], n_nodes))
        shape = K.schedule_affinity_wave.last_shape
        assert shape.C == 16 and shape.smem < 4 * 11 * shape.chunk  # the rows in scratch
        Z = bt.n_zones if seg[5] else 2
        assert shape.smem == CS.wave_smem_model("k5", n_nodes, 16, Z, seed.counter.shape[1])


# bench.py's node count (every per-node row on chip) and one past the chip
# (a CTA's rows in global scratch), with a run that spreads ScheduleAnyway
# on hostname and zone at once: two ScheduleAnyway slots and the encoder's
# widest domain axis (D1 131,073 and 262,145), marks far too wide for round 1
LARGE_NODES = (100_352, 140_000)


def _smem_model_holds(shape, kernel, n_nodes, tb, seed, n_zones):
    """The chosen shape against tests/test_torch_cluster_shape.py's model of
    the library's shared memory, and where the rows live."""
    import test_torch_cluster_shape as CS

    Ss, D1 = tb.sa_t.shape[1], seed.counter.shape[1]
    assert Ss >= 2 and D1 == CS.padded_d1(n_nodes)
    assert shape.C == 16
    assert shape.smem == CS.smem_model(kernel, n_nodes, 16, Ss, max(2, n_zones), D1)
    rows_on_chip = shape.smem > 4 * CS.ROW_WORDS[kernel] * shape.chunk
    assert rows_on_chip == (n_nodes == LARGE_NODES[0])


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("n_nodes", LARGE_NODES)
def test_cluster_schedule_batch_at_large_node_counts(n_nodes, ext):
    """K2 on a cluster of 16 at bench.py's node count and past the per-node
    rows' room on chip, with two ScheduleAnyway slots on the padded hostname
    axis: choices and every carry field bit for bit against the plain
    version, and the shared memory the library asked for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    bt, tb, seed, P = _k2_cluster(n_nodes, ext, n_pods=40, two_terms=True)
    flags = dict(enable_gpu=ext, enable_storage=ext)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    kc, kch = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones, **flags)
    pc, pch = K.schedule_batch_plain(tb, seed, *args, bt.n_zones, **flags)
    _smem_model_holds(K.schedule_batch.last_shape, "k2_ext" if ext else "k2", n_nodes, tb, seed,
                      bt.n_zones)
    assert torch.equal(kch, pch), int((kch != pch).sum())
    _same_carry(kc, pc)
    assert int(kch[20]) == -1 and int(kch[21]) == 3  # nothing feasible; forced
    rounds, barriers, steps = K.schedule_batch.last_stats.tolist()
    assert steps == P and barriers >= 40 + 12  # the wide marks' rounds


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes", LARGE_NODES)
def test_cluster_group_serial_at_large_node_counts(n_nodes):
    """K4 on a cluster of 16 at bench.py's node count and past the per-node
    rows' room on chip: every spread flag, the hostname run and the run on
    hostname and zone at once, counts and placed bit for bit against the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    bt, tb, seed, spread = _spread_cluster(n_nodes, two_terms=True)
    two = [s for s in spread if s[6] and int((tb.sa_t[s[3]] >= 0).sum()) == 2]
    assert two, "no run with two ScheduleAnyway terms"
    for _, _, m, g, cap1, ss_live, sa_live in _k4_cases(tb, spread)[:-1] + two[:1]:
        valid = torch.arange(m + 5, device="cuda") < m
        nz = bt.n_zones if ss_live else 2
        kj, kp = K.schedule_group_serial_kernel(tb, seed, g, valid, cap1, ss_live=ss_live,
                                                sa_live=sa_live, n_zones=nz)
        pj, pp = K.schedule_group_serial_plain(tb, seed, g, valid, cap1, ss_live=ss_live,
                                               sa_live=sa_live, n_zones=nz)
        _smem_model_holds(K.schedule_group_serial.last_shape, "k4", n_nodes, tb, seed, nz)
        assert torch.equal(kj, pj), (g, ss_live, sa_live, int((kj != pj).sum()))
        assert int(kp) == pp


# ---- K3c and K7 on thread-block clusters (csrc/aggregate_commit.cu, csrc/explain.cu) ----


def _commit_counts(tb, groups, seed_int):
    """Seeded per-node counts (0-3 copies on about half the nodes) for each
    group, on the card."""
    import numpy as np

    rng = np.random.default_rng(seed_int)
    N = int(tb.alloc.shape[0])
    return [(g, torch.from_numpy((rng.integers(0, 4, size=N) * (rng.random(N) < 0.5))
                                 .astype(np.int32)).cuda()) for g in groups]


def _carry_copy(cry):
    return K.Carry(*(t.clone() for t in cry))


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("n_nodes,C", CLUSTER_NODES)
def test_cluster_commit_matches_plain(n_nodes, C, ext):
    """K3c on one cluster of C CTAs against its plain version: every carry
    field bit for bit on seeded counts of every group (with EXT the GPU
    groups also with gpu_live: the device ledger replayed), from the seed
    carry and from a committed one, and the input carry unchanged (the
    kernel writes a new carry out of place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import test_torch_cluster_shape as CS

    bt, tb, seed, P = _k2_cluster(n_nodes, ext)
    groups = sorted({int(g) for g in bt.pod_group[:P]})
    gpu_groups = [g for g in groups if float(tb.grp_gpu_mem[g]) > 0]
    assert not ext or gpu_groups
    cry = seed
    for i, (g, j) in enumerate(_commit_counts(tb, groups, n_nodes)):
        for gpu_live in (False, True) if g in gpu_groups else (False,):
            before = _carry_copy(cry)
            kc = K.aggregate_commit_kernel(tb, cry, g, j, gpu_live)
            shape = K.aggregate_commit.last_shape
            assert shape.C == C and shape.smem == CS.k3c_smem_model()
            _same_carry(cry, before)
            _same_carry(kc, K.aggregate_commit_plain(tb, cry, g, j, gpu_live))
            assert all(a.data_ptr() != b.data_ptr() for a, b in zip(kc, cry))
        if i % 3 == 0:
            cry = kc  # the next groups commit on top of this one


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
def test_cluster_commit_lanes_match_plain(S):
    """K3c over S lanes (one cluster a lane) against the plain lanes, with
    one group for every lane and with a group per lane, and with gpu_live on
    the extended cluster: every carry field of every lane bit for bit, the
    input carries unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np

    for ext in (False, True):
        bt, tb, seed, P = _k2_cluster(1_501, ext)
        groups = sorted({int(g) for g in bt.pod_group[:P]})
        rng = np.random.default_rng(S + ext)
        N = int(tb.alloc.shape[0])
        cry_s = K.carry_lanes(seed, S)
        j_s = torch.from_numpy((rng.integers(0, 4, size=(S, N)) * (rng.random((S, N)) < 0.5))
                               .astype(np.int32)).cuda()
        g_s = torch.tensor([groups[s % len(groups)] for s in range(S)], dtype=torch.int32).cuda()
        gpu = next((g for g in groups if float(tb.grp_gpu_mem[g]) > 0), None)
        cases = [(groups[0], False), (g_s, False)] + ([(gpu, True)] if ext else [])
        for g, gpu_live in cases:
            before = _carry_copy(cry_s)
            kc = K.aggregate_commit_lanes_kernel(tb, cry_s, g, j_s, gpu_live)
            assert K.aggregate_commit_lanes.last_shape.C >= 1
            _same_carry(cry_s, before)
            _same_carry(kc, K.aggregate_commit_lanes_plain(tb, cry_s, g, j_s, gpu_live))


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("n_nodes,C", CLUSTER_NODES)
def test_cluster_explain_matches_plain(n_nodes, C, ext):
    """K7 on one cluster of C CTAs against plain explain_pod packed, bit for
    bit, on every group of a batch with a pod that fits nowhere, a forced
    pod, nodes without a zone and a ScheduleAnyway run on hostname domains;
    against the seed carry, a mid-run carry, a full carry (no node feasible:
    an empty F everywhere) and a carry with room only on the last CTA's
    slice (every other CTA without a feasible node)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import test_torch_cluster_shape as CS

    bt, tb, seed, P = _k2_cluster(n_nodes, ext)
    flags = dict(enable_gpu=ext, enable_storage=ext)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    mid, _ = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones, **flags)
    full = seed._replace(requested=tb.alloc.clone())
    last = (C - 1) * -(-n_nodes // C)
    only_last = seed._replace(requested=torch.where(
        (torch.arange(n_nodes, device="cuda") < last)[:, None], tb.alloc, seed.requested))
    groups = sorted({int(g) for g in bt.pod_group[:P]})
    Ss, Z = int(tb.sa_t.shape[1]), max(2, bt.n_zones)
    seen = {"empty": 0, "last_only": 0}
    for cry in (seed, mid, full, only_last):
        for g in groups:
            for forced in (-1, (7 * g + 3) % n_nodes):
                got = K.explain_kernel(tb, cry, g, forced, True, bt.n_zones, **flags)
                shape = K.explain_jit.last_shape
                assert shape.C == C and shape.smem == CS.k7_smem_model(C, Z, Ss)
                _same_explain(got, K.explain_pod(tb, cry, g, forced, True, bt.n_zones, **flags))
                f = got[0] > 0
                seen["empty"] += not bool(f.any())
                seen["last_only"] += bool(f[last:].any()) and not bool(f[:last].any())
    assert seen["empty"] > 0 and (C == 1 or seen["last_only"] > 0), seen


# ---- K1 and K14 on thread-block clusters (csrc/feasibility.cu, csrc/commit_sharded.cu) ----


def _k1_want_C(n_nodes, ext):
    """The C ops/cluster.py `choose` gives K1 over N nodes (3N items with
    EXT) on a card where every size is resident: the fewest items a thread,
    then the smaller C."""
    from open_simulator_torch.ops import cluster

    items = (3 if ext else 1) * n_nodes
    best = min(cluster.nodes_per_thread(items, c) for c in cluster.SIZES)
    return min(c for c in cluster.SIZES if cluster.nodes_per_thread(items, c) == best)


def _k1_carries(tb, seed, mid):
    """The CPU model's carries (tests/test_torch_cluster_feasibility.py):
    seed, mid-run, full, DoNotSchedule rows rising column by column, every
    required-affinity row empty, and its only count in the last real
    domain."""
    D1 = seed.counter.shape[1]
    dns_ids = torch.unique(tb.dns_t[tb.dns_t >= 0]).long()
    aff_ids = torch.unique(tb.req_aff_t[tb.req_aff_t >= 0]).long()
    ramp = mid.counter.clone()
    ramp[dns_ids] = torch.arange(1, D1 + 1, dtype=torch.float32, device=ramp.device)[None, :]
    empty = mid.counter.clone()
    empty[aff_ids] = 0.0
    last = empty.clone()
    last[aff_ids, D1 - 2] = 1.0
    return {"seed": seed, "mid": mid, "full": mid._replace(requested=tb.alloc.clone()),
            "ramp": mid._replace(counter=ramp), "aff_empty": mid._replace(counter=empty),
            "aff_last": mid._replace(counter=last)}


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("n_nodes,C", CLUSTER_NODES)
def test_cluster_feasibility_matches_plain(n_nodes, C, ext):
    """K1 on one cluster (C CTAs over N nodes; with EXT, over 3N items)
    against the plain `feasibility`: the packed buffer and every stage, bit
    for bit, on the spread (zone and hostname DoNotSchedule terms), affinity
    (required self-affinity) and hard clusters, or the extended one with
    EXT, against the CPU model's carries (a mid-run one, a full one,
    DoNotSchedule rows rising column by column, required-affinity rows
    empty and with their only count in the last real domain), with the
    encoded eligible sets and with none, forced and not, with and without
    the DoNotSchedule filter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np
    import test_torch_cluster_shape as CS

    flags = dict(enable_gpu=ext, enable_storage=ext)
    if ext:
        clusters = [_k2_cluster(n_nodes, True)[:3]]
    else:
        clusters = [_spread_cluster(n_nodes)[:3], _affinity_cluster(n_nodes, 400)[:3],
                    _k2_cluster(n_nodes, False)[:3]]
    want_C = _k1_want_C(n_nodes, ext)
    assert ext or want_C == C
    seen = {"boot": 0, "no_boot": 0, "hostname": 0}
    for bt, tb, seed in clusters:
        P = int(bt.valid.sum())
        pg, fn = (torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node))
        vd = torch.from_numpy(bt.valid & (np.arange(bt.valid.shape[0]) < P // 2)).cuda()
        mid, _ = K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones, **flags)
        tables = {"encoded": tb, "no_eligible": tb._replace(dns_edom=torch.zeros_like(tb.dns_edom))}
        groups = sorted({int(g) for g in bt.pod_group[:P]})
        Sd, R = int(tb.dns_t.shape[1]), int(tb.alloc.shape[1])
        seen["hostname"] += int(tb.dns_edom.sum(dim=2).max()) > n_nodes // 2
        for kind, cry in _k1_carries(tb, seed, mid).items():
            for tname, t in tables.items():
                if tname == "no_eligible" and kind != "ramp":
                    continue
                for g in groups:
                    for forced, dns in ((-1, True), ((7 * g + 3) % n_nodes, True), (-1, False)):
                        rows = K.feasibility_packed(t, cry, g, forced, True, **flags) if dns \
                            else None
                        kf, ks = K.feasibility_kernel(t, cry, g, forced, True, include_dns=dns,
                                                      **flags)
                        shape = K.feasibility_jit.last_shape
                        assert shape.C == want_C
                        assert shape.smem == CS.k1_smem_model(want_C, Sd, R, ext)
                        pf, ps = K.feasibility(t, cry, g, forced, True, include_dns=dns,
                                               **flags)
                        if rows is not None:
                            assert torch.equal(rows, K.pack_feasibility(pf, ps)), (kind, g)
                        assert torch.equal(kf, pf), (kind, tname, g, forced, dns)
                        for k in K.STAGE_KEYS:
                            assert torch.equal(ks[k], ps[k]), (kind, tname, g, k)
                        if kind == "aff_empty" and bool(ps["pod_affinity"].all()):
                            seen["boot"] += bool(tb.grp_aff_self[g])
                        if kind == "aff_last" and bool(tb.grp_aff_self[g]):
                            seen["no_boot"] += not bool(ps["pod_affinity"].all())
    assert ext or (seen["boot"] > 0 and seen["no_boot"] > 0 and seen["hostname"] > 0), seen


# K14's rows stage is one-shot: its ties go to the most CTAs that keep
# kernels.K14_MIN_CHUNK (32) nodes each, so these blocks give every C
K14_BLOCKS = ((40, 1), (100, 2), (200, 4), (400, 8), (5_000, 16), (10_240, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,C", K14_BLOCKS)
def test_cluster_sharded_commit_on_two_ranks(tmp_path, n_nodes, C):
    """K14 on two ranks that share cuda:0 over gloo, each holding a block of
    n_nodes nodes (its rows stage one cluster of C CTAs, as `last_shape`
    reports), against `aggregate_commit_sharded_plain` on the same ranks
    and the unsharded K3c, every carry field of the block bit for bit, on
    seeded counts of every group of the hard and the extended cluster (the
    GPU groups also with gpu_live), from the seed carry and from committed
    ones: one all_gather_rows a call, the block's input carry unchanged and
    no output aliasing it (tests/torch_mesh_cases.py `card_k14_blocks`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_mesh_cases as MC
    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    build.library()  # build once, before the ranks load it
    got = run_ranks(MC.card_k14_blocks, 2, str(tmp_path), args=(n_nodes,), device="cuda",
                    backend="gloo")
    for recs in got:
        assert recs and any(r["gpu_live"] for r in recs)
        for r in recs:
            assert r["C"] == C, r
            assert r["calls"] == {"pmax": 0, "all_gather_tiled": 0, "all_gather_rows": 1}, r
            assert r["same_plain"] and r["same_unsharded"], r
            assert r["input_kept"] and r["fresh"], r


# ---- preemption and a custom scheduler configuration on the card ----------------


def _preempt_case(name):
    import torch_preempt_cases as P

    if name.startswith("cut"):
        return P.preempt_cut(64)
    build = (P.SCENARIOS.get(name) or P.EXTRA_CASES[name])[0]
    return build()


def _preempt_names():
    import torch_preempt_cases as P

    return sorted(P.SCENARIOS) + sorted(P.EXTRA_CASES) + ["cut64"]


@pytest.mark.cuda
@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
@pytest.mark.parametrize("name", _preempt_names())
def test_preemption_on_the_card_equals_the_cpu(name, use_waves, tmp_path, monkeypatch):
    """Every preemption case of tests/test_torch_preemption.py (the 15
    scenarios of tests/test_preemption.py, the ledger and metric cases, the
    64-node cut of chip_smoke.py's `preempt`) through the Simulator on the
    card against the same on the CPU: placements, `preempted`, reasons,
    nominations, annotations and counters. On the card every fit is exactly
    one K1 launch, and each PostFilter pass launches K1 once for the
    preemptor's reasons and once a fit, and nowhere else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import torch_preempt_cases as P
    from open_simulator_torch.api.schedconfig import parse_scheduler_config
    from open_simulator_torch.simulator import preemption as PRE

    nodes, calls, kw = _preempt_case(name)
    kw = dict(kw, use_waves=use_waves)
    if "sched_yaml" in kw:
        path = tmp_path / "sched.yaml"
        path.write_text(kw.pop("sched_yaml"))
        kw["sched_config"] = parse_scheduler_config(str(path))
    cpu, _ = P.run_port("cpu", nodes, calls, **kw)
    orig_fits, orig_try = PRE._fits, PRE.try_preempt
    tally = {"fits": 0, "passes": 0, "k1": 0}

    def fits(sim, g, node_i, placed2):
        before = K.feasibility_jit.launches
        out = orig_fits(sim, g, node_i, placed2)
        assert K.feasibility_jit.launches == before + 1
        tally["fits"] += 1
        return out

    def try_preempt(sim, pod):
        before = K.feasibility_jit.launches
        out = orig_try(sim, pod)
        tally["k1"] += K.feasibility_jit.launches - before
        tally["passes"] += 1
        return out

    monkeypatch.setattr(PRE, "_fits", fits)
    monkeypatch.setattr(PRE, "try_preempt", try_preempt)
    card, _ = P.run_port("cuda", nodes, calls, **kw)
    assert card == cpu
    assert tally["k1"] == tally["passes"] + tally["fits"]
    if card["preempted"]:
        assert tally["fits"] > 0


def _sched_sim(nodes, services=(), scs=()):
    """A Simulator on the card under tests/golden/torch_port_sched_hard_waves.sched.yaml
    (custom score weights, NodePorts and TaintToleration disabled)."""
    import os

    from open_simulator_torch.api.schedconfig import parse_scheduler_config
    from open_simulator_torch.core.types import ResourceTypes

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "torch_port_sched_hard_waves.sched.yaml")
    sim = Simulator(nodes, device="cuda", sched_config=parse_scheduler_config(path))
    sim.register_cluster_objects(ResourceTypes(services=list(services),
                                               storage_classes=list(scs)))
    assert sim.score_w != K.DEFAULT_WEIGHTS and sim.filter_flags != K.DEFAULT_FILTERS
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hard", "extended"])
def test_custom_config_serial_kernels_match_plain(kind):
    """K2, K1 and K7 under sched_hard_waves' weights and flags (and its
    encoder filter in the tables) against their plain versions: choices and
    carry, every stage, every explain row; the extended cluster with the
    GPU-share and Open-Local branches on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from open_simulator_torch.utils.synth import synth_extended_cluster

    scs = []
    if kind == "hard":
        nodes, pods = synth_cluster(256, 1500, hard_predicates=True)
    else:
        nodes, pods, _, scs = synth_extended_cluster(256, 1200)
    sim = _sched_sim(nodes, scs=scs)
    wf = dict(w=sim.score_w, filters=sim.filter_flags)
    ext = kind == "extended"
    flags = dict(enable_gpu=ext, enable_storage=ext)
    bt, tb, seed, segs = _segments_of(sim, pods)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    kc, kch = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones, **wf, **flags)
    pc, pch = K.schedule_batch_plain(tb, seed, *args, bt.n_zones, **wf, **flags)
    assert torch.equal(kch, pch)
    _same_carry(kc, pc)
    N = int(tb.alloc.shape[0])
    for g in sorted({int(g) for g in bt.pod_group[:len(pods)]}):
        for cry in (seed, kc):
            kf, ks = K.feasibility_kernel(tb, cry, g, -1, True, filters=sim.filter_flags, **flags)
            pf, ps = K.feasibility(tb, cry, g, -1, True, filters=sim.filter_flags, **flags)
            assert torch.equal(kf, pf), g
            for k in K.STAGE_KEYS:
                assert torch.equal(ks[k], ps[k]), (g, k)
            for forced in (-1, (7 * g + 3) % N):
                got = K.explain_kernel(tb, cry, g, forced, True, bt.n_zones, **flags, **wf)
                _same_explain(got, K.explain_pod(tb, cry, g, forced, True, bt.n_zones, **flags,
                                                 **wf))


@pytest.mark.cuda
def test_custom_config_route_kernels_match_plain():
    """K3 + K3c, K4 + K3c and K5 + K3c under sched_hard_waves' weights and
    flags against their plain versions, on every wave, group-serial and
    affinity segment of the hard, spread and affinity clusters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from open_simulator_torch.utils.synth import synth_affinity_cluster, synth_spread_cluster

    seen = set()
    nodes, pods = synth_cluster(256, 3000, hard_predicates=True)
    sp_nodes, sp_pods, sp_svc = synth_spread_cluster(256, 1200)
    af_nodes, af_pods, af_svc = synth_affinity_cluster(256, 1200)
    for nodes, pods, svc in ((nodes, pods, []), (sp_nodes, sp_pods, sp_svc),
                             (af_nodes, af_pods, af_svc)):
        sim = _sched_sim(nodes, services=svc)
        wf = dict(w=sim.score_w, filters=sim.filter_flags)
        bt, tb, seed, segs = _segments_of(sim, pods)
        for seg in segs[:24]:
            kind, _, m, g, cap1 = seg[:5]
            if kind == "wave":
                block = K.wave_block_for(m, sim.na.N)
                kw = dict(block=block, kmax=K.wave_kmax(m, sim.na.N, block), **wf)
                kj, kp, kst = K.schedule_wave_kernel(tb, seed, g, m, cap1, **kw)
                pj, pp, pst = K.schedule_wave_plain(tb, seed, g, m, cap1, **kw)
                assert kst.tolist() == [pst[k] for k in K.WAVE_STATS]
            elif kind == "spread":
                nz = bt.n_zones if seg[5] else 2
                valid = torch.arange(m + 5, device="cuda") < m
                kw = dict(ss_live=seg[5], sa_live=seg[6], n_zones=nz, **wf)
                kj, kp = K.schedule_group_serial_kernel(tb, seed, g, valid, cap1, **kw)
                pj, pp = K.schedule_group_serial_plain(tb, seed, g, valid, cap1, **kw)
            elif kind == "affinity":
                nz = bt.n_zones if seg[5] else 2
                kw = dict(ss_live=seg[5], block=K.wave_block_for(m, sim.na.N), n_zones=nz, **wf)
                kj, kp, kst = K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1, **kw)
                pj, pp, pst = K.schedule_affinity_wave_plain(tb, seed, g, m, cap1, **kw)
                assert kst.tolist() == [pst[k] for k in K.AFFINITY_STATS]
            else:
                continue
            assert torch.equal(kj, pj), (kind, g)
            assert int(kp) == pp
            _same_carry(K.aggregate_commit_kernel(tb, seed, g, kj),
                        K.aggregate_commit_plain(tb, seed, g, pj))
            seen.add(kind)
    assert seen == {"wave", "spread", "affinity"}


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 8])
def test_custom_config_lane_kernels_match_plain_fanouts(S):
    """Each probe fan-out (K2-K5 over lanes, then K3c over lanes) under
    sched_hard_waves' weights and flags against its plain fan-out, one
    segment of each kind of a session built with that configuration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import os

    from open_simulator_torch.api.schedconfig import parse_scheduler_config

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "torch_port_sched_hard_waves.sched.yaml")
    ses, kinds = _capacity_session(16, 600, sched_config=parse_scheduler_config(path))
    sim = ses._sim
    wf = dict(w=sim.score_w, filters=sim.filter_flags)
    assert wf["w"] != K.DEFAULT_WEIGHTS
    active = _lane_masks(ses, S)
    for kind, seg in sorted(kinds.items()):
        kfn, pfn, args, kw = _fanout_cases(ses, seg, active, wf)
        kc, kp = kfn(*args, **kw)
        pc, pp = pfn(*args, **kw)
        assert torch.equal(kp, pp), kind
        _same_carry(kc, pc)
