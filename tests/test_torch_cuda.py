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
