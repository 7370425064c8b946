"""The serve and sweep fan-outs: the PyTorch port against the JAX package.

On the same session tables (both packages' ProbeSession over one
synth_capacity_cluster input), each plain fan-out of the port
(`serve_whatif_fanout`, `serve_wave_fanout`, `sweep_wave_fanout`,
`sweep_whatif_fanout` on CPU tensors) equals the JAX fan-out bit for bit at
S = 1, 2 and 8 lanes, with prefix masks and one arbitrary mask: placed,
per-segment counts or per-pod choices, and every Carry field of every lane.
The inputs cover padding lanes (a repeat of lane 0), segments with m = 0, a
chunk that mixes m = 1 with the largest m (shared block and kmax), invalid
rows in dense and sparse union batches, and per-lane pod streams of
different lengths. Tolerance zero throughout.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import open_simulator_torch.core.types as torch_types
import open_simulator_tpu.core.types as jax_types
from open_simulator_torch.ops import kernels as tk
from open_simulator_torch.simulator.encode import bucket_capped
from open_simulator_torch.simulator.probe import ProbeSession as TorchSession
from open_simulator_torch.utils.synth import synth_capacity_cluster
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.probe import ProbeSession as JaxSession

SIZES = [1, 2, 8]


@pytest.fixture(scope="module")
def sessions():
    """(jax session, port session): 16 base nodes, 400 pods of every
    segment kind, room for 40 template copies."""
    base, tpl, pods, services = synth_capacity_cluster(16, 400)
    js = JaxSession.try_build(base, tpl, copy.deepcopy(pods),
                              jax_types.ResourceTypes(services=services), n_new=40, mesh=None)
    ts = TorchSession.try_build(base, tpl, copy.deepcopy(pods),
                                torch_types.ResourceTypes(services=services), n_new=40,
                                device="cpu")
    assert js is not None and ts is not None
    assert js._segs == ts._segs
    return js, ts


def lane_masks(ses, S):
    """Prefix masks of growing candidate counts; for S > 1 the last lane an
    arbitrary mask over the real columns."""
    a = np.zeros((S, ses._n_pad), bool)
    for i in range(S):
        a[i, :ses.n_base + (ses.n_new * i) // max(S - 1, 1)] = True
    if S > 1:
        rng = np.random.default_rng(11)
        a[-1] = rng.random(ses._n_pad) < 0.6
        a[-1, ses.n_base + ses.n_new:] = False
    return a


def carries(js, ts, S):
    jc = jk.Carry(*(jnp.asarray(np.broadcast_to(a, (S,) + a.shape)) for a in js._seeds))
    return jc, tk.carry_lanes(ts._seed, S)


def wave_groups(ts):
    """(g, cap1) of every wave segment, plain ones first."""
    out = []
    for seg in ts._segs:
        if seg[0] == "wave" and (seg[3], bool(seg[4])) not in out:
            out.append((seg[3], bool(seg[4])))
    assert any(c for _, c in out) and any(not c for _, c in out)
    return sorted(out, key=lambda gc: gc[1])


def assert_carries_equal(jc, tc):
    for f in tk.Carry._fields:
        assert np.array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy()), f


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("S", SIZES)
def test_serve_whatif_fanout_equals_jax(sessions, S, sparse):
    js, ts = sessions
    bt = ts._bt
    n_rows = 240
    pad = bucket_capped(n_rows, 2048)
    pg = np.zeros(pad, np.int32)
    fn = np.full(pad, -1, np.int32)
    pg[:n_rows] = bt.pod_group[:n_rows]
    fn[:n_rows] = bt.forced_node[:n_rows]
    valid = np.zeros((S, pad), bool)
    real = max(1, S - 1) if S > 2 else S  # the last lane of 8 is a padding lane
    for s in range(real):
        if sparse:  # a few short requests in a long union
            start = (s * 29) % (n_rows - 12)
            valid[s, start:start + 3 + s] = True
        else:  # consecutive requests tiling the union
            lo, hi = s * n_rows // real, (s + 1) * n_rows // real
            valid[s, lo:hi] = True
    valid[real:] = valid[0]
    active = lane_masks(ts, S)
    jcar, tcar = carries(js, ts, S)
    jc, jp = jk.serve_whatif_fanout(js._tables, jcar, jnp.asarray(active), jnp.asarray(pg),
                                    jnp.asarray(fn), jnp.asarray(valid), n_zones=bt.n_zones,
                                    enable_gpu=False, enable_storage=False)
    tc, tp = tk.serve_whatif_fanout(ts._tables, tcar, torch.from_numpy(active), pg, fn, valid,
                                    n_zones=bt.n_zones, enable_gpu=False, enable_storage=False)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert int(tp.sum()) > 0
    assert_carries_equal(jc, tc)


@pytest.mark.parametrize("S", SIZES)
def test_serve_wave_fanout_equals_jax(sessions, S):
    """Per-lane groups, replica counts (one lane m = 0, one m = 1 beside the
    largest m, so small lanes run at the shared block and kmax) and cap1."""
    js, ts = sessions
    groups = wave_groups(ts)
    lanes = [(groups[s % len(groups)][0], [300, 0, 1, 120, 45, 7, 260, 300][s],
              groups[s % len(groups)][1]) for s in range(S)]
    g_s = np.array([g for g, _, _ in lanes], np.int32)
    m_s = np.array([m for _, m, _ in lanes], np.int32)
    cap1_s = np.array([c for _, _, c in lanes], bool)
    if S == 8:  # the last lane pads: a repeat of lane 0
        g_s[-1], m_s[-1], cap1_s[-1] = g_s[0], m_s[0], cap1_s[0]
    n_real = ts.n_base + ts.n_new
    block = tk.wave_block_for(int(m_s.max()), n_real)
    kmax = tk.wave_kmax(int(m_s.max()), n_real, block)
    active = lane_masks(ts, S)
    jcar, tcar = carries(js, ts, S)
    jc, jp = jk.serve_wave_fanout(js._tables, jcar, jnp.asarray(active), jnp.asarray(g_s),
                                  jnp.asarray(m_s), jnp.asarray(cap1_s), block=block, kmax=kmax)
    tc, tp = tk.serve_wave_fanout(ts._tables, tcar, torch.from_numpy(active), g_s, m_s, cap1_s,
                                  block=block, kmax=kmax)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert_carries_equal(jc, tc)
    if S == 8:
        assert int(tp[1]) == 0 and int(tp[2]) == 1
        # lane s is the single-lane plain wave on lane s's masked tables
        for s in (2, 3):
            j, p, _ = tk.schedule_wave_plain(tk._mask_active(ts._tables, torch.from_numpy(
                active[s])), ts._seed, int(g_s[s]), int(m_s[s]), bool(cap1_s[s]), block=block,
                kmax=kmax)
            assert p == int(tp[s])


@pytest.mark.parametrize("S", SIZES)
def test_sweep_wave_fanout_equals_jax(sessions, S):
    """K = 4 chained segments per lane, the last of each lane a padding
    segment (m = 0), groups and counts differing by lane."""
    js, ts = sessions
    groups = wave_groups(ts)
    rng = np.random.default_rng(5 + S)
    K = 4
    g_sk = np.zeros((S, K), np.int32)
    m_sk = np.zeros((S, K), np.int32)
    cap1_sk = np.zeros((S, K), bool)
    for s in range(S):
        for k in range(K - 1 - (s % 2)):  # odd lanes have two padding segments
            g, c = groups[int(rng.integers(len(groups)))]
            g_sk[s, k], m_sk[s, k], cap1_sk[s, k] = g, int(rng.integers(1, 160)), c
    n_real = ts.n_base + ts.n_new
    block = tk.wave_block_for(int(m_sk.max()), n_real)
    kmax = tk.wave_kmax(int(m_sk.max()), n_real, block)
    active = lane_masks(ts, S)
    jcar, tcar = carries(js, ts, S)
    jc, jcounts = jk.sweep_wave_fanout(js._tables, jcar, jnp.asarray(active), jnp.asarray(g_sk),
                                       jnp.asarray(m_sk), jnp.asarray(cap1_sk), block=block,
                                       kmax=kmax)
    tc, tcounts = tk.sweep_wave_fanout(ts._tables, tcar, torch.from_numpy(active), g_sk, m_sk,
                                       cap1_sk, block=block, kmax=kmax)
    assert tcounts.shape == (S, K, ts._n_pad)
    assert np.array_equal(np.asarray(jcounts), tcounts.numpy())
    assert int(tcounts[:, K - 1].sum()) == 0
    assert_carries_equal(jc, tc)


@pytest.mark.parametrize("S", SIZES)
def test_sweep_whatif_fanout_equals_jax(sessions, S):
    """A pod stream per lane: rows of the session batch in another order,
    of another length, the tail invalid."""
    js, ts = sessions
    bt = ts._bt
    n = len(bt.pod_group)
    rng = np.random.default_rng(17 + S)
    lengths = [int(rng.integers(20, 200)) for _ in range(S)]
    pad = bucket_capped(max(lengths), 2048)
    pg = np.zeros((S, pad), np.int32)
    fn = np.full((S, pad), -1, np.int32)
    vd = np.zeros((S, pad), bool)
    for s, L in enumerate(lengths):
        rows = np.sort(rng.choice(n, size=L, replace=False)) if s % 2 else np.arange(L)
        pg[s, :L] = bt.pod_group[rows]
        fn[s, :L] = bt.forced_node[rows]
        vd[s, :L] = True
    active = lane_masks(ts, S)
    jcar, tcar = carries(js, ts, S)
    jc, jch = jk.sweep_whatif_fanout(js._tables, jcar, jnp.asarray(active), jnp.asarray(pg),
                                     jnp.asarray(fn), jnp.asarray(vd), n_zones=bt.n_zones,
                                     enable_gpu=False, enable_storage=False)
    tc, tch = tk.sweep_whatif_fanout(ts._tables, tcar, torch.from_numpy(active), pg, fn, vd,
                                     n_zones=bt.n_zones, enable_gpu=False, enable_storage=False)
    assert np.array_equal(np.asarray(jch), tch.numpy())
    assert bool((tch[~torch.from_numpy(vd)] == -1).all())
    assert_carries_equal(jc, tc)
