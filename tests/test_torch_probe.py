"""The capacity probe's kernels: the PyTorch port against the JAX package.

On the same session tables (both packages' ProbeSession over one
synth_capacity_cluster input, which routes a segment of every kind), each
plain fan-out of the port (`probe_*_fanout` on CPU tensors) equals the JAX
fan-out bit for bit at S = 1, 2 and 8 lanes, with prefix masks and one
arbitrary mask: placed per lane and every Carry field of every lane. The
port's `extend_tables_plain` equals the JAX `_extend_tables_impl`, field by
field, with and without a phantom pad. Tolerance zero throughout.
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
from open_simulator_tpu.parallel.mesh import _extend_tables_impl
from open_simulator_tpu.simulator.probe import ProbeSession as JaxSession


@pytest.fixture(scope="module")
def sessions():
    """(jax session, port session): 16 base nodes, 400 pods, room for 40
    template copies; both sessions encode the same segments."""
    base, tpl, pods, services = synth_capacity_cluster(16, 400)
    js = JaxSession.try_build(base, tpl, copy.deepcopy(pods),
                              jax_types.ResourceTypes(services=services), n_new=40, mesh=None)
    ts = TorchSession.try_build(base, tpl, copy.deepcopy(pods),
                                torch_types.ResourceTypes(services=services), n_new=40,
                                device="cpu")
    assert js is not None and ts is not None
    assert js._segs == ts._segs
    assert {s[0] for s in ts._segs} == {"serial", "wave", "spread", "affinity"}
    return js, ts


def lane_masks(ses, S):
    """S node-active masks: prefixes of growing candidate counts, the last
    lane (for S > 1) an arbitrary mask over the real columns."""
    a = np.zeros((S, ses._n_pad), bool)
    for i in range(S):
        a[i, :ses.n_base + (ses.n_new * i) // max(S - 1, 1)] = True
    if S > 1:
        rng = np.random.default_rng(11)
        a[-1] = rng.random(ses._n_pad) < 0.6
        a[-1, ses.n_base + ses.n_new:] = False
    return a


def run_both(js, ts, seg, active):
    """The JAX and the port fan-out of one segment from the seed carry:
    ((jax carry_s, jax placed_s), (port carry_s, port placed_s))."""
    S = active.shape[0]
    bt = ts._bt
    n_real = ts.n_base + ts.n_new
    jcarry = jk.Carry(*(jnp.asarray(np.broadcast_to(a, (S,) + a.shape)) for a in js._seeds))
    tcarry = tk.carry_lanes(ts._seed, S)
    ja, ta = jnp.asarray(active), torch.from_numpy(active)
    kind, start, length = seg[:3]
    if kind == "serial":
        pad = bucket_capped(length, 2048)
        pg = np.zeros(pad, np.int32)
        pg[:length] = bt.pod_group[start:start + length]
        fn = np.full(pad, -1, np.int32)
        fn[:length] = bt.forced_node[start:start + length]
        vd = np.arange(pad) < length
        gpu, storage = ts._flags
        j = jk.probe_serial_fanout(js._tables, jcarry, ja, jnp.asarray(pg), jnp.asarray(fn),
                                   jnp.asarray(vd), n_zones=bt.n_zones, enable_gpu=gpu,
                                   enable_storage=storage)
        t = tk.probe_serial_fanout(ts._tables, tcarry, ta, torch.from_numpy(pg),
                                   torch.from_numpy(fn), torch.from_numpy(vd),
                                   n_zones=bt.n_zones, enable_gpu=gpu, enable_storage=storage)
        return j, t
    g, cap1 = seg[3], bool(seg[4])
    block = tk.wave_block_for(length, n_real)
    if kind == "wave":
        kw = dict(gpu_live=seg[5], block=block, kmax=tk.wave_kmax(length, n_real, block))
        j = jk.probe_wave_fanout(js._tables, jcarry, ja, jnp.int32(g), jnp.int32(length),
                                 jnp.asarray(cap1), **kw)
        return j, tk.probe_wave_fanout(ts._tables, tcarry, ta, g, length, cap1, **kw)
    if kind == "spread":
        vd = np.arange(bucket_capped(length, 2048)) < length
        kw = dict(ss_live=seg[5], sa_live=seg[6], n_zones=bt.n_zones if seg[5] else 2)
        j = jk.probe_group_serial_fanout(js._tables, jcarry, ja, jnp.int32(g), jnp.asarray(vd),
                                         jnp.asarray(cap1), **kw)
        return j, tk.probe_group_serial_fanout(ts._tables, tcarry, ta, g, torch.from_numpy(vd),
                                               cap1, **kw)
    kw = dict(ss_live=seg[5], block=block, n_zones=bt.n_zones if seg[5] else 2)
    j = jk.probe_affinity_wave_fanout(js._tables, jcarry, ja, jnp.int32(g), jnp.int32(length),
                                      jnp.asarray(cap1), **kw)
    return j, tk.probe_affinity_wave_fanout(ts._tables, tcarry, ta, g, length, cap1, **kw)


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("kind", ["serial", "wave", "spread", "affinity"])
def test_plain_fanouts_equal_jax_fanouts(sessions, kind, S):
    js, ts = sessions
    seg = next(s for s in ts._segs if s[0] == kind)
    (jc, jp), (tc, tp) = run_both(js, ts, seg, lane_masks(ts, S))
    assert np.array_equal(np.asarray(jp), tp.numpy()), kind
    for f in tk.Carry._fields:
        assert np.array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy()), f


def test_cap1_wave_fanout_equals_jax(sessions):
    """The hostname self-anti-affinity block: a cap-1 wave whose lanes run
    out of nodes at small candidates."""
    js, ts = sessions
    seg = next(s for s in ts._segs if s[0] == "wave" and s[4])
    (jc, jp), (tc, tp) = run_both(js, ts, seg, lane_masks(ts, 8))
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert len(set(tp.tolist())) > 1  # the lanes differ: small candidates place fewer
    for f in tk.Carry._fields:
        assert np.array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy()), f


def test_fanout_lane_is_single_lane_on_masked_tables(sessions):
    """Lane s of a plain fan-out is the single-lane plain kernel on the
    tables with lane s's mask folded into static_mask."""
    _, ts = sessions
    active = torch.from_numpy(lane_masks(ts, 4))
    _, _, m, g, cap1, ss_live = next(s for s in ts._segs if s[0] == "affinity")
    block = tk.wave_block_for(m, ts.n_base + ts.n_new)
    j_s, p_s, st_s = tk.schedule_affinity_wave_lanes_plain(
        ts._tables, tk.carry_lanes(ts._seed, 4), active, g, m, cap1, ss_live, block=block)
    for s in range(4):
        j, p, st = tk.schedule_affinity_wave_plain(tk._mask_active(ts._tables, active[s]),
                                                   ts._seed, g, m, cap1, ss_live, block=block)
        assert torch.equal(j_s[s], j) and int(p_s[s]) == p
        assert st_s[s].tolist() == [st[k] for k in tk.AFFINITY_STATS]


@pytest.mark.parametrize("pad", [0, 29])
def test_extend_tables_plain_equals_jax(sessions, pad):
    js, ts = sessions
    n_real = ts.n_base + ts.n_new
    k = 2 * ts._n_pad - n_real - pad
    sentinel = ts._bt.seed_counter.shape[1] - 1
    want = _extend_tables_impl(js._tables, n_real, k, ts.n_base, n_real + k + pad, sentinel)
    got = tk.extend_tables_plain(ts._tables, n_real, k, ts.n_base, n_real + k + pad, sentinel)
    for f in tk.Tables._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_extend_tables_rejects_a_bad_extension(sessions):
    _, ts = sessions
    with pytest.raises(ValueError):
        tk.extend_tables_plain(ts._tables, ts._n_pad + 1, 4, ts.n_base, ts._n_pad + 5, 0)


def test_cpu_dispatch_launches_nothing_and_counts_each_kernel_apart(sessions):
    """On CPU tensors a fan-out and the extension take their plain versions
    and count no launch; K3c over lanes and K6 have counters of their own."""
    _, ts = sessions
    _, _, m, g, cap1, gpu_live = next(s for s in ts._segs if s[0] == "wave")
    block = tk.wave_block_for(m, ts.n_base + ts.n_new)
    tk.reset_launch_counts()
    tk.probe_wave_fanout(ts._tables, tk.carry_lanes(ts._seed, 2),
                         torch.from_numpy(lane_masks(ts, 2)), g, m, cap1, gpu_live, block=block)
    tk.extend_tables_on_device(ts._tables, n_real=ts.n_base + ts.n_new, k=1,
                               template_col=ts.n_base, n_pad_new=2 * ts._n_pad,
                               sentinel=ts._bt.seed_counter.shape[1] - 1)
    counts = tk.launch_counts()
    assert {"aggregate_commit", "aggregate_commit_lanes", "probe_wave_fanout",
            "extend_tables"} <= counts.keys()
    assert not any(counts.values())
    assert tk.wave_stats()["iterations"] > 0  # the lanes' loop statistics, summed
