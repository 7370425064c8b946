"""Module parity: the PyTorch port's kernels against open_simulator_tpu.ops.kernels
on the same BatchTables and on a mid-run carry handed across as numpy
(`carry_from_numpy`). Every output is compared exactly: masks, floored or
copied score components, f32 counts, i32 choices."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import open_simulator_tpu.core.types as jax_types
from open_simulator_torch.ops import kernels as tk
from open_simulator_tpu.models.workloads import (
    expand_workloads_excluding_daemonsets,
    generate_valid_pods_from_app,
)
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from open_simulator_tpu.utils.synth import synth_cluster
from torch_port_cases import CASES, build

NO_PLUGINS = dict(enable_gpu=False, enable_storage=False)


def _synthetic():
    nodes, pods = synth_cluster(64, 640, hard_predicates=True)
    return JaxSimulator(nodes, use_mesh=False), pods


def _extended():
    # GPU-share and Open-Local tables staged (the branches themselves are
    # held in test_torch_extended.py)
    from open_simulator_torch.utils.synth import synth_extended_cluster

    nodes, pods, _, scs = synth_extended_cluster(48, 400)
    sim = JaxSimulator(nodes, use_mesh=False)
    sim.register_cluster_objects(jax_types.ResourceTypes(storage_classes=scs))
    return sim, pods


def _case(name):
    def make():
        cluster, apps = build(jax_types, CASES[name]())
        sim = JaxSimulator(cluster.nodes, use_mesh=False)
        sim.register_cluster_objects(cluster)
        sim.schedule_pods(expand_workloads_excluding_daemonsets(cluster))
        pods = generate_valid_pods_from_app(apps[0].name, apps[0].resource, cluster.nodes)
        return sim, pods
    return make


BATCHES = {"synthetic": _synthetic, "extended": _extended,
           "topology_spread": _case("topology_spread"),
           "scoring": _case("scoring_and_workloads"), "interpod": _case("interpod_affinity")}


@pytest.fixture(scope="module", params=sorted(BATCHES))
def batch(request):
    """(bt, JAX tables, JAX mid-run carry, port tables, port mid-run carry, P, half)."""
    sim, pods = BATCHES[request.param]()
    bt = sim.encode_batch(pods)
    jt, jc = sim._to_device(bt)
    P = len(pods)
    half = P // 2
    valid = np.arange(bt.pod_group.shape[0]) < half
    mid, _ = jk.schedule_batch(jt, jc, bt.pod_group, bt.forced_node, valid,
                               n_zones=bt.n_zones, **NO_PLUGINS)
    tt = tk.tables_from_batch(bt, "cpu")
    tc = tk.carry_from_numpy({k: np.asarray(v) for k, v in mid._asdict().items()}, "cpu")
    return bt, jt, mid, tt, tc, P, half


def _groups(bt, P):
    return sorted({int(g) for g in bt.pod_group[:P]})


def test_staging_matches_jax_fields(batch):
    bt, jt, jc, tt, tc, _, _ = batch
    assert tk.Tables._fields == jk.Tables._fields
    assert tk.Carry._fields == jk.Carry._fields
    for f in tk.Tables._fields:
        a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    seed = tk.carry_from_batch(bt, "cpu")
    for f in tk.Carry._fields:
        assert np.array_equal(getattr(seed, f).numpy(), getattr(bt, "seed_" + f)), f
        assert np.array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f))), f


def test_feasibility_matches_jax(batch):
    bt, jt, jc, tt, tc, P, _ = batch
    for g in _groups(bt, P):
        for forced in (-1, g % bt.alloc.shape[0]):
            jf, js = jk.feasibility_jit(jt, jc, jnp.int32(g), jnp.int32(forced),
                                        jnp.asarray(True), **NO_PLUGINS)
            tf, ts = tk.feasibility(tt, tc, g, forced, True)
            assert np.array_equal(np.asarray(jf), tf.numpy())
            assert set(js) == set(ts) == set(tk.STAGE_KEYS)
            for k in tk.STAGE_KEYS:
                assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), (g, k)


_jax_components = jax.jit(jk.score_components, static_argnames=("n_zones", "enable_storage", "w"))


def test_score_components_match_jax(batch):
    bt, jt, jc, tt, tc, P, _ = batch
    N = bt.alloc.shape[0]
    for g in _groups(bt, P):
        jf, _ = jk.feasibility_jit(jt, jc, jnp.int32(g), jnp.int32(-1), jnp.asarray(True),
                                   **NO_PLUGINS)
        want = _jax_components(jt, jc, jnp.int32(g), jf, bt.n_zones, enable_storage=False)
        got = tk.score_components(tt, tc, g, torch.from_numpy(np.asarray(jf)), bt.n_zones)
        assert list(got) == list(tk.COMPONENT_ORDER) == list(jk.COMPONENT_ORDER)
        for k in tk.COMPONENT_ORDER:
            a = np.broadcast_to(np.asarray(want[k], np.float32), (N,))
            b = np.broadcast_to(torch.as_tensor(got[k], dtype=torch.float32).numpy(), (N,))
            assert np.array_equal(a, b), (g, k)
        total = tk.components_total(got)
        assert np.array_equal(np.asarray(jk.components_total(want)),
                              np.broadcast_to(total.numpy(), (N,)))


_jax_commit = jax.jit(jk.commit, static_argnames=("enable_gpu", "enable_storage"))


def test_commit_matches_jax(batch):
    bt, jt, jc, tt, tc, P, _ = batch
    N = bt.alloc.shape[0]
    for i, g in enumerate(_groups(bt, P)):
        choice = (7 * i + 3) % N
        for do in (True, False):
            want = _jax_commit(jt, jc, jnp.int32(g), jnp.int32(choice), jnp.asarray(do),
                               **NO_PLUGINS)
            got = tk.commit(tt, tc, g, torch.tensor(choice, dtype=torch.int32), do)
            for f in tk.Carry._fields:
                assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy()), f


def test_schedule_batch_matches_jax(batch):
    bt, jt, jc, tt, tc, P, half = batch
    pad = bt.pod_group.shape[0]
    pg = np.concatenate([bt.pod_group[half:], np.zeros(half, np.int32)])
    fn = np.concatenate([bt.forced_node[half:], np.full(half, -1, np.int32)])
    vd = np.arange(pad) < P - half
    want_c, want_ch = jk.schedule_batch(jt, jc, pg, fn, vd, n_zones=bt.n_zones, **NO_PLUGINS)
    launches = tk.launch_counts()
    got_c, got_ch = tk.schedule_batch(tt, tc, torch.from_numpy(pg), torch.from_numpy(fn),
                                      torch.from_numpy(vd), bt.n_zones)
    assert tk.launch_counts() == launches  # CPU tensors take the plain version
    assert got_ch.dtype == torch.int32
    assert np.array_equal(np.asarray(want_ch), got_ch.numpy())
    for f in tk.Carry._fields:
        assert np.array_equal(np.asarray(getattr(want_c, f)), getattr(got_c, f).numpy()), f


def test_topology_weight_is_correctly_rounded():
    x = torch.arange(0, 1 << 16, dtype=torch.float32)
    want = np.log(x.numpy().astype(np.float64) + 2.0).astype(np.float32)
    assert np.array_equal(tk.topology_weight(x).numpy(), want)

