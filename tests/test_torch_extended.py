"""GPU-share and Open-Local: the PyTorch port against the JAX package.

Module parity, exact (every output is a bool, an i32, or an f32 count or
byte total): the plain `storage_alloc` on random tables (byte-granular
capacities, three volume groups per node), the GPU filter and the device
ledger commit on byte-granular device totals, `feasibility`,
`score_components` and `commit` with both branches on against the jitted
JAX functions, and `schedule_wave(gpu_live=True)` with its aggregate commit.
End to end: every GPU-share and Open-Local scenario of the JAX package's
tests on both routes (placements, reasons, gpu-index annotations, the
node ledgers and the final device and storage state), and the reference's
demo_1 with all four apps against `tests/golden/demo1_placements.json`. A
small `synth_extended_cluster` on both routes is in test_torch_golden.py.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import open_simulator_torch.core.types as torch_types
import open_simulator_tpu.core.types as jax_types
from open_simulator_torch.models import workloads as torch_workloads
from open_simulator_torch.ops import kernels as tk
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_torch.utils.synth import synth_extended_cluster
from open_simulator_tpu.models import workloads as jax_workloads
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.encode import plugin_flags
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from torch_port_cases import build, extended_cases, outcome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_INDEX = "alibabacloud.com/gpu-index"
NODE_ANNOS = ("simon/node-gpu-share", "simon/node-local-storage")
LEDGERS = ("dev_used", "vg_req", "sdev_alloc")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_carry(want, got):
    for f in tk.Carry._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# -------------------------------------------------------------- a real batch ----

def _extended_batch():
    """(bt, JAX tables, JAX mid-run carry, port tables, port mid-run carry, P):
    the unbound pods of synth_extended_cluster(48, 600), the first half
    scheduled serially by JAX with both branches on."""
    nodes, pods, _, scs = synth_extended_cluster(48, 600)
    sim = JaxSimulator(nodes, use_mesh=False)
    sim.register_cluster_objects(jax_types.ResourceTypes(storage_classes=scs))
    bt = sim.encode_batch(pods)
    assert plugin_flags(bt) == (True, True)
    jt, jc = sim._to_device(bt)
    P = len(pods)
    valid = np.arange(bt.pod_group.shape[0]) < P // 2
    mid, _ = jk.schedule_batch(jt, jc, bt.pod_group, bt.forced_node, valid, n_zones=bt.n_zones,
                               enable_gpu=True, enable_storage=True)
    tt = tk.tables_from_batch(bt, "cpu")
    tc = tk.carry_from_numpy({k: np.asarray(v) for k, v in mid._asdict().items()}, "cpu")
    return bt, jt, mid, tt, tc, P


@pytest.fixture(scope="module")
def ext():
    return _extended_batch()


def _groups(bt, P):
    return sorted({int(g) for g in bt.pod_group[:P]})


_jax_feas = jax.jit(jk.feasibility, static_argnames=("enable_gpu", "enable_storage",
                                                     "include_dns", "include_interpod",
                                                     "filters"))
_jax_components = jax.jit(jk.score_components, static_argnames=("n_zones", "enable_storage", "w"))
_jax_commit = jax.jit(jk.commit, static_argnames=("enable_gpu", "enable_storage"))
_jax_storage = jax.jit(jk.storage_alloc)
_jax_aggregate = jax.jit(jk._aggregate_commit, static_argnames=("gpu_live",))


def test_batch_has_every_extended_shape(ext):
    bt, _, jc, _, _, P = ext
    gs = _groups(bt, P)
    assert any(bt.grp_gpu_pre[g] for g in gs)                       # (c)
    assert any(bt.grp_gpu_num[g] == 2 for g in gs)                  # (b)
    assert any((bt.grp_lvm_vg[g] > 0).any() for g in gs)            # (e), named VG
    assert any(((bt.grp_lvm_size[g] > 0) & (bt.grp_lvm_vg[g] == 0)).any() for g in gs)
    assert any((bt.grp_sdev_media[g] == 2).any() for g in gs)       # (f), ssd
    assert bt.dev_total.shape[1] == 8 and bt.vg_cap.shape[1] == 2
    assert np.asarray(jc.dev_used).any() and np.asarray(jc.vg_req).any()
    assert np.asarray(jc.sdev_alloc).any()


def test_view_takes_the_extended_tables(ext):
    # the CUDA view's dtype and shape checks accept every staged table
    _, _, _, tt, tc, _ = ext
    v = tk._view(tt, tc, 2, tk.DEFAULT_WEIGHTS, tk.DEFAULT_FILTERS, True, True)
    assert (v.MAXDEV, v.MAXVG, v.f_gpu, v.f_storage) == (8, 2, 1, 1)


def test_storage_alloc_matches_jax_on_the_batch(ext):
    bt, jt, jc, tt, tc, P = ext
    for g in _groups(bt, P):
        want = _jax_storage(jt, jc, jnp.int32(g))
        got = tk.storage_alloc(tt, tc, g)
        assert bool(want["has_storage"]) == got["has_storage"]
        for k in ("ok", "lvm_add", "dev_add", "raw"):
            assert np.array_equal(np.asarray(want[k]), _np(got[k])), (g, k)


@pytest.mark.parametrize("forced", [False, True])
def test_feasibility_matches_jax_with_both_branches(ext, forced):
    bt, jt, jc, tt, tc, P = ext
    N = bt.alloc.shape[0]
    for g in _groups(bt, P):
        f = g % N if forced else -1
        jf, js = _jax_feas(jt, jc, jnp.int32(g), jnp.int32(f), jnp.asarray(True),
                           enable_gpu=True, enable_storage=True)
        tf, ts = tk.feasibility(tt, tc, g, f, True, enable_gpu=True, enable_storage=True)
        assert np.array_equal(np.asarray(jf), tf.numpy()), g
        for k in tk.STAGE_KEYS:
            assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), (g, k)
    # the branches fail nodes on this carry
    stages = [tk.feasibility(tt, tc, g, -1, True, enable_gpu=True, enable_storage=True)[1]
              for g in _groups(bt, P)]
    assert any(not s["gpu"].all() for s in stages)
    assert any(not s["storage"].all() for s in stages)


def test_score_components_match_jax_with_storage(ext):
    bt, jt, jc, tt, tc, P = ext
    N = bt.alloc.shape[0]
    moved = False
    seed_j = jk.Carry(*(jnp.asarray(getattr(bt, "seed_" + f)) for f in jk.Carry._fields))
    for jcry, tcry in ((seed_j, tk.carry_from_batch(bt, "cpu")), (jc, tc)):
        for g in _groups(bt, P):
            jf, _ = _jax_feas(jt, jcry, jnp.int32(g), jnp.int32(-1), jnp.asarray(True),
                              enable_gpu=True, enable_storage=True)
            want = _jax_components(jt, jcry, jnp.int32(g), jf, bt.n_zones, enable_storage=True)
            got = tk.score_components(tt, tcry, g, torch.from_numpy(np.array(jf)), bt.n_zones,
                                      enable_storage=True)
            for k in tk.COMPONENT_ORDER:
                a = np.broadcast_to(np.asarray(want[k], np.float32), (N,))
                b = np.broadcast_to(torch.as_tensor(got[k], dtype=torch.float32).numpy(), (N,))
                assert np.array_equal(a, b), (g, k)
            moved |= bool(np.asarray(want["openlocal"]).any())
    assert moved  # the Open-Local term is not the constant 0 here


def test_commit_matches_jax_with_both_branches(ext):
    bt, jt, jc, tt, tc, P = ext
    N = bt.alloc.shape[0]
    for i, g in enumerate(_groups(bt, P)):
        jf, _ = _jax_feas(jt, jc, jnp.int32(g), jnp.int32(-1), jnp.asarray(True),
                          enable_gpu=True, enable_storage=True)
        feas = np.flatnonzero(np.asarray(jf))
        choice = int(feas[i % len(feas)]) if len(feas) else (7 * i + 3) % N
        for do in (True, False):
            want = _jax_commit(jt, jc, jnp.int32(g), jnp.int32(choice), jnp.asarray(do),
                               enable_gpu=True, enable_storage=True)
            got = tk.commit(tt, tc, g, torch.tensor(choice, dtype=torch.int32), do,
                            enable_gpu=True, enable_storage=True)
            _same_carry(want, got)


def test_schedule_batch_matches_jax_with_both_branches(ext):
    bt, jt, jc, tt, tc, P = ext
    pad = bt.pod_group.shape[0]
    half = P // 2
    pg = np.concatenate([bt.pod_group[half:], np.zeros(half, np.int32)])[:pad]
    fn = np.concatenate([bt.forced_node[half:], np.full(half, -1, np.int32)])[:pad]
    vd = np.arange(pad) < P - half
    want_c, want_ch = jk.schedule_batch(jt, jc, pg, fn, vd, n_zones=bt.n_zones,
                                        enable_gpu=True, enable_storage=True)
    got_c, got_ch = tk.schedule_batch(tt, tc, torch.from_numpy(pg), torch.from_numpy(fn),
                                      torch.from_numpy(vd), bt.n_zones, enable_gpu=True,
                                      enable_storage=True)
    assert np.array_equal(np.asarray(want_ch), got_ch.numpy())
    assert (np.asarray(want_ch)[:P - half] < 0).any()  # some pods fail
    _same_carry(want_c, got_c)


# ------------------------------------------------------------- random tables ----

def _random_tables(seed: int):
    """(JAX tables, JAX carry, port tables, port carry) of a small real batch
    whose GPU and storage tables are replaced by random ones made with numpy:
    byte-granular device totals, VG capacities and sizes, three volume
    groups with Binpack demand spread over them, named and unnamed LVM
    slots, and ssd/hdd devices, some allocated."""
    from test_torch_kernels import _synthetic

    sim, pods = _synthetic()
    bt = sim.encode_batch(pods)
    jt, jc = sim._to_device(bt)
    rng = np.random.default_rng(seed)
    N, G = bt.alloc.shape[0], bt.static_mask.shape[0]
    V, Dv, M, SL, SD = 4, 6, 8, 4, 4
    f32 = np.float32
    vg_cap = rng.integers(1 << 30, 1 << 39, size=(N, V)).astype(f32)
    vg_cap[:, 3] *= rng.random(N) < 0.5  # absent VGs
    vg_nameid = rng.integers(1, 4, size=(N, V)).astype(np.int32)
    vg_req = (vg_cap * rng.random((N, V)) * (rng.random((N, V)) < 0.7)).astype(f32)
    sdev_cap = rng.integers(1 << 30, 1 << 38, size=(N, Dv)).astype(f32)
    sdev_cap[:, 0] = sdev_cap[:, 1]  # equal capacities: the "last" device tie
    sdev_media = rng.integers(0, 3, size=(N, Dv)).astype(np.int32)
    sdev_alloc = (rng.random((N, Dv)) < 0.25).astype(f32)
    dev_total = rng.integers(1 << 33, 1 << 35, size=(N, M)).astype(f32)
    dev_total *= rng.random((N, M)) < 0.8
    dev_used = (dev_total * rng.random((N, M)) * (rng.random((N, M)) < 0.6)).astype(f32)
    grp_lvm_size = rng.integers(1 << 28, 1 << 37, size=(G, SL)).astype(f32)
    grp_lvm_size *= rng.random((G, SL)) < 0.7
    grp_lvm_vg = (rng.integers(0, 4, size=(G, SL)) * (rng.random((G, SL)) < 0.3)).astype(np.int32)
    grp_sdev_size = rng.integers(1 << 28, 1 << 37, size=(G, SD)).astype(f32)
    grp_sdev_size *= rng.random((G, SD)) < 0.5
    # slots by descending size (the encoder sorts them ascending)
    grp_sdev_size = np.sort(grp_sdev_size, axis=1)[:, ::-1].copy()
    grp_sdev_media = np.where(grp_sdev_size > 0, rng.integers(1, 3, size=(G, SD)),
                              0).astype(np.int32)
    grp_gpu_mem = rng.integers(1 << 30, 1 << 34, size=G).astype(f32) * (rng.random(G) < 0.8)
    grp_gpu_num = rng.integers(0, 4, size=G).astype(f32)
    grp_gpu_pre = rng.random(G) < 0.2
    grp_gpu_take = (rng.integers(0, 2, size=(G, M)) * grp_gpu_pre[:, None]).astype(f32)
    tables = dict(vg_cap=vg_cap, vg_nameid=vg_nameid, sdev_cap=sdev_cap, sdev_media=sdev_media,
                  dev_total=dev_total, grp_lvm_size=grp_lvm_size, grp_lvm_vg=grp_lvm_vg,
                  grp_sdev_size=grp_sdev_size, grp_sdev_media=grp_sdev_media,
                  grp_gpu_mem=grp_gpu_mem, grp_gpu_num=grp_gpu_num, grp_gpu_pre=grp_gpu_pre,
                  grp_gpu_take=grp_gpu_take)
    carry = dict(dev_used=dev_used, vg_req=vg_req, sdev_alloc=sdev_alloc)
    jt = jt._replace(**{k: jnp.asarray(v) for k, v in tables.items()})
    jc = jc._replace(**{k: jnp.asarray(v) for k, v in carry.items()})
    tt = tk.tables_from_batch(bt, "cpu")._replace(**{k: torch.from_numpy(v)
                                                       for k, v in tables.items()})
    tc = tk.carry_from_batch(bt, "cpu")._replace(**{k: torch.from_numpy(v)
                                                      for k, v in carry.items()})
    return jt, jc, tt, tc, G


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_storage_alloc_matches_jax_on_random_tables(seed):
    jt, jc, tt, tc, G = _random_tables(seed)
    three_vg_raw = 0
    for g in range(G):
        want = _jax_storage(jt, jc, jnp.int32(g))
        got = tk.storage_alloc(tt, tc, g)
        for k in ("ok", "lvm_add", "dev_add", "raw"):
            assert np.array_equal(np.asarray(want[k]), _np(got[k])), (g, k)
        used = (got["lvm_add"] > 0).sum(dim=1) >= 3
        three_vg_raw += int((used & (got["raw"] > 0)).sum())
    assert three_vg_raw > 0  # the three-VG Binpack score sum was exercised


@pytest.mark.parametrize("seed", [0, 1])
def test_gpu_branches_match_jax_on_byte_granular_devices(seed):
    jt, jc, tt, tc, G = _random_tables(seed)
    N = tt.alloc.shape[0]
    for g in range(G):
        jf, js = _jax_feas(jt, jc, jnp.int32(g), jnp.int32(-1), jnp.asarray(True),
                           enable_gpu=True, enable_storage=True)
        tf, ts = tk.feasibility(tt, tc, g, -1, True, enable_gpu=True, enable_storage=True)
        for k in ("gpu", "storage"):
            assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), (g, k)
        for choice in (g % N, (5 * g + 1) % N):
            want = _jax_commit(jt, jc, jnp.int32(g), jnp.int32(choice), jnp.asarray(True),
                               enable_gpu=True, enable_storage=True)
            got = tk.commit(tt, tc, g, torch.tensor(choice, dtype=torch.int32), True,
                            enable_gpu=True, enable_storage=True)
            for f in LEDGERS:
                assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy()), f


# -------------------------------------------------------------- gpu_live waves ----

def _gpu_wave_segments(bt, sim, P):
    return [s for s in sim._segments(bt, P) if s[0] == "wave" and s[5]]


def test_schedule_wave_gpu_live_matches_jax(ext):
    bt, jt, jc, tt, tc, P = ext
    nodes, pods, _, scs = synth_extended_cluster(48, 600)
    sim = JaxSimulator(nodes, use_mesh=False)
    sim.register_cluster_objects(jax_types.ResourceTypes(storage_classes=scs))
    sim.encode_batch(pods)
    segs = _gpu_wave_segments(bt, sim, P)
    assert {int(bt.grp_gpu_num[s[3]]) for s in segs} == {1, 2}
    N = bt.alloc.shape[0]
    for _, _, m, g, cap1, _ in segs:
        for block, kmax in ((jk.wave_block_for(m, N), jk.wave_kmax(m, N, jk.wave_block_for(m, N))),
                            (8, 16)):
            want_c, want_j, want_p = jk.schedule_wave(jt, jc, np.int32(g), np.int32(m),
                                                      np.bool_(cap1), gpu_live=True,
                                                      block=block, kmax=kmax)
            got_c, got_j, got_p = tk.schedule_wave(tt, tc, g, m, bool(cap1), block=block,
                                                   kmax=kmax, gpu_live=True)
            assert np.array_equal(np.asarray(want_j), got_j.numpy()), (g, block)
            assert int(want_p) == got_p
            _same_carry(want_c, got_c)


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_commit_gpu_ledger_matches_jax(seed):
    jt, jc, tt, tc, G = _random_tables(seed)
    N = tt.alloc.shape[0]
    rng = np.random.default_rng(seed)
    for g in range(G):
        j = (rng.integers(0, 4, size=N) * (rng.random(N) < 0.5)).astype(np.int32)
        want = _jax_aggregate(jt, jc, jnp.int32(g), jnp.asarray(j), gpu_live=True)
        got = tk.aggregate_commit(tt, tc, g, torch.from_numpy(j), gpu_live=True)
        _same_carry(want, got)


# ------------------------------------------------------------------ end to end ----

def _run(pkg: str, case, use_waves: bool):
    """simulate() with the route chosen: (outcome, gpu-index per pod, node
    ledger annotations, final device/storage carry rows, simulator)."""
    if pkg == "jax":
        types, wl, Sim, kw = jax_types, jax_workloads, JaxSimulator, dict(use_mesh=False)
    else:
        types, wl, Sim, kw = torch_types, torch_workloads, TorchSimulator, dict(device="cpu")
    wl.reset_name_counter()
    cluster, apps = build(types, case)
    cluster = cluster.copy()
    pods = wl.expand_workloads_excluding_daemonsets(cluster)
    for ds in cluster.daemon_sets:
        pods.extend(wl.pods_from_daemonset(ds, cluster.nodes))
    cluster.pods = pods
    sim = Sim(cluster.nodes, **kw)
    sim.use_waves = use_waves
    result = sim.run_cluster(cluster)
    failed = list(result.unscheduled_pods)
    for app in apps:
        result = sim.schedule_app(app)
        failed.extend(result.unscheduled_pods)
    result.unscheduled_pods = failed
    gpu_idx = {p["metadata"]["name"]: (p["metadata"].get("annotations") or {}).get(GPU_INDEX)
               for ns in result.node_status for p in ns.pods}
    node_annos = [{k: (ns.node["metadata"].get("annotations") or {}).get(k) for k in NODE_ANNOS}
                  for ns in result.node_status]
    carry = sim._last_carry
    ledgers = {f: np.asarray(getattr(carry, f))[:len(cluster.nodes)] for f in LEDGERS}
    return outcome(result), gpu_idx, node_annos, ledgers, sim


def _host_ledgers(sim, carry_rows):
    """The host plugins' ledgers in the carry's layout."""
    out = {}
    if sim.gpu_host.enabled:
        out["dev_used"] = sim.gpu_host.dev_used_matrix(carry_rows["dev_used"].shape[1])
    if sim.local_host.enabled:
        out["vg_req"] = sim.local_host.vg_matrices(carry_rows["vg_req"].shape[1])[2]
        out["sdev_alloc"] = sim.local_host.device_matrices(
            carry_rows["sdev_alloc"].shape[1])[2].astype(np.float32)
    return out


EXTENDED = extended_cases()


@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
@pytest.mark.parametrize("name", sorted(EXTENDED))
def test_extended_scenario_matches_jax(name, use_waves):
    case = EXTENDED[name]()
    want, want_idx, want_annos, want_led, _ = _run("jax", case, use_waves)
    got, got_idx, got_annos, got_led, sim = _run("torch", case, use_waves)
    assert got == want
    assert got_idx == want_idx
    assert got_annos == want_annos
    for f in LEDGERS:
        assert np.array_equal(want_led[f], got_led[f]), f
    # the kernels' device and storage state agrees with the host ledgers
    for f, host in _host_ledgers(sim, got_led).items():
        assert np.array_equal(host, got_led[f]), f
    if name.startswith("gpu_wave") and use_waves:
        assert "wave" in sim.segment_census


def test_demo1_all_apps_match_the_golden():
    from open_simulator_torch import simulate
    from open_simulator_torch.models.fakenode import new_fake_nodes
    from open_simulator_torch.parity import load_dump, match_rate, placement_dump
    from open_simulator_torch.utils.yamlio import (load_cluster_from_directory,
                                                   load_resources_from_directory,
                                                   match_and_set_local_storage_annotation)
    from open_simulator_tpu.models.fakenode import new_fake_nodes as jax_new_fake_nodes
    from test_parity import APPS, GOLDEN

    cluster = load_cluster_from_directory(os.path.join(REPO, "examples/cluster/demo_1"))
    nn_dir = os.path.join(REPO, "examples/newnode/demo_1")
    nn = load_resources_from_directory(nn_dir)
    match_and_set_local_storage_annotation(nn.nodes, nn_dir)
    fake = new_fake_nodes(nn.nodes[0], 18, seed=42)
    assert fake == jax_new_fake_nodes(copy.deepcopy(nn.nodes[0]), 18, seed=42)
    cluster.nodes += fake
    apps = [torch_types.AppResource(name=name, resource=load_resources_from_directory(
        os.path.join(REPO, "examples/application", path))) for name, path in APPS]
    torch_workloads.reset_name_counter()
    result = simulate(cluster, apps, device="cpu")
    rate, detail = match_rate(placement_dump(result), load_dump(GOLDEN))
    assert rate == 1.0, dict(list(detail.items())[:10])
    placed = [p for ns in result.node_status for p in ns.pods
              if "simon/pod-local-storage" in (p["metadata"].get("annotations") or {})]
    assert placed  # the open_local app ran on the storage nodes
