"""Default-route walls of the PyTorch port on one GPU, for any checkout of it.

    python open_simulator_torch/utils/walls.py [--root DIR] [--repeat K] [kind ...]

Runs golden clusters of `tests/test_torch_golden.py` (default: hard_waves,
overflow_waves, affinity; also spread and extended) through `Simulator.schedule_pods` of the port found
under DIR (default: this checkout) on the card, checks each run against this
checkout's golden, and prints one JSON line per run with its wall clock
(after `torch.cuda.synchronize()`), the port's segment census and kernel
launches. The kinds `capacity` and `capacity_lanes` run the capacity
planner's search (`CapacityPlanner.search()`, the probe fan-outs) on the
scenario of that name instead, checked against its golden's `found`,
`nodes_added` and search statistics. The kernels' build and a small warm-up run of each kind come first,
untimed. The cluster generators are loaded from this checkout by file path,
so an older checkout (one that routed the affinity segments differently) runs
the same clusters; run it by path, so that it imports no package of its own
checkout. Compare two checkouts in one invocation sequence on one card:
parent, change, change, parent. Imports no JAX.

With `--kernels`, it times the kernels of the main path instead (CUDA
events, mean of `--reps` launches after a warm-up): K2 on 2,500 pods of the
5,000-node hard shape (also over 8 lanes) and of the same shape at 10,000
nodes, K4 on the first ScheduleAnyway segment of the spread cluster (also
over 8 lanes), K5 on the first affinity segment of the hard shape and K3 on
its first wave and first cap1 wave segments (each also over 8 lanes, the
cap1 wave's counts then committed by K3c over 8 lanes), K5 on
the affinity cluster's svc-web segment and hostname spread, K3 with gpu_live
on the first GPU wave of the extended cluster, and prints the root's
`ptxas -v` lines (registers, stack, spills) of each kernel and, where the
root's K2-K5 run on thread-block clusters, each launch's cluster shape, so
that two checkouts compare kernel for kernel. It also times K3c on the
northstar cluster's first wave, on the hard shape's first cap1 wave and
with gpu_live on the extended cluster's first 1-GPU wave, and K7 and K1 on
a decision set of the hard shape (N 5,120) and of the extended cluster
(N 2,048, the GPU-share and Open-Local branches on), K1 also on the spread
cluster's first group with a hostname DoNotSchedule term (N 5,120, D+1 =
N + 1): each with its call rate (CUDA events over back-to-back calls, the
wrapper's host work included) and its device time per call under
torch.profiler (the kernel alone, and every other kernel the call
launches, such as a clone's copy kernels); K1's cases also with its bytes'
bound and the wrapper's host split (`_k1_split`: the view's fill, the
allocations, the launch call, the engine reason path's fetches). The line
ends with the launch floor, a one-element fill's call rate and device
time. `--cases K3c,K7,K1` times only the kernels named (K2, K3, K4 and K5
are one case set).

With `--mesh-kernels`, it times the node mesh's kernels instead: two ranks
spawned on the card (gloo, sharing cuda:0, as chip_smoke.py's mesh and
partitioned phases run them) time K10 on the first wave segment of the
northstar cluster (10,000 nodes, 100,000 pods) and K11 on the affinity
cluster's hostname and zone spreads at the default epoch limit, K9 on the
same two spreads with OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES=8192 (the
epoch path), K8 on the extended cluster's first 1-GPU wave (N 2,048, EXT),
on overflow_waves' first wave (N 128) and with the limit at 16,384 on the
northstar cluster's first wave (N 10,240), K12 on the first 256 pods of the
hard shape (5,000 nodes) and of the extended cluster (EXT), and K13 on the
spread cluster's ScheduleAnyway, SelectorSpread and DoNotSchedule segments
(its first 2,000 pods, N 5,120), and K14 on extended's first 1-GPU wave
(gpu_live) and on the northstar cluster's first wave (with every kernel
and copy of a call by name, its bounds in and out of place and the launch
floor; `--cases K8,K13` times only the kernels named), stage by stage with CUDA events
(kernels.SHARDED_STAGE_EVENTS; the two ranks' launches interleave on the
card, so a stage's events include the other rank's time slices, and a
stage launched after a host read or a collective also the launch's host
latency) and with torch.profiler (each kernel's device time alone), per
round, epoch or pod by the host clock, and prints the root's `ptxas -v`
lines of K8-K14.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# kind -> (generator, nodes, pods), as tests/test_torch_golden.py SCENARIOS
KINDS = {"hard_waves": ("hard", 5000, 50000), "overflow_waves": ("hard", 100, 30000),
         "spread": ("spread", 5000, 20000), "affinity": ("affinity", 5000, 20000),
         "extended": ("extended", 2000, 20000)}


def _synth():
    spec = importlib.util.spec_from_file_location(
        "walls_synth", os.path.join(HERE, "open_simulator_torch", "utils", "synth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(synth, gen: str, n_nodes: int, n_pods: int) -> tuple:
    """(nodes, pods, services, storage classes) of a KINDS generator."""
    if gen == "hard":
        nodes, pods = synth.synth_cluster(n_nodes, n_pods, hard_predicates=True)
        return nodes, pods, [], []
    out = getattr(synth, f"synth_{gen}_cluster")(n_nodes, n_pods)
    return out if len(out) == 4 else (*out, [])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose open_simulator_torch runs")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--kernels", action="store_true",
                    help="time K2, K3, K4, K5, K3c, K7 and K1 and print ptxas lines")
    ap.add_argument("--mesh-kernels", action="store_true",
                    help="time K8 - K14 on two ranks and print their ptxas lines")
    ap.add_argument("--cases", default=None,
                    help="the kernels --kernels (default K2,K3,K4,K5,K3c,K7,K1) or "
                         "--mesh-kernels (default K8,K9,K10,K11,K12,K13,K14) times")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("kinds", nargs="*", default=["hard_waves", "overflow_waves", "affinity"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("walls: no CUDA device", file=sys.stderr)
        return 2
    synth = _synth()
    sys.path.insert(0, os.path.abspath(args.root))
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import build
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    # set-up outside the timed runs: the kernels' build, the first launches
    build.library()
    if args.kernels:
        return kernel_times(synth, args.root, args.reps,
                            (args.cases or "K2,K3,K4,K5,K3c,K7,K1").split(","))
    if args.mesh_kernels:
        return mesh_kernel_times(args.root, args.reps,
                                 (args.cases or "K8,K9,K10,K11,K12,K13,K14").split(","))
    for kind in args.kinds:
        if kind in synth.CAPACITY_SCENARIOS:
            continue  # the search warms up on its first run
        nodes, pods, services, scs = workload(synth, KINDS[kind][0], 64, 640)
        sim = Simulator(nodes, device="cuda")
        sim.register_cluster_objects(ResourceTypes(services=services, storage_classes=scs))
        sim.schedule_pods(pods)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    bad = 0
    for _ in range(args.repeat):
        for kind in args.kinds:
            if kind in synth.CAPACITY_SCENARIOS:
                bad += capacity_wall(synth, kind, args.root, card)
                continue
            nodes, pods, services, scs = workload(synth, *KINDS[kind])
            K.reset_launch_counts()
            sim = Simulator(nodes, device="cuda")
            sim.register_cluster_objects(ResourceTypes(services=services, storage_classes=scs))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            failed = sim.schedule_pods(pods)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            choices = [sim.na.index.get((p.get("spec") or {}).get("nodeName"), -1) for p in pods]
            sha = hashlib.sha256(np.array(choices, dtype="<i4").tobytes()).hexdigest()
            with open(os.path.join(HERE, "tests", "golden", f"torch_port_{kind}.json")) as f:
                want = json.load(f)
            census = Counter(u.reason.split("): ", 1)[1] for u in failed)
            match = (sha == want["choices_sha256"]
                     and dict(sorted(census.items())) == want["reason_census"])
            bad += not match
            print(json.dumps({"kind": kind, "root": os.path.abspath(args.root), "seconds": wall,
                              "pods_per_s": len(pods) / wall, "golden": match,
                              "census": sim.segment_census, "launches": K.launch_counts(),
                              "card": card}), flush=True)
    return 1 if bad else 0


def capacity_wall(synth, kind: str, root: str, card: str) -> int:
    """One capacity search of `kind` on the card; prints its wall and
    returns 1 if it differs from the golden."""
    import torch

    from open_simulator_torch.apply.applier import CapacityPlanner
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K

    base, template, pods, services, max_cpu = synth.capacity_scenario(kind)
    prev = os.environ.pop("MaxCPU", None)
    if max_cpu is not None:
        os.environ["MaxCPU"] = str(max_cpu)
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planner = CapacityPlanner(base, template, pods,
                                  cluster_objects=ResourceTypes(services=services), device="cuda")
        found, n, _ = planner.search()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("MaxCPU", None)
        if prev is not None:
            os.environ["MaxCPU"] = prev
    with open(os.path.join(HERE, "tests", "golden", f"torch_port_{kind}.json")) as f:
        want = json.load(f)
    stats = {k: planner.stats[k] for k in want["stats"]}
    match = (found, n, stats) == (want["found"], want["nodes_added"], want["stats"])
    print(json.dumps({"kind": kind, "root": os.path.abspath(root), "seconds": wall,
                      "pods_per_s": len(pods) / wall, "golden": match, "stats": stats,
                      "launches": K.launch_counts(), "card": card}), flush=True)
    return 0 if match else 1


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _ptxas_lines(entries=()) -> list:
    """The root library's `ptxas -v` lines (each entry, its registers, stack
    and spills), of the entries whose name holds one of `entries` (all
    without)."""
    from open_simulator_torch.ops import build

    path = build.compile_library()
    log = build.ptxas_log
    if not log:  # built by an earlier process: compile once more for the log
        os.remove(path)
        build.compile_library()
        log = build.ptxas_log
    out, keep = [], not entries
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = not entries or any(e in ln for e in entries)
        if keep and ("Compiling entry" in ln or "registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def kernel_times(synth, root: str, reps: int, cases: list) -> int:
    card = _card()
    print(json.dumps({"root": os.path.abspath(root), "ptxas": _ptxas_lines()}), flush=True)
    out, shapes = {}, {}

    def shape_of(name, wrapper):
        shape = getattr(wrapper, "last_shape", None)  # None: a single-block checkout
        if shape is not None:
            shapes[name] = {"C": shape.C, "threads": shape.threads,
                            "nodes_per_thread": shape.nodes_per_thread}

    if {"K2", "K3", "K4", "K5"} & set(cases):
        _wave_kernel_times(synth, reps, out, shape_of)
    launch = {}
    if {"K3c", "K7", "K1"} & set(cases):
        launch = _launch_times(synth, reps, cases, shape_of)
    print(json.dumps({"root": os.path.abspath(root), "kernel_ms": out, "launch_cases": launch,
                      "cluster_shapes": shapes, "launch_floor": _launch_floor(reps),
                      "reps": reps, "card": card}), flush=True)
    return 0


def _launch_floor(reps: int) -> dict:
    """A one-element fill's call rate and device time under torch.profiler:
    the floor of any launch's time on this card."""
    import torch

    x = torch.empty(1, device="cuda")
    return {"call_ms": _ms(lambda: x.fill_(0.0), reps),
            "device_ms": sum(_device_ms(lambda: x.fill_(0.0), reps, reps,
                                        ("FillFunctor",)).values())}


def _smoke():
    """This checkout's chip_smoke.py (its cost formulas), loaded by path."""
    spec = importlib.util.spec_from_file_location("walls_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(fn, reps: int) -> float:
    """Host microseconds per call of `fn` (after a warm-up, the card idle
    before; what it enqueues is not waited for, except by the call itself)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def _k1_split(tb, seed, g: int, gpu: bool, storage: bool, reps: int) -> dict:
    """The root's K1 wrapper per call, by the host clock (microseconds):
    the view's fill, its output allocations (one packed buffer, or the
    three tensors of a checkout without it), the cached shape lookup (none
    without a cluster), the launch call, the whole wrapper, and the engine
    reason path's device-to-host fetch (one packed buffer, or one a stage
    tensor)."""
    import ctypes

    import torch

    from open_simulator_torch.ops import build
    from open_simulator_torch.ops import kernels as K

    lib = build.library()
    N, R = tb.alloc.shape
    packed = hasattr(K, "feasibility_packed")
    ext = bool(gpu or storage)

    def view():
        return K._view(tb, seed, 2, K.DEFAULT_WEIGHTS, K.DEFAULT_FILTERS, gpu, storage)

    def alloc():
        if packed:
            return (torch.empty((K.FEASIBILITY_ROWS + R, N), dtype=torch.uint8, device="cuda"),)
        return (torch.empty(N, dtype=torch.bool, device="cuda"),
                torch.empty((len(K.STAGE_ROWS), N), dtype=torch.bool, device="cuda"),
                torch.empty((N, R), dtype=torch.bool, device="cuda"))

    v = view()
    vr = ctypes.byref(v)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in alloc()]
    out = {"view_us": _host_us(view, reps), "alloc_us": _host_us(alloc, reps),
           "buffers": len(ptrs)}
    if packed:
        def shape():
            return K._cluster_shape(lib, "k1", False, ext, v, 1)

        sh = shape()
        out["shape_us"] = _host_us(shape, reps)

        def launch():
            return lib.feasibility_launch(vr, g, -1, 1, 1, ptrs[0], sh.C, sh.smem, K._stream())

        rows = K.feasibility_packed(tb, seed, g, -1, True, enable_gpu=gpu, enable_storage=storage)

        def fetch():
            return rows.cpu()
        out["fetches"] = 1
    else:
        def launch():
            return lib.feasibility_launch(vr, g, -1, 1, 1, *ptrs, K._stream())

        _, stages = K.feasibility_jit(tb, seed, g, -1, True, enable_gpu=gpu,
                                      enable_storage=storage)

        def fetch():
            return {k: t.cpu() for k, t in stages.items()}
        out["fetches"] = len(stages)
    out["launch_us"] = _host_us(launch, reps)
    out["wrapper_us"] = _host_us(lambda: K.feasibility_kernel(
        tb, seed, g, -1, True, enable_gpu=gpu, enable_storage=storage), reps)
    out["fetch_us"] = _host_us(fetch, reps)
    return out


def _wave_kernel_times(synth, reps: int, out: dict, shape_of) -> None:
    """K2 - K5 (and K3c over 8 lanes): CUDA events, mean of `reps`
    launches, into `out`."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    for n_nodes in (5000, 10000):
        nodes, pods = synth.synth_cluster(n_nodes, 2500, hard_predicates=True)
        sim = Simulator(nodes, device="cuda")
        bt = sim.encode_batch(pods)
        tb, seed = sim._to_device(bt)
        pg, fn, vd = (torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node,
                                                           bt.valid))
        name = ("K2 schedule_batch hard 2500 pods" if n_nodes == 5000
                else f"K2 schedule_batch hard N {tb.alloc.shape[0]} 2500 pods")
        out[name] = _ms(lambda: K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones), reps)
        shape_of(name, K.schedule_batch)
        if n_nodes == 5000:
            lanes = K.carry_lanes(seed, 8)
            active = torch.ones((8, tb.alloc.shape[0]), dtype=torch.bool, device="cuda")
            name = "K2 over 8 lanes hard 2500 pods"
            out[name] = _ms(lambda: K.schedule_batch_lanes_kernel(tb, lanes, active, pg, fn, vd,
                                                                  bt.n_zones), reps)
            shape_of(name, K.probe_serial_fanout)
    nodes, pods, services = synth.synth_spread_cluster(5000, 20000)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    seg = next(s for s in sim._segments(bt, len(pods)) if s[0] == "spread" and s[6])
    _, _, m, g, cap1, ss_live, sa_live = seg
    valid = torch.ones(m, dtype=torch.bool, device="cuda")
    out["K4 schedule_group_serial spread sa_live"] = _ms(
        lambda: K.schedule_group_serial_kernel(tb, seed, g, valid, cap1, ss_live=ss_live,
                                               sa_live=sa_live, n_zones=2), reps)
    shape_of("K4 schedule_group_serial spread sa_live", K.schedule_group_serial)
    lanes = K.carry_lanes(seed, 8)
    active = torch.ones((8, tb.alloc.shape[0]), dtype=torch.bool, device="cuda")
    out["K4 over 8 lanes spread sa_live"] = _ms(
        lambda: K.schedule_group_serial_lanes_kernel(tb, lanes, active, g, valid, cap1,
                                                     ss_live=ss_live, sa_live=sa_live,
                                                     n_zones=2), reps)
    shape_of("K4 over 8 lanes spread sa_live", K.probe_group_serial_fanout)
    nodes, pods = synth.synth_cluster(5000, 50000, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    _, _, m, g, cap1, ss_live = next(s for s in sim._segments(bt, len(pods))
                                     if s[0] == "affinity")
    block = K.wave_block_for(m, sim.na.N)
    out["K5 schedule_affinity_wave hard zone spread"] = _ms(
        lambda: K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1, ss_live=ss_live,
                                                block=block), reps)
    shape_of("K5 schedule_affinity_wave hard zone spread", K.schedule_affinity_wave)
    lanes = K.carry_lanes(seed, 8)
    active = torch.ones((8, tb.alloc.shape[0]), dtype=torch.bool, device="cuda")
    out["K5 over 8 lanes hard zone spread"] = _ms(
        lambda: K.schedule_affinity_wave_lanes_kernel(tb, lanes, active, g, m, cap1,
                                                      ss_live=ss_live, block=block), reps)
    shape_of("K5 over 8 lanes hard zone spread", K.probe_affinity_wave_fanout)
    segs = sim._segments(bt, len(pods))
    for label, seg in (("", next(s for s in segs if s[0] == "wave")),
                       (" cap1", next(s for s in segs if s[0] == "wave" and s[4]))):
        _, _, m, g, cap1 = seg[:5]
        block = K.wave_block_for(m, sim.na.N)
        kw = dict(block=block, kmax=K.wave_kmax(m, sim.na.N, block))
        out[f"K3 schedule_wave hard{label}"] = _ms(
            lambda: K.schedule_wave_kernel(tb, seed, g, m, cap1, **kw), reps)
        shape_of(f"K3 schedule_wave hard{label}", K.schedule_wave)
        out[f"K3 over 8 lanes hard{label}"] = _ms(
            lambda: K.schedule_wave_lanes_kernel(tb, lanes, active, g, m, cap1, **kw), reps)
        shape_of(f"K3 over 8 lanes hard{label}", K.probe_wave_fanout)
    j_s = K.schedule_wave_lanes_kernel(tb, lanes, active, g, m, cap1, **kw)[0]
    out["K3c over 8 lanes hard cap1"] = _ms(
        lambda: K.aggregate_commit_lanes_kernel(tb, lanes, g, j_s), reps)
    # the Service-backed svc-web segment of the affinity cluster (zoned
    # SelectorSpread: a head-fallback epoch a pod) and its hostname spread
    nodes, pods, services = synth.synth_affinity_cluster(5000, 20000)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    segs = sim._segments(bt, len(pods))
    for label, seg in (("svc-web", next(s for s in segs if s[0] == "affinity" and s[5])),
                       ("hostname spread", segs[1])):
        _, _, m, g, cap1, ss_live = seg
        kw = dict(ss_live=ss_live, block=K.wave_block_for(m, sim.na.N),
                  n_zones=bt.n_zones if ss_live else 2)
        out[f"K5 schedule_affinity_wave {label}"] = _ms(
            lambda: K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1, **kw), reps)
        shape_of(f"K5 schedule_affinity_wave {label}", K.schedule_affinity_wave)
    nodes, pods, _, scs = synth.synth_extended_cluster(2000, 20000)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(storage_classes=scs))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    _, _, m, g, cap1 = next(s for s in sim._segments(bt, len(pods))
                            if s[0] == "wave" and s[5])[:5]
    block = K.wave_block_for(m, sim.na.N)
    out["K3 schedule_wave extended gpu_live"] = _ms(
        lambda: K.schedule_wave_kernel(tb, seed, g, m, cap1, block=block,
                                       kmax=K.wave_kmax(m, sim.na.N, block), gpu_live=True),
        reps)
    shape_of("K3 schedule_wave extended gpu_live", K.schedule_wave)


# the kernels' names as torch.profiler reports them (substrings)
LAUNCH_NAMES = {"K3c": ("aggregate_commit",), "K7": ("explain_kernel",),
                "K1": ("feasibility_kernel",)}


def _launch_case(fn, reps: int, names: tuple, wrapper=None, shape_of=None, label="") -> dict:
    """One wrapper call timed: its call rate (CUDA events over `reps`
    back-to-back calls after a warm-up, the host's work between launches
    included) and its device time per call under torch.profiler, the
    kernel (`names`) alone and every other kernel of the call."""
    call_ms = _ms(fn, reps)
    dev = _device_ms(fn, reps, reps, names, others=True)
    if shape_of is not None:
        shape_of(label, wrapper)
    return {"call_ms": call_ms, "device_ms": sum(v for k, v in dev.items() if k != "other"),
            "other_device_ms": dev.get("other", 0.0), "kernels": dev}


def _case_cluster(synth, gen: str, n_nodes: int, n_pods: int, use_mesh=None):
    """(simulator, batch, tables, seed carry, segments) of a cluster on the
    card: `plain` is synth_cluster's plain shape, else a KINDS generator."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.engine import Simulator

    if gen == "plain":
        nodes, pods = synth.synth_cluster(n_nodes, n_pods)
        scs = []
    else:
        nodes, pods, _, scs = workload(synth, gen, n_nodes, n_pods)
    kw = {} if use_mesh is None else {"use_mesh": use_mesh}
    sim = Simulator(nodes, device="cuda", **kw)
    sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    return sim, bt, tb, seed, sim._segments(bt, len(pods)), len(pods)


def _first_wave(sim, segs, gpu_1: bool, cap1: bool):
    """The first wave segment (the first 1-GPU gpu_live one with `gpu_1`,
    the first cap1 one with `cap1`)."""
    return next(s for s in segs if s[0] == "wave" and (not cap1 or s[4]) and (
        not gpu_1 or (s[5] and int(sim.encoder.group_list[s[3]].gpu_num) == 1)))


def _wave_counts(sim, tb, seed, seg):
    """A wave segment's counts from K3 on the seed carry."""
    from open_simulator_torch.ops import kernels as K

    _, _, m, g, cap1, gpu_live = seg[:6]
    block = K.wave_block_for(m, sim.na.N)
    return K.schedule_wave_kernel(tb, seed, g, m, cap1, block=block,
                                  kmax=K.wave_kmax(m, sim.na.N, block),
                                  gpu_live=bool(gpu_live))[0]


def _launch_times(synth, reps: int, cases: list, shape_of) -> dict:
    """K3c, K7 and K1 per call (`_launch_case`): K3c on the northstar
    cluster's first wave, the hard shape's first cap1 wave and, with
    gpu_live, the extended cluster's first 1-GPU wave (each wave's counts
    from K3 on the seed carry); K7 and K1 on the hard shape's (N 5,120) and
    the extended cluster's (N 2,048, EXT) first decision set: the first
    pod's group (the extended cluster's first GPU group) against the seed
    carry, no forced node."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.encode import plugin_flags

    out = {}
    smoke = _smoke()
    for label, spec in (("northstar", ("plain", 10000, 100000)), ("hard", KINDS["hard_waves"]),
                        ("extended", KINDS["extended"]), ("spread", KINDS["spread"])):
        if label == "spread" and "K1" not in cases:
            continue
        sim, bt, tb, seed, segs, P = _case_cluster(synth, *spec)
        N = int(tb.alloc.shape[0])
        if label == "spread":  # K1 on the first group with a hostname DoNotSchedule term
            g = next(int(x) for x in bt.pod_group[:P]
                     if int(tb.dns_edom[int(x)].sum(dim=1).max()) > N // 2)
            name = "K1 spread hostname DoNotSchedule"
            b = smoke.k1_bytes(tb, seed, g)
            out[name] = dict(nodes=N, group=g, domains=int(seed.counter.shape[1]),
                             bytes=b, bound_ms=b / smoke.HBM_BYTES_PER_S * 1e3,
                             host_split=_k1_split(tb, seed, g, False, False, reps),
                             **_launch_case(
                                 lambda: K.feasibility_kernel(tb, seed, g, -1, True), reps,
                                 LAUNCH_NAMES["K1"], K.feasibility_jit, shape_of, name))
            del sim, bt, tb, seed
            torch.cuda.empty_cache()
            continue
        if "K3c" in cases:
            seg = _first_wave(sim, segs, label == "extended", label == "hard")
            g, gpu_live = seg[3], bool(seg[5])
            j = _wave_counts(sim, tb, seed, seg)
            name = f"K3c {label} " + ("first 1-GPU wave gpu_live" if label == "extended" else
                                      "first cap1 wave" if label == "hard" else "first wave")
            out[name] = dict(nodes=N, copies=int(j.sum()), **_launch_case(
                lambda: K.aggregate_commit_kernel(tb, seed, g, j, gpu_live), reps,
                LAUNCH_NAMES["K3c"], K.aggregate_commit, shape_of, name))
        if label != "northstar":
            gpu, storage = plugin_flags(bt)
            g = next(int(x) for x in bt.pod_group[:P]
                     if label != "extended" or bt.grp_gpu_mem[int(x)] > 0)
            ext = " EXT" if gpu or storage else ""
            if "K7" in cases:
                name = f"K7 {label} decision set{ext}"
                out[name] = dict(nodes=N, group=g, **_launch_case(
                    lambda: K.explain_kernel(tb, seed, g, -1, True, bt.n_zones, gpu, storage),
                    reps, LAUNCH_NAMES["K7"], K.explain_jit, shape_of, name))
            if "K1" in cases:
                name = f"K1 {label} decision set{ext}"
                b = smoke.k1_bytes(tb, seed, g) + (smoke.gpu_storage_bytes(tb, seed) if ext
                                                   else 0)
                out[name] = dict(nodes=N, group=g, bytes=b,
                                 bound_ms=b / smoke.HBM_BYTES_PER_S * 1e3,
                                 host_split=_k1_split(tb, seed, g, gpu, storage, reps),
                                 **_launch_case(
                                     lambda: K.feasibility_kernel(tb, seed, g, -1, True,
                                                                  enable_gpu=gpu,
                                                                  enable_storage=storage),
                                     reps, LAUNCH_NAMES["K1"], K.feasibility_jit, shape_of,
                                     name))
        del sim, bt, tb, seed
        torch.cuda.empty_cache()
    return out


def _mesh_case(kernel, stats_of, reps: int) -> dict:
    """One K8 - K13 call timed `reps` times after a warm-up: the host clock
    per round, epoch or pod (`stats_of(result)` of them a call) and each
    stage's CUDA-event milliseconds per round, epoch or pod."""
    import torch

    from open_simulator_torch.ops import kernels as K

    steps = stats_of(kernel())
    K.SHARDED_STAGE_EVENTS = events = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kernel()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    K.SHARDED_STAGE_EVENTS = None
    stages = {k: sum(a.elapsed_time(b) for a, b in v) / (reps * steps)
              for k, v in events.items() if "setup" not in k}
    shape = getattr(kernel.wrapper, "last_shape", None)  # None: a single-block checkout
    if isinstance(shape, dict):  # K8, K9: their block stages' and their tail's
        C = {k: v.C for k, v in shape.items()}
    else:
        C = shape.C if shape is not None else 1
    return {"steps": steps, "wall_ms": wall * 1e3 / (reps * steps),
            "kernel_ms": sum(stages.values()), "stage_ms": stages,
            "device_ms": _device_ms(kernel, reps * steps, reps), "C": C}


MESH_NAMES = ("wave_rounds", "affinity_rounds", "wave_sharded", "affinity_sharded",
              "batch_sharded", "gs_sharded", "commit_sharded")


def _device_ms(kernel, steps: int, reps: int, names: tuple = MESH_NAMES,
               others: bool = False) -> dict:
    """Each kernel's (those whose name holds one of `names`; the K8-K14
    kernels by default) device time per round, epoch, pod or call over
    `reps` calls under torch.profiler (CUPTI: the kernels alone, without
    the gaps a host-side launch leaves after the collectives and host
    reads, which the CUDA events of the stages hold), with `others` the
    device time of every other kernel as "other"; {} where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    if ProfilerActivity.CUDA not in supported_activities():
        return {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernel()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        name = e.key.split("(")[0].replace("void ", "")
        if not us:
            continue
        key = name if any(k in name for k in names) else "other" if others else None
        if key is not None:
            out[key] = out.get(key, 0.0) + us / 1e3 / steps
    return out


class _limit:
    """OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES at `value` inside the block."""

    name = "OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES"

    def __init__(self, value: int) -> None:
        self.value = str(value)

    def __enter__(self):
        self.prev = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc) -> None:
        if self.prev is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.prev


def _wave_case(mesh, tb, seed, seg, N: int, reps: int, kernel) -> dict:
    """K8 or K10 (`kernel`) on this rank's block of one wave segment, per
    epoch or round."""
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import block_of

    _, _, m, g, cap1, flag = seg[:6]
    block = K.wave_block_for(m, N)
    kw = dict(block=block, kmax=K.wave_kmax(m, N, block), gpu_live=bool(flag))
    tbl, seedl = block_of(tb, seed, mesh)

    def run():
        return kernel(tbl, seedl, g, m, cap1, mesh=mesh, **kw)

    run.wrapper = kernel
    return _mesh_case(run, lambda r: int(r[2][0]), reps)


def _mesh_rank(mesh, reps: int, cases: list) -> dict:
    """K8 - K13 on this rank's block (see the module's docstring): the
    kernels named in `cases`."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import block_of
    from open_simulator_torch.simulator.engine import Simulator

    synth = _synth()
    out = {}
    if "K10" in cases or "K8" in cases:
        nodes, pods = synth.synth_cluster(10000, 100000)
        sim = Simulator(nodes, device="cuda", use_mesh=False)
        bt = sim.encode_batch(pods)
        tb, seed = sim._to_device(bt)
        seg = next(s for s in sim._segments(bt, len(pods)) if s[0] == "wave")
        if "K10" in cases:
            out["K10 northstar first wave"] = _wave_case(mesh, tb, seed, seg, sim.na.N, reps,
                                                         K.schedule_wave_rounds_kernel)
        if "K8" in cases:
            with _limit(16384):  # the epoch path at N 10,240
                out["K8 northstar first wave"] = _wave_case(mesh, tb, seed, seg, sim.na.N, reps,
                                                            K.schedule_wave_sharded_kernel)
            del sim, bt, tb, seed
            for label, (gen, n_nodes, n_pods) in (("extended first 1-GPU wave",
                                                   KINDS["extended"]),
                                                  ("overflow_waves first wave",
                                                   KINDS["overflow_waves"])):
                nodes, pods, _, scs = workload(synth, gen, n_nodes, n_pods)
                sim = Simulator(nodes, device="cuda", use_mesh=False)
                sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
                bt = sim.encode_batch(pods)
                tb, seed = sim._to_device(bt)
                seg = next(s for s in sim._segments(bt, len(pods))
                           if s[0] == "wave" and (s[5] or gen != "extended"))
                out[f"K8 {label}" + (" EXT" if seg[5] else "")] = _wave_case(
                    mesh, tb, seed, seg, sim.na.N, reps, K.schedule_wave_sharded_kernel)
    if "K11" in cases or "K9" in cases:
        nodes, pods, services = synth.synth_affinity_cluster(5000, 20000)
        sim = Simulator(nodes, device="cuda", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services)))
        bt = sim.encode_batch(pods)
        tb, seed = sim._to_device(bt)
        segs = sim._segments(bt, len(pods))
        tbl, seedl = block_of(tb, seed, mesh)
        for kname, wrapper, limit in (("K11", K.schedule_affinity_wave_rounds_kernel, None),
                                      ("K9", K.schedule_affinity_wave_sharded_kernel, 8192)):
            if kname not in cases:
                continue
            for label, seg in (("hostname spread", segs[1]), ("zone spread", segs[3])):
                _, _, m, g, cap1, ss_live = seg[:6]
                kw = dict(ss_live=bool(ss_live), block=K.wave_block_for(m, sim.na.N),
                          n_zones=bt.n_zones if ss_live else 2)

                def run(m=m, g=g, cap1=cap1, kw=kw, wrapper=wrapper):
                    return wrapper(tbl, seedl, g, m, cap1, mesh=mesh, **kw)

                run.wrapper = wrapper
                if limit is None:
                    out[f"{kname} affinity {label}"] = _mesh_case(run, lambda r: int(r[2][0]),
                                                                  reps)
                else:  # the epoch path (K9) at N 5,120
                    with _limit(limit):
                        out[f"{kname} affinity {label}"] = _mesh_case(
                            run, lambda r: int(r[2][0]), reps)
    if "K12" in cases:
        out.update(_k12_cases(synth, mesh, reps))
    if "K13" in cases:
        out.update(_k13_cases(synth, mesh, reps))
    if "K14" in cases:
        out.update(_k14_cases(synth, mesh, reps))
    return {"rank": mesh.rank, "cases": out}


def _k14_cases(synth, mesh, reps: int) -> dict:
    """K14 (rows, the all_gather_rows, domains) on this rank's block of the
    extended cluster's first 1-GPU wave (gpu_live) and of the northstar
    cluster's first wave, each wave's counts from K3 on the seed carry, per
    call; with every kernel and copy of a call by name under torch.profiler
    (`device_ms_by_name`: a checkout that clones the carry block first
    shows its copies there), the bound of the out-of-place commit and of
    the in-place one (chip_smoke.py k14_cost) and the launch floor."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import block_of

    smoke = _smoke()
    out = {"launch floor": _launch_floor(reps)}
    for label, spec in (("extended first 1-GPU wave", KINDS["extended"]),
                        ("northstar first wave", ("plain", 10000, 100000))):
        sim, bt, tb, seed, segs, _ = _case_cluster(synth, *spec, use_mesh=False)
        seg = _first_wave(sim, segs, spec[0] == "extended", False)
        g, flag = seg[3], bool(seg[5])
        j = _wave_counts(sim, tb, seed, seg)
        tbl, seedl = block_of(tb, seed, mesh)
        NL = int(tbl.alloc.shape[0])
        jl = j[mesh.rank * NL:(mesh.rank + 1) * NL].contiguous()

        def run(tbl=tbl, seedl=seedl, g=g, jl=jl, flag=flag):
            return K.aggregate_commit_sharded_kernel(tbl, seedl, g, jl, flag, mesh)

        run.wrapper = K.aggregate_commit_sharded_kernel
        case = _mesh_case(run, lambda r: 1, reps)
        case["device_ms_by_name"] = _device_ms(run, reps, reps, ("",))
        copies = int(jl.sum())
        for key, oop in (("bound_ms", True), ("bound_ms_in_place", False)):
            b, ops = smoke.k14_cost(tbl, seedl, flag, copies, oop)
            case[key] = smoke.bound_of(b, ops)[0]
        out[f"K14 {label}" + (" gpu_live" if flag else "")] = case
        del sim, bt, tb, seed
        torch.cuda.empty_cache()
    return out


def _k13_cases(synth, mesh, reps: int) -> dict:
    """K13 on this rank's block of the spread cluster's (5,000 nodes, its
    first 2,000 pods) ScheduleAnyway, SelectorSpread and DoNotSchedule
    segments, each from the seed carry, per pod."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import block_of
    from open_simulator_torch.simulator.engine import Simulator

    nodes, pods, services = synth.synth_spread_cluster(5000, 20000)
    pods = pods[:2000]
    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=list(services)))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    tbl, seedl = block_of(tb, seed, mesh)
    out = {}
    for _, _, m, g, cap1, ss, sa in [s for s in sim._segments(bt, len(pods))
                                     if s[0] == "spread"][:3]:
        label = "sa_live" if sa else "ss_live" if ss else "dns"
        vd = torch.ones(m, dtype=torch.bool)
        kw = dict(ss_live=bool(ss), sa_live=bool(sa), n_zones=bt.n_zones if ss else 2)

        def run(m=m, g=g, cap1=cap1, vd=vd, kw=kw):
            return K.schedule_group_serial_sharded_kernel(tbl, seedl, g, vd, cap1, mesh, **kw)

        run.wrapper = K.schedule_group_serial_sharded_kernel
        out[f"K13 spread {label}"] = _mesh_case(run, lambda r, m=m: m, reps)
    return out


def _k12_cases(synth, mesh, reps: int) -> dict:
    """K12 on this rank's block of the first 256 pods of the hard shape
    (5,000 nodes) and of the extended cluster (EXT), per pod."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import to_device_sharded
    from open_simulator_torch.simulator.encode import pad_batch_tables, plugin_flags
    from open_simulator_torch.simulator.engine import Simulator

    out = {}
    for label, (gen, n_nodes, n_pods) in (("hard", KINDS["hard_waves"]),
                                          ("extended", KINDS["extended"])):
        nodes, pods, _, scs = workload(synth, gen, n_nodes, n_pods)
        sim = Simulator(nodes, device="cuda", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
        bt = pad_batch_tables(sim.encode_batch(pods[:256]), mesh.shards)
        gpu, storage = plugin_flags(bt)
        pg, fn, vd = (torch.from_numpy(a) for a in (bt.pod_group, bt.forced_node, bt.valid))
        tbl, seedl, _ = to_device_sharded(bt, mesh)
        P = int(vd.sum())

        def k12(tbl=tbl, seedl=seedl, pg=pg, fn=fn, vd=vd, nz=bt.n_zones, gpu=gpu,
                storage=storage):
            return K.schedule_batch_sharded_kernel(tbl, seedl, pg, fn, vd, nz, mesh,
                                                   enable_gpu=gpu, enable_storage=storage)

        k12.wrapper = K.schedule_batch_sharded_kernel
        out[f"K12 {label} first 256 pods" + (" EXT" if gpu or storage else "")] = _mesh_case(
            k12, lambda r, P=P: P, reps)
    return out


def mesh_kernel_times(root: str, reps: int, cases: list) -> int:
    import tempfile

    from open_simulator_torch.parallel.launch import run_ranks

    card = _card()
    print(json.dumps({"root": os.path.abspath(root), "card": card, "ptxas": _ptxas_lines(
        MESH_NAMES)}), flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as rdzv:
        ranks = run_ranks(_mesh_rank, 2, rdzv, args=(reps, cases), device="cuda",
                          backend="gloo", timeout_s=900)
    for r in ranks:
        print(json.dumps({"root": os.path.abspath(root), "reps": reps, "card": card, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
