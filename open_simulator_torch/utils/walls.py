"""Default-route walls of the PyTorch port on one GPU, for any checkout of it.

    python open_simulator_torch/utils/walls.py [--root DIR] [--repeat K] [kind ...]

Runs golden clusters of `tests/test_torch_golden.py` (default: hard_waves,
overflow_waves, affinity) through `Simulator.schedule_pods` of the port found
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

With `--kernels`, it times the single-lane kernels of the main path instead
(CUDA events, mean of `--reps` launches after a warm-up): K2 on 2,500 pods
of the 5,000-node hard shape, K4 on the first ScheduleAnyway segment of the
spread cluster and K5 on the first affinity segment of the hard shape, and
prints the root's `ptxas -v` lines (registers, stack, spills) of each
kernel, so that two checkouts compare kernel for kernel.
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
         "spread": ("spread", 5000, 20000), "affinity": ("affinity", 5000, 20000)}


def _synth():
    spec = importlib.util.spec_from_file_location(
        "walls_synth", os.path.join(HERE, "open_simulator_torch", "utils", "synth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(synth, gen: str, n_nodes: int, n_pods: int) -> tuple:
    if gen == "hard":
        nodes, pods = synth.synth_cluster(n_nodes, n_pods, hard_predicates=True)
        return nodes, pods, []
    return getattr(synth, f"synth_{gen}_cluster")(n_nodes, n_pods)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose open_simulator_torch runs")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--kernels", action="store_true",
                    help="time the single-lane K2, K4 and K5 and print ptxas lines")
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
        return kernel_times(synth, args.root, args.reps)
    for kind in args.kinds:
        if kind in synth.CAPACITY_SCENARIOS:
            continue  # the search warms up on its first run
        nodes, pods, services = workload(synth, KINDS[kind][0], 64, 640)
        sim = Simulator(nodes, device="cuda")
        sim.register_cluster_objects(ResourceTypes(services=services))
        sim.schedule_pods(pods)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    bad = 0
    for _ in range(args.repeat):
        for kind in args.kinds:
            if kind in synth.CAPACITY_SCENARIOS:
                bad += capacity_wall(synth, kind, args.root, card)
                continue
            nodes, pods, services = workload(synth, *KINDS[kind])
            K.reset_launch_counts()
            sim = Simulator(nodes, device="cuda")
            sim.register_cluster_objects(ResourceTypes(services=services))
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


def kernel_times(synth, root: str, reps: int) -> int:
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import build
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    path = build.compile_library()
    log = build.ptxas_log
    if not log:  # built by an earlier process: compile once more for the log
        os.remove(path)
        build.compile_library()
        log = build.ptxas_log
    print(json.dumps({"root": os.path.abspath(root), "ptxas": [
        ln.strip() for ln in log.splitlines()
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln]}), flush=True)
    out = {}
    nodes, pods = synth.synth_cluster(5000, 2500, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    pg, fn, vd = (torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid))
    out["K2 schedule_batch hard 2500 pods"] = _ms(
        lambda: K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones), reps)
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
    print(json.dumps({"root": os.path.abspath(root), "kernel_ms": out, "reps": reps,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
