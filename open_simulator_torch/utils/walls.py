"""Default-route walls of the PyTorch port on one GPU, for any checkout of it.

    python open_simulator_torch/utils/walls.py [--root DIR] [--repeat K] [kind ...]

Runs golden clusters of `tests/test_torch_golden.py` (default: hard_waves,
overflow_waves, affinity) through `Simulator.schedule_pods` of the port found
under DIR (default: this checkout) on the card, checks each run against this
checkout's golden, and prints one JSON line per run with its wall clock
(after `torch.cuda.synchronize()`), the port's segment census and kernel
launches. The kernels' build and a small warm-up run of each kind come first,
untimed. The cluster generators are loaded from this checkout by file path,
so an older checkout (one that routed the affinity segments differently) runs
the same clusters; run it by path, so that it imports no package of its own
checkout. Compare two checkouts in one invocation sequence on one card:
parent, change, change, parent. Imports no JAX.
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
    for kind in args.kinds:
        nodes, pods, services = workload(synth, KINDS[kind][0], 64, 640)
        sim = Simulator(nodes, device="cuda")
        sim.register_cluster_objects(ResourceTypes(services=services))
        sim.schedule_pods(pods)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    bad = 0
    for _ in range(args.repeat):
        for kind in args.kinds:
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


if __name__ == "__main__":
    sys.exit(main())
