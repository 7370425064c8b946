"""Goldens for the PyTorch port's chip check, computed by the JAX package.

`chip_smoke.py` runs the port on the GPU for two synthetic clusters and holds
its result against `tests/golden/torch_port_*.json`: the sha256 of the per-pod
choices, the per-node pod counts and the census of failure reasons. Those
files come from the JAX package's serial route (`use_waves=False`, one CPU
device), through `compute()` below:

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write

The slow test recomputes both goldens through JAX; the tier-1 test holds the
two packages to one result on a small cluster of the same kind.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
SCENARIOS = {
    # BASELINE.md's hard-predicate stress configuration
    "hard": (5000, 50000),
    # 100 nodes x 256 pod slots cannot hold 30,000 pods: exercises the reasons
    "overflow": (100, 30000),
}


def golden_path(kind: str) -> str:
    return os.path.join(GOLDEN_DIR, f"torch_port_{kind}.json")


def summarize(sim, pods, failed) -> dict:
    """Digest of one scheduling run: choices (node index per pod, -1 when
    unschedulable, i32 little-endian) hashed, per-node counts, reason census
    (the FitError detail after the pod name)."""
    choices = np.array([sim.na.index.get((p.get("spec") or {}).get("nodeName"), -1)
                        for p in pods], dtype="<i4")
    counts = np.bincount(choices[choices >= 0], minlength=sim.na.N)
    census = Counter(u.reason.split("): ", 1)[1] for u in failed)
    return {
        "choices_sha256": hashlib.sha256(choices.tobytes()).hexdigest(),
        "per_node_counts": counts.tolist(),
        "placed": int((choices >= 0).sum()),
        "unscheduled": len(failed),
        "reason_census": dict(sorted(census.items())),
    }


def run_jax(n_nodes: int, n_pods: int) -> dict:
    from open_simulator_tpu.simulator.engine import Simulator
    from open_simulator_tpu.utils.synth import synth_cluster

    nodes, pods = synth_cluster(n_nodes, n_pods, hard_predicates=True)
    sim = Simulator(nodes, use_mesh=False)
    sim.use_waves = False
    failed = sim.schedule_pods(pods)
    return summarize(sim, pods, failed)


def run_port(n_nodes: int, n_pods: int, device: str = "cpu") -> dict:
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster

    nodes, pods = synth_cluster(n_nodes, n_pods, hard_predicates=True)
    sim = Simulator(nodes, device=device)
    failed = sim.schedule_pods(pods)
    return summarize(sim, pods, failed)


def compute(kind: str) -> dict:
    n_nodes, n_pods = SCENARIOS[kind]
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                                text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    return {
        "generator": f"synth_cluster({n_nodes}, {n_pods}, hard_predicates=True)",
        "route": "open_simulator_tpu Simulator, use_waves=False, one CPU device",
        "commit": commit,
        **run_jax(n_nodes, n_pods),
    }


def load(kind: str) -> dict:
    with open(golden_path(kind)) as f:
        return json.load(f)


RESULT_KEYS = ("choices_sha256", "per_node_counts", "placed", "unscheduled", "reason_census")


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_goldens_match_jax(kind):
    got = compute(kind)
    want = load(kind)
    for k in RESULT_KEYS:
        assert got[k] == want[k], k


@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_golden_files_are_consistent(kind):
    g = load(kind)
    n_nodes, n_pods = SCENARIOS[kind]
    assert g["generator"] == f"synth_cluster({n_nodes}, {n_pods}, hard_predicates=True)"
    assert len(g["per_node_counts"]) == n_nodes
    assert sum(g["per_node_counts"]) == g["placed"]
    assert g["placed"] + g["unscheduled"] == n_pods
    assert sum(g["reason_census"].values()) == g["unscheduled"]


def test_small_scenario_both_packages():
    # 4 nodes x 256 pod slots cannot hold 1,200 pods: the reasons path runs
    jax_side = run_jax(4, 1200)
    port_side = run_port(4, 1200)
    assert jax_side["unscheduled"] > 0
    for k in RESULT_KEYS:
        assert port_side[k] == jax_side[k], k


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write")
    for kind in sorted(SCENARIOS):
        g = compute(kind)
        with open(golden_path(kind), "w") as f:
            json.dump(g, f, indent=1)
            f.write("\n")
        print(kind, g["choices_sha256"], g["placed"], g["unscheduled"])
