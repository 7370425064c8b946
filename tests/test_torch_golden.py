"""Goldens for the PyTorch port's chip check, computed by the JAX package.

`chip_smoke.py` runs the port on the GPU for synthetic clusters and holds its
result against `tests/golden/torch_port_*.json`: the sha256 of the per-pod
choices, the per-node pod counts and the census of failure reasons. Those
files come from the JAX package on one CPU device, through `compute()` below,
on the route each file names: the serial route (`use_waves=False`) for
"hard" and "overflow", the default route (the segment router) for the rest:

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write

The slow test recomputes the goldens through JAX; the tier-1 tests hold the
two packages to one result on small clusters of the same kinds.
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
# kind -> (generator, nodes, pods, serial route?)
SCENARIOS = {
    # BASELINE.md's hard-predicate stress configuration
    "hard": ("hard", 5000, 50000, True),
    # 100 nodes x 256 pod slots cannot hold 30,000 pods: exercises the reasons
    "overflow": ("hard", 100, 30000, True),
    # the same two on the default route: wave and affinity segments
    "hard_waves": ("hard", 5000, 50000, False),
    "overflow_waves": ("hard", 100, 30000, False),
    # bench.py's headline shape: one 100,000-pod wave over 10,000 nodes
    "northstar": ("plain", 10000, 100000, False),
    # zoned pods spreading against themselves: the group-serial route
    "spread": ("spread", 5000, 20000, False),
    # pods constraining themselves (self-affinity, self-anti-affinity,
    # DoNotSchedule spread, live SelectorSpread): the affinity-wave route
    "affinity": ("affinity", 5000, 20000, False),
    # GPU-share and Open-Local demand: shared-GPU waves with the GPU branch,
    # the rest on the serial route with both branches
    "extended": ("extended", 2000, 20000, False),
    # the same on the serial route: every GPU pod through K2's allocator
    "extended_serial": ("extended", 2000, 20000, True),
}
ROUTES = {True: "open_simulator_tpu Simulator, use_waves=False, one CPU device",
          False: "open_simulator_tpu Simulator, default route (use_waves=True), one CPU device"}


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


PORT_GENERATORS = ("spread", "affinity", "extended")


def generator(gen: str, n_nodes: int, n_pods: int) -> str:
    if gen in PORT_GENERATORS:
        return f"synth_{gen}_cluster({n_nodes}, {n_pods})"
    hard = ", hard_predicates=True" if gen == "hard" else ""
    return f"synth_cluster({n_nodes}, {n_pods}{hard})"


def workload(gen: str, n_nodes: int, n_pods: int, synth) -> tuple:
    """(nodes, pods, services, storage_classes) from `synth` (a utils.synth
    module of either package: their synth_cluster is one function); the
    spread, affinity and extended workloads come from the port's own
    generators, which import no JAX."""
    if gen in PORT_GENERATORS:
        from open_simulator_torch.utils import synth as port_synth

        out = getattr(port_synth, f"synth_{gen}_cluster")(n_nodes, n_pods)
        return out if len(out) == 4 else (*out, [])
    nodes, pods = synth.synth_cluster(n_nodes, n_pods, hard_predicates=gen == "hard")
    return nodes, pods, [], []


def run_jax(gen: str, n_nodes: int, n_pods: int, serial: bool) -> dict:
    from open_simulator_tpu.core.types import ResourceTypes
    from open_simulator_tpu.simulator.engine import Simulator
    from open_simulator_tpu.utils import synth

    nodes, pods, services, scs = workload(gen, n_nodes, n_pods, synth)
    sim = Simulator(nodes, use_mesh=False)
    sim.use_waves = not serial
    sim.register_cluster_objects(ResourceTypes(services=services, storage_classes=scs))
    failed = sim.schedule_pods(pods)
    return summarize(sim, pods, failed)


def run_port(gen: str, n_nodes: int, n_pods: int, serial: bool, device: str = "cpu") -> dict:
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils import synth

    nodes, pods, services, scs = workload(gen, n_nodes, n_pods, synth)
    sim = Simulator(nodes, device=device)
    sim.use_waves = not serial
    sim.register_cluster_objects(ResourceTypes(services=services, storage_classes=scs))
    failed = sim.schedule_pods(pods)
    return summarize(sim, pods, failed)


def compute(kind: str) -> dict:
    gen, n_nodes, n_pods, serial = SCENARIOS[kind]
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                                text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    return {
        "generator": generator(gen, n_nodes, n_pods),
        "route": ROUTES[serial],
        "commit": commit,
        **run_jax(gen, n_nodes, n_pods, serial),
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
    gen, n_nodes, n_pods, serial = SCENARIOS[kind]
    assert g["generator"] == generator(gen, n_nodes, n_pods)
    assert g["route"] == ROUTES[serial]
    assert len(g["per_node_counts"]) == n_nodes
    assert sum(g["per_node_counts"]) == g["placed"]
    assert g["placed"] + g["unscheduled"] == n_pods
    assert sum(g["reason_census"].values()) == g["unscheduled"]


def test_small_scenario_both_packages():
    # 4 nodes x 256 pod slots cannot hold 1,200 pods: the reasons path runs;
    # both packages on the serial route
    jax_side = run_jax("hard", 4, 1200, True)
    port_side = run_port("hard", 4, 1200, True)
    assert jax_side["unscheduled"] > 0
    for k in RESULT_KEYS:
        assert port_side[k] == jax_side[k], k


@pytest.mark.parametrize("gen,n_nodes,n_pods", [("hard", 4, 1200), ("plain", 40, 600),
                                                ("spread", 24, 320), ("affinity", 24, 320),
                                                ("extended", 48, 600)])
def test_small_scenario_both_packages_default_route(gen, n_nodes, n_pods):
    jax_side = run_jax(gen, n_nodes, n_pods, False)
    port_side = run_port(gen, n_nodes, n_pods, False)
    for k in RESULT_KEYS:
        assert port_side[k] == jax_side[k], k


def test_small_extended_scenario_both_packages_serial_route():
    # GPU-share and Open-Local demand past the cluster's: GPU and storage
    # reasons; every pod through the serial scan with both branches on
    jax_side = run_jax("extended", 48, 600, True)
    port_side = run_port("extended", 48, 600, True)
    for k in RESULT_KEYS:
        assert port_side[k] == jax_side[k], k
    census = " ".join(jax_side["reason_census"])
    assert "Node:node-" in census and "didn't have enough local storage" in census


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write [kind ...]")
    kinds = [k for k in sys.argv[1:] if k in SCENARIOS] or sorted(SCENARIOS)
    for kind in kinds:
        g = compute(kind)
        with open(golden_path(kind), "w") as f:
            json.dump(g, f, indent=1)
            f.write("\n")
        print(kind, g["choices_sha256"], g["placed"], g["unscheduled"])
