"""How the port cuts a batch into groups and chunks: equal to the JAX package.

The scheduling signature keys pod groups, and groups decide the segments a
batch is cut into, so they decide which pod lands where. Both packages take
the same path: the workload memo, then the native `pod_sig` over the RAW pod
subtree (built from the same C++ source by each package's loader), then the
computed tuple. Pods whose cpu is spelled "1" and "1000m", or whose
containers differ only in name, are other groups under the native hash and
one group under the computed tuple. Each case runs the port's and the JAX
package's Simulator on the same input and compares every pod's node, on the
serial route and on the default route, with the native path on and (as
SIMON_NO_NATIVE=1 sets it) off. The streaming chunk
(OPEN_SIMULATOR_STREAM_PODS) cuts segments too: at 64 the port equals the
JAX package pod for pod. Tolerance zero throughout.
"""

import copy

import numpy as np
import pytest

import open_simulator_torch.simulator.encode as torch_encode
import open_simulator_tpu.simulator.encode as jax_encode
from fixtures import make_node, make_pod
from open_simulator_torch import native
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_torch.utils.synth import synth_cluster
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator


def nodes_of_mixed_size(n):
    return [make_node(f"node-{i:02d}", cpu=str((4, 8, 16, 6)[i % 4]),
                      memory=f"{(8, 16, 32, 12)[i % 4]}Gi") for i in range(n)]


def placements(pkg, nodes, pods, use_waves=True):
    """Every pod's node (None when unscheduled) after one schedule_pods."""
    pods = copy.deepcopy(pods)
    sim = (JaxSimulator(copy.deepcopy(nodes), use_mesh=False) if pkg == "jax"
           else TorchSimulator(copy.deepcopy(nodes), device="cpu"))
    sim.use_waves = use_waves
    sim.schedule_pods(pods)
    return [(p.get("spec") or {}).get("nodeName") for p in pods]


def spelled_cpu():
    return [make_pod(f"web-{i}", cpu=("1", "1000m")[i % 2], memory="1Gi",
                     labels={"app": "web"}) for i in range(24)]


def renamed_container():
    pods = [make_pod(f"web-{i}", cpu="1", memory="1Gi", labels={"app": "web"})
            for i in range(24)]
    for i, p in enumerate(pods):
        p["spec"]["containers"][0]["name"] = ("main", "app")[i % 2]
    return pods


def random_raw_pods(seed, n=240):
    """Blocks of 1-20 pods of a few templates, each pod in one of two
    spellings of its template (cpu, memory, container name, an env var)."""
    rng = np.random.default_rng(seed)
    pods = []
    while len(pods) < n:
        tmpl = int(rng.integers(3))
        for _ in range(int(rng.integers(1, 21))):
            alt = bool(rng.integers(2))
            cpu = (("1", "1000m"), ("500m", "0.5"), ("2", "2000m"))[tmpl][alt]
            mem = ("1Gi", "1024Mi")[int(rng.integers(2))]
            p = make_pod(f"p-{len(pods)}", cpu=cpu, memory=mem, labels={"app": f"t{tmpl}"})
            c = p["spec"]["containers"][0]
            c["name"] = ("main", "server")[int(rng.integers(2))]
            if rng.integers(4) == 0:
                c["env"] = [{"name": "MODE", "value": "a"}]
            pods.append(p)
    return pods[:n]


CASES = {"spelled_cpu": (20, spelled_cpu), "renamed_container": (20, renamed_container),
         "random_raw_3": (30, lambda: random_raw_pods(3)),
         "random_raw_8": (30, lambda: random_raw_pods(8))}


def test_native_signature_path_builds_into_build_dir():
    assert native.backend() == "native"
    assert native.so_path().startswith(native.BUILD_DIR)
    assert torch_encode.scheduling_signature(spelled_cpu()[0]) != \
        torch_encode.scheduling_signature(spelled_cpu()[1])


@pytest.mark.parametrize("use_waves", [True, False], ids=["default", "serial"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_placements_equal_jax_with_native(case, use_waves):
    n_nodes, make = CASES[case]
    nodes, pods = nodes_of_mixed_size(n_nodes), make()
    got = placements("torch", nodes, pods, use_waves)
    assert got == placements("jax", nodes, pods, use_waves)
    assert any(got)


@pytest.fixture
def no_native(monkeypatch):
    """SIMON_NO_NATIVE=1 for both packages: their signature caches reset to
    the computed tuple."""
    monkeypatch.setattr(torch_encode, "_native_hash", None)
    monkeypatch.setattr(jax_encode, "_native_hash", None)


@pytest.mark.parametrize("case", ["spelled_cpu", "renamed_container"])
def test_placements_equal_jax_without_native(case, no_native):
    n_nodes, make = CASES[case]
    nodes, pods = nodes_of_mixed_size(n_nodes), make()
    got = placements("torch", nodes, pods)
    assert got == placements("jax", nodes, pods)


def test_native_path_changes_the_partition(monkeypatch):
    """The repair has teeth: on the "1" / "1000m" pods the computed tuple
    puts most pods on other nodes than the raw hash."""
    nodes, pods = nodes_of_mixed_size(20), spelled_cpu()
    with_native = placements("torch", nodes, pods)
    monkeypatch.setattr(torch_encode, "_native_hash", None)
    computed = placements("torch", nodes, pods)
    assert sum(a != b for a, b in zip(with_native, computed)) >= 12


def test_stream_chunk_equals_jax(monkeypatch):
    monkeypatch.setenv("OPEN_SIMULATOR_STREAM_PODS", "64")
    nodes, pods = synth_cluster(40, 200)
    chunked = placements("torch", nodes, pods)
    assert chunked == placements("jax", nodes, pods)
    monkeypatch.setenv("OPEN_SIMULATOR_STREAM_PODS", "0")
    whole = placements("torch", nodes, pods)
    assert whole == placements("jax", nodes, pods)
    assert sum(a != b for a, b in zip(chunked, whole)) > 100
