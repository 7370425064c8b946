"""End to end: the PyTorch port's `simulate()` (plain PyTorch path on the CPU)
against the JAX package's `simulate()` on its serial route (use_waves=False).
The node of every pod and every failure reason must be equal."""

import os

import pytest

import open_simulator_torch
import open_simulator_torch.core.types as torch_types
import open_simulator_tpu.core.types as jax_types
from open_simulator_tpu.simulator import engine as jax_engine
from open_simulator_tpu.simulator.core import simulate as jax_simulate
from open_simulator_torch.models.workloads import reset_name_counter as torch_reset_names
from open_simulator_tpu.models.workloads import reset_name_counter as jax_reset_names
from torch_port_cases import CASES, build, outcome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_serial(monkeypatch):
    """The JAX simulate() with every pod on the serial schedule_batch route."""
    orig = jax_engine.Simulator.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.use_waves = False

    monkeypatch.setattr(jax_engine.Simulator, "__init__", init)

    def run(*args):
        jax_reset_names()  # generated pod names count from 1 on both sides
        return jax_simulate(*args)

    return run


def port_simulate(*args):
    torch_reset_names()
    return open_simulator_torch.simulate(*args, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_scenario_matches_jax(name, jax_serial):
    case = CASES[name]()
    want = outcome(jax_serial(*build(jax_types, case)))
    got = outcome(port_simulate(*build(torch_types, case)))
    assert got == want


def _demo1_simple(yamlio, types):
    cluster = yamlio.load_cluster_from_directory(os.path.join(REPO, "examples/cluster/demo_1"))
    app = types.AppResource("simple", yamlio.load_resources_from_directory(
        os.path.join(REPO, "examples/application/simple")))
    return cluster, [app]


def test_demo1_simple_matches_jax(jax_serial):
    from open_simulator_torch.utils import yamlio as torch_yamlio
    from open_simulator_tpu.utils import yamlio as jax_yamlio

    want = outcome(jax_serial(*_demo1_simple(jax_yamlio, jax_types)))
    got = outcome(port_simulate(*_demo1_simple(torch_yamlio, torch_types)))
    assert len(got["nodes"]) > 0
    assert got == want


def test_overflowing_synthetic_cluster_matches_jax():
    # 8 nodes x 256 pod slots cannot hold 2,500 pods: the reasons path runs
    from open_simulator_torch.utils.synth import synth_cluster as torch_synth
    from open_simulator_tpu.utils.synth import synth_cluster as jax_synth

    nodes, pods = jax_synth(8, 2500, hard_predicates=True)
    jsim = jax_engine.Simulator(nodes, use_mesh=False)
    jsim.use_waves = False
    jfailed = jsim.schedule_pods(pods)
    want = outcome(jax_types.SimulateResult(jfailed, jsim.get_cluster_node_status()))

    nodes, pods = torch_synth(8, 2500, hard_predicates=True)
    tsim = open_simulator_torch.Simulator(nodes, device="cpu")
    tfailed = tsim.schedule_pods(pods)
    got = outcome(torch_types.SimulateResult(tfailed, tsim.get_cluster_node_status()))
    assert len(got["reasons"]) > 0
    assert got == want
