"""The PyTorch port's host encoder (its own copy of simulator/encode.py, with
the pure-Python pod signature) must produce the JAX package's BatchTables
field by field, exactly: group ids are handed out in order of first
appearance, whatever the signature's hash."""

import dataclasses

import numpy as np
import pytest

import open_simulator_torch.core.types as torch_types
import open_simulator_tpu.core.types as jax_types
from open_simulator_torch.simulator.engine import Simulator as TorchSimulator
from open_simulator_torch.utils.synth import synth_cluster as torch_synth
from open_simulator_tpu.models.workloads import expand_workloads_excluding_daemonsets
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from open_simulator_tpu.utils.synth import synth_cluster as jax_synth
from torch_port_cases import CASES, build


def assert_tables_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "BatchTables"
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)]
    for f in fa:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(x, y), f
        else:
            assert x == y, f


def _app_pods(types_mod, case):
    """The first app's pods, expanded by each package's own workload code."""
    from open_simulator_torch.models.workloads import generate_valid_pods_from_app as tg
    from open_simulator_tpu.models.workloads import generate_valid_pods_from_app as jg

    cluster, apps = build(types_mod, case)
    gen = jg if types_mod is jax_types else tg
    return cluster.nodes, gen(apps[0].name, apps[0].resource, cluster.nodes)


@pytest.mark.parametrize("name", ["basic", "taints_and_selectors", "interpod_affinity",
                                  "topology_spread"])
def test_batch_tables_match_jax(name):
    case = CASES[name]()
    jnodes, jpods = _app_pods(jax_types, case)
    tnodes, tpods = _app_pods(torch_types, case)
    jsim = JaxSimulator(jnodes, use_mesh=False)
    tsim = TorchSimulator(tnodes, device="cpu")
    # cluster pods first (bound ones seed the carry), then the app batch
    jcl, _ = build(jax_types, case)
    tcl, _ = build(torch_types, case)
    jsim.schedule_pods(expand_workloads_excluding_daemonsets(jcl))
    from open_simulator_torch.models.workloads import (
        expand_workloads_excluding_daemonsets as texpand)
    tsim.schedule_pods(texpand(tcl))
    assert_tables_equal(tsim.encode_batch(tpods), jsim.encode_batch(jpods))


def test_batch_tables_match_jax_hard_synthetic():
    jnodes, jpods = jax_synth(64, 640, hard_predicates=True)
    tnodes, tpods = torch_synth(64, 640, hard_predicates=True)
    jsim = JaxSimulator(jnodes, use_mesh=False)
    tsim = TorchSimulator(tnodes, device="cpu")
    assert_tables_equal(tsim.encode_batch(tpods), jsim.encode_batch(jpods))
