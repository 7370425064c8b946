"""The affinity route end to end: the PyTorch port against the JAX package.

On every case of tests/test_torch_affinity.py, the port's default
`Simulator.schedule_pods` (the segment router, its affinity segments on the
affinity wave) equals the JAX package's default pod for pod: node per pod and
the reason string of every unscheduled pod.
"""

import copy

import pytest

from test_torch_affinity import CASES
from test_torch_waves import _jax_default, _port_default


@pytest.mark.parametrize("name", sorted(CASES))
def test_default_route_matches_jax(name):
    nodes, bound, pods, services = CASES[name]()
    want = _jax_default(nodes, copy.deepcopy(bound + pods), services)
    got, sim = _port_default(nodes, copy.deepcopy(bound + pods), services)
    assert got == want
    # the router sends the anti-affinity against another app to the plain wave
    assert ("wave" if name == "anti_other_app" else "affinity") in sim.segment_census
    if name == "synth_affinity":
        assert set(sim.segment_census) == {"affinity"} and len(got["reasons"]) > 0
