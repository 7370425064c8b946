"""The hand kernels' fixed axes (ROADMAP §C10), stated and refused by name.

The kernels hold a group's term slots, a node's GPU / volume-group / storage
devices and the domain keys in fixed arrays (csrc/common.cuh MAX_SLOTS 64,
MAX_NODE_DEVS 32; the affinity kernels' 32-bit (domain, position) key,
AFFINITY_MAX_D1 = 2^21): a table past one of them is refused with a
ValueError that names the axis, before any kernel is built or launched, so
these run on the CPU. The JAX package schedules such tables; no golden and
no bench.py shape reaches the caps.
"""

import pytest
import torch

from open_simulator_torch.ops import kernels as K
from open_simulator_torch.simulator.engine import Simulator
from open_simulator_torch.utils.synth import synth_cluster


@pytest.fixture(scope="module")
def tables():
    nodes, pods = synth_cluster(16, 64, hard_predicates=True)
    sim = Simulator(nodes, device="cpu")
    bt = sim.encode_batch(pods)
    tb, cry = sim._to_device(bt)
    return tb, cry


def _view(tb, cry, **kw):
    return K._view(tb, cry, 2, K.DEFAULT_WEIGHTS, K.DEFAULT_FILTERS, **kw)


def test_the_caps_are_the_kernels():
    assert (K.MAX_SLOTS, K.MAX_NODE_DEVS, K.AFFINITY_MAX_D1) == (64, 32, 2 ** 21)


def test_slot_axis_past_the_cap_is_refused(tables):
    tb, cry = tables
    _view(tb, cry)  # the encoder's own axes are taken
    G = tb.req_aff_t.shape[0]
    wide = tb._replace(req_aff_t=torch.full((G, 65), -1, dtype=tb.req_aff_t.dtype))
    with pytest.raises(ValueError, match="slot axis A=65 exceeds the kernel's 64"):
        _view(wide, cry)
    at_cap = tb._replace(req_aff_t=torch.full((G, 64), -1, dtype=tb.req_aff_t.dtype))
    assert _view(at_cap, cry).A == 64


def test_node_device_axis_past_the_cap_is_refused_with_the_gpu_branch_on(tables):
    tb, cry = tables
    N = tb.dev_total.shape[0]
    wide = tb._replace(dev_total=torch.zeros((N, 33), dtype=tb.dev_total.dtype))
    with pytest.raises(ValueError, match="node axis MAXDEV=33 exceeds the kernel's 32"):
        _view(wide, cry, enable_gpu=True)
    assert _view(wide, cry, enable_gpu=False).MAXDEV == 33  # the branch off: never read


def test_domain_axis_past_the_cap_is_refused_by_the_affinity_kernels(tables):
    tb, cry = tables
    T = cry.counter.shape[0]
    wide = cry._replace(counter=torch.zeros((T, K.AFFINITY_MAX_D1 + 1), dtype=torch.float32))
    msg = f"domain axis D1={K.AFFINITY_MAX_D1 + 1} exceeds the kernel's {K.AFFINITY_MAX_D1}"
    for kernel in (K.schedule_affinity_wave_kernel, K.schedule_affinity_wave_sharded_kernel,
                   K.schedule_affinity_wave_rounds_kernel):
        with pytest.raises(ValueError, match=msg):
            kernel(tb, wide, 0, 4, False)
    lanes = wide._replace(counter=wide.counter[None])
    active = torch.ones((1, tb.alloc.shape[0]), dtype=torch.bool)
    with pytest.raises(ValueError, match=msg):
        K.schedule_affinity_wave_lanes_kernel(tb, lanes, active, 0, 4, False)
