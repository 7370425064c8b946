"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX (the GPU host need not have it), so it runs there as

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

and skips on a host without a CUDA device: the kernels have no CPU mode.
"""

import pytest
import torch

from open_simulator_torch.ops import kernels as K
from open_simulator_torch.simulator.engine import Simulator
from open_simulator_torch.utils.synth import synth_cluster


@pytest.mark.cuda
def test_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    nodes, pods = synth_cluster(256, 1500, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    kc, kch = K.schedule_batch_kernel(tb, seed, *args, bt.n_zones)
    pc, pch = K.schedule_batch_plain(tb, seed, *args, bt.n_zones)
    assert torch.equal(kch, pch)
    for f in ("requested", "nonzero", "port_used", "counter", "carrier"):
        assert torch.equal(getattr(kc, f), getattr(pc, f)), f
    for g in sorted({int(g) for g in bt.pod_group[:len(pods)]}):
        for cry in (seed, kc):
            kf, ks = K.feasibility_kernel(tb, cry, g, -1, True)
            pf, ps = K.feasibility(tb, cry, g, -1, True)
            assert torch.equal(kf, pf)
            for k in K.STAGE_KEYS:
                assert torch.equal(ks[k], ps[k]), k


@pytest.mark.cuda
def test_topology_weight_on_the_card_matches_the_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.arange(0, 1 << 20, dtype=torch.float32)
    assert torch.equal(K.topology_weight(x.cuda()).cpu(), K.topology_weight(x))
