"""K3's usable table depth (open_simulator_torch/ops/csrc/wave.cu).

The kernel builds each wave segment's score table at depth A = max(1,
min(B, the largest capacity of a base-feasible node)) and selects with kmax
min(kmax, N * A), while the host still chooses B and kmax. No node can take
more than its capacity, so a node's usable prefix, its first hidden entry
and the entry that empties it lie within its first min(capacity, B) + 1
entries, and the flat index n * A + k orders the usable entries as n * B + k
does. Here the port's plain `schedule_wave_plain` at depth A is held against
itself at depth B (counts, placed and every loop statistic) and against the
JAX package's `schedule_wave` at depth B, on every wave segment of
tests/test_torch_waves.py's workloads: cap1 segments (A = 1), host ports,
flat scores, rising columns (the guard and the head fallback) and spread.
"""

import numpy as np
import pytest
import torch

from open_simulator_torch.ops import kernels as tk
from open_simulator_tpu.ops import kernels as jk
from test_torch_waves import WAVE_WORKLOADS, _batch

# the engine's block and kmax, block 8 with kmax 16 (the guard, more
# iterations) and the deepest block, 64
BLOCKS = ("engine", 8, 64)


def usable_depth(tt, tc, g: int, cap1: bool, block: int) -> int:
    """K3's depth rule: the largest capacity over the base-feasible nodes
    (the capacity is 0 off them), at least 1 and at most `block`."""
    base, _ = tk.feasibility(tt, tc, g, -1, True, tk.DEFAULT_FILTERS)
    cap = tk._base_capacity(tt, tc, g, cap1, base, tk.DEFAULT_FILTERS)
    return max(1, min(block, int(cap.max())))


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("name", WAVE_WORKLOADS)
def test_usable_depth_takes_what_depth_b_takes(name, blocks):
    bt, jt, jc, tt, tc, segs = _batch(name)
    N = bt.alloc.shape[0]
    waves = [s for s in segs if s[0] == "wave"]
    assert waves
    seen = []
    for _, _, m, g, cap1, _ in waves:
        cap1 = bool(cap1)
        B = jk.wave_block_for(m, N) if blocks == "engine" else blocks
        kmax = 16 if blocks == 8 else jk.wave_kmax(m, N, B)
        j_b, p_b, st_b = tk.schedule_wave_plain(tt, tc, g, m, cap1, block=B, kmax=kmax)
        A = usable_depth(tt, tc, g, cap1, B)
        j_a, p_a, st_a = tk.schedule_wave_plain(tt, tc, g, m, cap1, block=A,
                                                kmax=min(kmax, N * A))
        assert torch.equal(j_a, j_b), (g, B, A)
        assert p_a == p_b and st_a == st_b, (g, B, A, st_a, st_b)
        _, want_j, want_p = jk.schedule_wave(jt, jc, np.int32(g), np.int32(m), np.bool_(cap1),
                                             block=B, kmax=kmax)
        assert np.array_equal(np.asarray(want_j), j_b.numpy()) and int(want_p) == p_b
        seen.append((cap1, A, B, st_b))
    if name in ("hard", "ports"):  # capacity-1 waves build two entries a node
        assert any(cap1 and A == 1 for cap1, A, _, _ in seen)
    if name == "flat":  # deep nodes keep the full depth
        assert any(A == B for _, A, B, _ in seen)
    if name == "rising" and blocks == 8:
        st = seen[0][3]
        assert st["head_fallbacks"] > 0 and st["guarded"] > 0
