"""Where the JAX package's CPU numerics and the PyTorch port's can part.

    JAX_PLATFORMS=cpu python tools/torch_port_numerics.py

Prints (1) how often a jitted f32 `a*b + c` on XLA-CPU equals the fused
multiply-add and how often the separately rounded result, over 1M random
triples (numpy seed 0), and (2) for the integers 2..2,000,001 (the inputs
`log(topology size + 2)` can see), how many f32 `log` values of XLA-CPU and
of torch's CPU kernel differ from the correctly rounded one, and the first
few such integers below 10,002.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    rng = np.random.default_rng(0)
    n = 1_000_000
    a = rng.random(n).astype(np.float32) * 100
    b = rng.random(n).astype(np.float32)
    c = rng.random(n).astype(np.float32)
    got = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    fused = (a.astype(np.float64) * b + c).astype(np.float32)
    separate = a * b + c
    x = np.arange(2, 2_000_002, dtype=np.float32)
    exact = np.log(x.astype(np.float64)).astype(np.float32)
    xla = np.asarray(jax.jit(jnp.log)(x))
    tch = torch.log(torch.from_numpy(x)).numpy()
    print(json.dumps({
        "fma_triples": n,
        "xla_equals_fma": int((got == fused).sum()),
        "xla_equals_separate": int((got == separate).sum()),
        "log_integers": int(x.size),
        "xla_log_not_correctly_rounded": int((xla != exact).sum()),
        "torch_cpu_log_not_correctly_rounded": int((tch != exact).sum()),
        "xla_first_below_10002": x[(xla != exact) & (x < 10002)][:5].astype(int).tolist(),
        "xla_count_below_10002": int(((xla != exact) & (x < 10002)).sum()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
