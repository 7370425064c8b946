"""Run a function on N spawned ranks of one host, each in its own process
(the `spawn` start method: CUDA does not survive `fork`), joined into one
process group through a file rendezvous, and return every rank's result.

    results = run_ranks(fn, 2, rdzv_dir)  # fn(mesh, *args) per rank, on CUDA
    results = run_ranks(fn, 2, rdzv_dir, device="cpu")  # the plain path, gloo

The ranks run on CUDA unless the caller asks for the CPU; without a card
only an explicit `device="cpu"` runs. The tests use it with gloo on the
CPU; `chip_smoke.py` with two ranks that share one card (gloo, CUDA tensors
staged through host memory). Where each rank has a card of its own,
`torchrun --nproc-per-node N` with `parallel.initialize_distributed()` is
the way to run. A rank that raises or dies fails the whole run: the others
are stopped and `run_ranks` raises, within `timeout_s`; it never returns the
results of fewer ranks.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from typing import Callable, List, Optional

from ..simulator.engine import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def _rank_main(fn, rank: int, world: int, init_method: str, backend: Optional[str], device,
               timeout_s: float, args: tuple, results) -> None:
    import torch.distributed as dist

    from .distributed import initialize
    from .mesh import make_node_mesh

    try:
        initialize(init_method=init_method, world_size=world, rank=rank, backend=backend,
                   device=device, timeout_s=timeout_s)
        out = fn(make_node_mesh(n_devices=world, device=device), *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, rdzv_dir: str, args: tuple = (), device=None,
              backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> List[object]:
    """fn(mesh, *args) on `world` spawned ranks (fn importable by name, its
    result picklable); returns the results in rank order. `rdzv_dir` must
    be a fresh directory of this run (the rendezvous file goes there)."""
    import multiprocessing as mp

    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = "file://" + os.path.join(os.path.abspath(rdzv_dir), "rdzv")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init_method, backend, device,
                                                  timeout_s, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    errors.append(f"a rank exited with code {dead[0]} before reporting")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"ranks still running after {timeout_s} s")
                    break
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank} failed:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    return [got[r] for r in range(world)]
