"""K1 and K14's rows stage at every cluster size, on one GPU.

    python open_simulator_torch/utils/shape_sweep.py [--reps R]

Times K1 (csrc/feasibility.cu) on the decision sets of `utils/walls.py
--kernels --cases K1` (the hard shape's first group, N 5,120; the extended
cluster's first GPU group with EXT, N 2,048; the spread cluster's first
group with a hostname DoNotSchedule term) and K14's rows stage
(csrc/commit_sharded.cu) on rank 0's block of `--mesh-kernels --cases K14`'s
two waves (extended's first 1-GPU wave with gpu_live, NL 1,024; northstar's
first wave, NL 5,120), each with its cluster shape forced to every C of
ops/cluster.py SIZES and as ops/cluster.py `choose` gives it: device time
per launch under torch.profiler, mean of `--reps` launches. One process,
one rank: the rows stage's all_gather_rows is replaced by the block's own
sums twice, which the rows stage never reads. Prints one JSON line, with
the card's name and power limit and a one-element fill's device time (the
launch floor). Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("shape_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from open_simulator_torch.ops import build, cluster
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel import collectives
    from open_simulator_torch.parallel.mesh import block_of
    from open_simulator_torch.utils import walls

    build.library()
    synth = walls._synth()
    real_shape = K._cluster_shape
    forced = {}

    def shape_of(lib, kernel, lanes, ext, v, S, block=0):
        shape = real_shape(lib, kernel, lanes, ext, v, S, block)
        C = forced.get(kernel)
        if C is None:
            return shape
        smem = int(lib.feasibility_smem(ctypes.byref(v), C, int(ext))) if kernel == "k1" else 0
        return shape._replace(C=C, smem=smem)

    K._cluster_shape = shape_of
    collectives.all_gather_rows = lambda t, mesh: torch.cat([t] * mesh.shards)

    def sweep(kernel, fn, names):
        out = {}
        for C in (None,) + cluster.SIZES:
            forced[kernel] = C
            out["choose" if C is None else f"C{C}"] = sum(
                walls._device_ms(fn, args.reps, args.reps, names).values())
        forced.pop(kernel)
        return out

    res = {"card": walls._card(), "launch_floor": walls._launch_floor(args.reps), "reps": args.reps}
    for label, spec in (("hard", walls.KINDS["hard_waves"]), ("extended", walls.KINDS["extended"]),
                        ("spread", walls.KINDS["spread"])):
        sim, bt, tb, seed, segs, P = walls._case_cluster(synth, *spec)
        N = int(tb.alloc.shape[0])
        if label == "spread":
            g = next(int(x) for x in bt.pod_group[:P]
                     if int(tb.dns_edom[int(x)].sum(dim=1).max()) > N // 2)
        else:
            g = next(int(x) for x in bt.pod_group[:P]
                     if label != "extended" or bt.grp_gpu_mem[int(x)] > 0)
        flags = dict(enable_gpu=label == "extended", enable_storage=label == "extended")

        def k1(tb=tb, seed=seed, g=g, flags=flags):
            return K.feasibility_kernel(tb, seed, g, -1, True, **flags)

        res[f"K1 {label}"] = dict(nodes=N, group=g, **sweep("k1", k1, ("feasibility_kernel",)))
        if label != "spread":
            spec14 = spec if label == "extended" else ("plain", 10000, 100000)
            if label == "hard":
                sim, bt, tb, seed, segs, P = walls._case_cluster(synth, *spec14, use_mesh=False)
            seg = walls._first_wave(sim, segs, label == "extended", False)
            j = walls._wave_counts(sim, tb, seed, seg)
            mesh = types.SimpleNamespace(rank=0, shards=2, device=torch.device("cuda"))
            tbl, seedl = block_of(tb, seed, mesh)
            NL = int(tbl.alloc.shape[0])
            jl = j[:NL].contiguous()

            def k14(tbl=tbl, seedl=seedl, g=seg[3], jl=jl, gl=bool(seg[5]), mesh=mesh):
                return K.aggregate_commit_sharded_kernel(tbl, seedl, g, jl, gl, mesh)

            name = "extended first 1-GPU wave gpu_live" if label == "extended" else \
                "northstar first wave"
            res[f"K14 rows {name}"] = dict(block_nodes=NL, copies=int(jl.sum()), **sweep(
                "k14", k14, ("commit_sharded_rows",)))
        del sim, bt, tb, seed
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
