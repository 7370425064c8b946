"""The node mesh with one card per rank (NCCL, as `choose_backend` picks it).

    python tests/torch_mesh_cards.py [RANKS]      # default: every card of the host

On each rank: K8 and K9 against their plain sharded versions and the
unsharded K3 / K5 on the seeded workload of tests/torch_mesh_cases.py, and
the engine on the mesh against the unsharded engine on the JAX mesh tests'
workloads, with one pmax and one all-gather per epoch. Prints every rank's
record and exits non-zero on any difference. Imports no JAX.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch_mesh_cases as C  # noqa: E402


def rank_fn(mesh) -> dict:
    import torch

    out = {"rank": mesh.rank, "backend": mesh.backend, "transport": mesh.transport,
           "device": torch.cuda.current_device(), "kernels": C.card_kernels(mesh)}
    for name, make in C.WORKLOADS.items():
        nodes, pods = make()
        got = C.run_engine(nodes, pods, mesh=mesh, device="cuda")
        want = C.run_engine(nodes, pods, mesh=None, device="cuda")
        out[name] = {"same": got["placed"] == want["placed"] and got["failed"] == want["failed"],
                     "calls": {k: v["calls"] for k, v in got["counts"].items()},
                     "epochs": got["wave"]["iterations"] + got["affinity"]["epochs"]}
    return out


def main() -> int:
    import torch

    from open_simulator_torch.ops import build
    from open_simulator_torch.parallel.launch import run_ranks

    ranks = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(ranks, 2):
        print(f"needs {max(ranks, 2)} CUDA devices", file=sys.stderr)
        return 2
    build.library()  # built once, before the ranks load it
    os.makedirs(os.path.join(os.path.dirname(HERE), "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(os.path.dirname(HERE), "build")) as d:
        res = run_ranks(rank_fn, ranks, d, device="cuda", timeout_s=600)
    for r in res:
        print(json.dumps(r))
    ok = all(r["backend"] == "nccl" and r["transport"] == "direct" for r in res)
    ok &= all(k["same_plain"] and k["same_unsharded"] for r in res for k in r["kernels"])
    ok &= all(r[n]["same"] and r[n]["epochs"] > 0
              and r[n]["calls"] == {"pmax": r[n]["epochs"], "all_gather_tiled": r[n]["epochs"]}
              for r in res for n in C.WORKLOADS)
    print("mesh on", ranks, "cards:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
