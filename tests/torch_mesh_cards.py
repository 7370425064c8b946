"""The mesh with one card per rank (NCCL, as `choose_backend` picks it).

    python tests/torch_mesh_cards.py [RANKS]      # default: every card of the host

The node axis, on each rank's block of the partitioned layout: K8 and K9
against their plain sharded versions and the unsharded K3 / K5 on the
seeded workload of tests/torch_mesh_cases.py, and the engine's default
route on the mesh against the unsharded engine on the JAX mesh tests'
workloads, with one pmax and one all-gather per epoch beside the other
routes' collectives (`route_calls`, `fetch_calls`); then the wave's per-round path above the epoch
limit: K10 against its plain per-round version and K3 on the seeded
per-round cases (the limit at 16), and the engine on the N = 2,560
`rounds_workload` (the default limit) against the unsharded engine, with
two pmax and two all_gather_rows per round; and the affinity wave's
sharded tail: K11 against its plain version and K5 on the seeded tail
cases, and the engine on the N = 2,560 `tail_workload` against the
unsharded engine, with the tail's collectives per branch. The scenario axis, on a scenario mesh of one group
per rank (tests/torch_scenario_cases.py): each lane kernel's block of
lanes against a full launch, and the probe sessions, the what-if
responses and the example sweeps' reports (parity off) on the mesh against
the same run on one rank, with one gather per output at every fetch.
Prints every rank's record and exits non-zero on any difference. Imports
no JAX.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch_mesh_cases as C  # noqa: E402
import torch_scenario_cases as SC  # noqa: E402


def scenario_cases() -> dict:
    """The scenario-axis cases on this rank: True where the mesh's result
    equals the one-rank run's (and the fetches gathered as they should)."""
    import copy

    from open_simulator_torch.parallel import make_scenario_mesh
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_torch.sweep import SweepRunner, build_report, load_spec, report_json

    mesh = make_scenario_mesh(device="cuda")
    out = {"lane_blocks": all(v["same"] for v in SC.lane_block_cases(
        "cuda", mesh.scenarios, only=mesh.lane_group).values())}
    with SC.mesh_env("0"):
        for name, case in SC.probe_cases().items():
            got = SC.probe_rounds(SC.port_session(case, "cuda", mesh), case[5])
            out[f"probe_{name}"] = got == SC.probe_rounds(SC.port_session(case, "cuda"), case[5])
        nodes, bound = SC.make_cluster(10, 6)
        got, want = (SC.serve_steps(ResidentImage.try_build(
            copy.deepcopy(nodes), pods=copy.deepcopy(bound), device="cuda", mesh=m))
            for m in (mesh, None))
        out["serve"] = got == want
        for spec in SC.SPECS:
            reports = []
            for m in (mesh, None):
                runner = SweepRunner(load_spec(SC.spec_path(spec)), parity="off", mesh=m,
                                     device="cuda")
                runner.run()
                reports.append(report_json(build_report(runner)))
            out[f"sweep_{spec}"] = reports[0] == reports[1]
    out["gathers"] = (mesh.counts["gather_lanes"]["calls"] == 2 * sum(mesh.fetched.values())
                      and all(S == b * mesh.scenarios for b, S in mesh.fetched))
    return out


def rank_fn(mesh) -> dict:
    import torch

    out = {"rank": mesh.rank, "backend": mesh.backend, "transport": mesh.transport,
           "device": torch.cuda.current_device(), "kernels": C.card_kernels(mesh)}
    for name, make in C.WORKLOADS.items():
        nodes, pods = make()
        got = C.run_engine(nodes, pods, mesh=mesh, device="cuda")
        want = C.run_engine(nodes, pods, mesh=None, device="cuda")
        epochs = got["wave"]["iterations"] + got["affinity"]["epochs"]
        out[name] = {"same": got["placed"] == want["placed"] and got["failed"] == want["failed"],
                     "calls": {k: v["calls"] for k, v in got["counts"].items()},
                     "epochs": epochs,
                     "want": C.summed_calls({"pmax": epochs, "all_gather_tiled": epochs,
                                             "all_gather_rows": 0},
                                            C.route_calls(got), C.fetch_calls(got))}
    out["round_kernels"] = C.card_round_kernels(mesh)
    nodes, pods = C.rounds_workload()
    got = C.run_engine(nodes, pods, mesh=mesh, device="cuda")
    want = C.run_engine(nodes, pods, mesh=None, device="cuda")
    out["rounds"] = {"same": got["placed"] == want["placed"] and got["failed"] == want["failed"],
                     "calls": {k: v["calls"] for k, v in got["counts"].items()},
                     "rounds": got["wave"]["iterations"],
                     "want": C.summed_calls(C.round_calls(got["wave"]["iterations"]),
                                            C.route_calls(got), C.fetch_calls(got))}
    out["tail_kernels"] = C.card_tail_kernels(mesh)
    nodes, pods, services = C.tail_workload()
    got = C.run_engine(nodes, pods, services, mesh=mesh, device="cuda")
    want = C.run_engine(nodes, pods, services, mesh=None, device="cuda")
    out["tail"] = {"same": got["placed"] == want["placed"] and got["failed"] == want["failed"],
                   "calls": {k: v["calls"] for k, v in got["counts"].items()},
                   "want": C.summed_calls(C.round_calls(got["wave"]["iterations"]),
                                          C.tail_calls(got["branches"]), C.route_calls(got),
                                          C.fetch_calls(got)),
                   "epochs": got["affinity"]["epochs"],
                   "tail_epochs": C.tail_epochs(got["branches"])}
    out["scenario"] = scenario_cases()
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
    ok &= all(r[n]["same"] and r[n]["epochs"] > 0 and r[n]["calls"] == r[n]["want"]
              for r in res for n in C.WORKLOADS)
    ok &= all(k["same_plain"] and k["same_unsharded"]
              and k["calls"] == {"pmax": 2 * k["stats"][0], "all_gather_tiled": 0,
                                 "all_gather_rows": 2 * k["stats"][0]}
              for r in res for k in r["round_kernels"])
    ok &= all(r["rounds"]["same"] and r["rounds"]["rounds"] > 0
              and r["rounds"]["calls"] == r["rounds"]["want"] for r in res)
    ok &= all(k["same_plain"] and k["same_unsharded"] and k["same_branches"]
              and k["calls"] == C.tail_calls(k["branches"])
              for r in res for k in r["tail_kernels"])
    ok &= all(r["tail"]["same"] and r["tail"]["epochs"] == r["tail"]["tail_epochs"] > 0
              and r["tail"]["calls"] == r["tail"]["want"] for r in res)
    ok &= all(all(r["scenario"].values()) for r in res)
    print("mesh on", ranks, "cards:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
