"""The scenario-mesh cases of tests/test_torch_scenario_mesh.py, run on every
spawned rank, and the lane-block cases, run there on the CPU and by
tests/test_torch_cuda.py on the card.

Imports no JAX: the ranks are fresh processes. Each rank builds the inputs
from the fixture functions, the port's synth module and a numpy seed, runs
the port on its scenario mesh and returns plain values (probe results,
responses, report bytes, choices, the mesh's counters) that the test holds
against the JAX package on make_scenario_mesh(R) in the test process. The
step functions that take a package's objects (`probe_rounds`,
`serve_steps`, `scenario_seeds`) run the JAX package's objects there too.
"""

from __future__ import annotations

import contextlib
import copy
import io
import os

import numpy as np

from fixtures import make_node, make_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("zone-outage", "monte-carlo-mix", "preemption-storm")
MESH_ENV = "OPEN_SIMULATOR_MESH"


def spec_path(name: str) -> str:
    return os.path.join(REPO, "examples", "sweeps", f"{name}.yaml")


@contextlib.contextmanager
def mesh_env(value):
    """OPEN_SIMULATOR_MESH set to `value` (None: unset, so the sessions,
    images and engines take their meshes by themselves; the test suite sets
    it to 0) for a block."""
    prev = os.environ.pop(MESH_ENV, None)
    if value is not None:
        os.environ[MESH_ENV] = value
    try:
        yield
    finally:
        os.environ.pop(MESH_ENV, None)
        if prev is not None:
            os.environ[MESH_ENV] = prev


# ------------------------------------------------------------------ probe ----


def probe_cases() -> dict:
    """name -> (base, template, pods, services, n_new, rounds); each round's
    candidates are probed after ensure_capacity(max(round))."""
    from open_simulator_torch.utils.synth import synth_capacity_cluster

    base = [make_node(f"base-{i}", cpu="8", memory="16Gi") for i in range(2)]
    tpl = make_node("tpl", cpu="8", memory="16Gi")
    pods = [make_pod(f"p-{i}", cpu="2", memory="2Gi") for i in range(40)]
    cbase, ctpl, cpods, services = synth_capacity_cluster(16, 400)
    return {
        # tests/test_mesh_sharding.py:281 and :347 (five candidates, 8 lanes),
        # then the tables grow on the device to 20 and three more (4 lanes)
        "wave": (base, tpl, pods, [], 12, [[0, 3, 5, 7, 11], [12, 16, 20]]),
        # a segment of every kind (wave, cap-1 wave, group-serial, affinity,
        # serial); hostname rows, so the tables grow by a re-upload
        "every_kind": (cbase, ctpl, cpods, services, 8, [[0, 2, 4, 6, 8], [12, 20, 30]]),
    }


def probe_rounds(session, rounds) -> list:
    """Each round's probe_many, after growing the session to cover it."""
    out = []
    for ns in rounds:
        session.ensure_capacity(max(ns))
        out.append(session.probe_many(ns))
    return out


def xray_probe_records(session, ns, prefix: str) -> list:
    """The flight recorder's records of one probe_many round of `session`
    (either package's), written to PREFIX.jsonl, without the fields that
    name the process (backend_path, pid, created_unix)."""
    import json

    if type(session).__module__.startswith("open_simulator_tpu"):
        from open_simulator_tpu.obs import xray
    else:
        from open_simulator_torch.obs import xray
    xray.enable(prefix)
    try:
        session.probe_many(ns)
    finally:
        xray.disable()
    out = []
    with open(prefix + ".jsonl") as f:
        for line in f:
            rec = json.loads(line)
            for k in ("backend_path", "pid", "created_unix"):
                rec.pop(k, None)
            out.append(rec)
    return out


def port_session(case, device, mesh=None):
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.probe import ProbeSession

    base, tpl, pods, services, n_new, _ = case
    return ProbeSession.try_build(copy.deepcopy(base), tpl, copy.deepcopy(pods),
                                  ResourceTypes(services=list(services)), n_new=n_new,
                                  device=device, mesh=mesh)


# ------------------------------------------------------------------ serve ----


def make_cluster(n_nodes=10, n_bound=6):
    """tests/test_serve.py `make_cluster`."""
    nodes = [make_node(f"n-{i}", cpu="8", memory="16Gi") for i in range(n_nodes)]
    bound = [make_pod(f"bound-{i}", cpu="2", memory="2Gi",
                      node_name=f"n-{i % max(1, n_nodes // 3)}", labels={"app": f"svc-{i % 2}"})
             for i in range(n_bound)]
    return nodes, bound


def whatif_pods(tag, n=4, cpu="1", memory="1Gi", anti_on=None):
    """tests/test_serve.py `whatif_pods`."""
    affinity = None
    if anti_on:
        affinity = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": anti_on}},
            "topologyKey": "kubernetes.io/hostname"}]}}
    return [make_pod(f"wi-{tag}-{i}", cpu=cpu, memory=memory, labels={"app": f"wi-{tag}"},
                     affinity=affinity) for i in range(n)]


def serve_shapes() -> list:
    """tests/test_torch_serve.py `test_multi_lane_dispatch_equals_jax_and_fresh`:
    both lane routes, drains, and padding lanes (6 sessions in 8 lanes)."""
    shapes = [(whatif_pods("m0", 3), ()), (whatif_pods("m1", 5, cpu="2"), ("n-1",)),
              (whatif_pods("m2", 2, anti_on="svc-1"), ()),
              (whatif_pods("m3", 4, memory="2Gi"), ("n-0", "n-2")),
              (whatif_pods("m0", 9), ())]
    shapes.append((whatif_pods("mx", 2) + whatif_pods("my", 3, cpu="2"), ()))
    return shapes


RESPONSE_KEYS = ("scheduled", "total", "unscheduled", "utilization", "epoch", "lanes", "path")


def serve_steps(img) -> list:
    """The responses of: one dispatch of the six sessions; one session
    alone with a drain (one lane, padded to the mesh); an ingest batch (a
    bound pod added, a node drained); the six sessions again."""
    shapes = serve_shapes()
    out = img.dispatch_sessions([img.session(copy.deepcopy(p), drains=d) for p, d in shapes])
    out.append(img.session(whatif_pods("solo", 4), drains=("n-3",)).run())
    img.apply_events([
        {"type": "pod_add", "pod": make_pod("late-0", cpu="3", memory="2Gi", node_name="n-4",
                                            labels={"app": "svc-0"})},
        {"type": "node_drain", "name": "n-5"}])
    out += img.dispatch_sessions([img.session(copy.deepcopy(p), drains=d) for p, d in shapes])
    return [{k: r[k] for k in RESPONSE_KEYS} for r in out]


# -------------------------------------------------------------- scenarios ----


def scenario_seeds(padded_alloc: np.ndarray) -> np.ndarray:
    """Four starting utilizations of one cluster, [4, N, R] f32: empty,
    half of every node's allocatable, a seeded fraction of it, and the
    even nodes full."""
    a = np.asarray(padded_alloc, np.float32)
    rng = np.random.RandomState(5)
    full = a * (np.arange(a.shape[0]) % 2 == 0)[:, None]
    return np.stack([np.zeros_like(a), a * 0.5,
                     (rng.uniform(0.0, 0.9, a.shape) * a).astype(np.float32),
                     full.astype(np.float32)])


def scenarios_workload():
    """tests/test_parallel.py `test_scenarios_dp_axis`: 24 hard-predicate pods
    on 16 nodes."""
    from open_simulator_torch.utils.synth import synth_cluster

    return synth_cluster(16, 24, hard_predicates=True)


def fanout_workload():
    """tests/test_parallel.py:186: 24 pods on 12 nodes, four candidate
    node counts."""
    from open_simulator_torch.utils.synth import synth_cluster

    return synth_cluster(12, 24, hard_predicates=False), (3, 6, 9, 12)


# ------------------------------------------------------------- lane blocks ----


def _fanout_inputs(device):
    """Each of the eight fan-outs at S = 8 lanes on small inputs:
    [(name, tables, carry_s, active_s, args, per-lane argument positions,
    kwargs)]. The probe fan-outs take one segment of each kind of the
    `every_kind` session (lanes differ by their active rows); the serve and
    sweep fan-outs take eight sessions of an image, drains giving each lane
    its own seed carry, with per-lane groups, replica counts, cap1 flags,
    valid rows and pod streams."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_torch.simulator.encode import bucket_capped

    S = 8
    ses = port_session(probe_cases()["every_kind"], device)
    ses.ensure_capacity(S)
    active = np.zeros((S, ses._n_pad), bool)
    for i in range(S):
        active[i, :ses.n_base + i + 1] = True
    active = torch.from_numpy(active).to(ses.device)
    cry = K.carry_lanes(ses._seed, S)
    calls, seen = [], set()
    for seg in ses._segs:
        name, args, kw = ses.fanout_call(seg)
        if name not in seen:
            seen.add(name)
            calls.append((name, ses._tables, cry, active, args, (), kw))

    nodes, bound = make_cluster(10, 6)
    img = ResidentImage.try_build(nodes, pods=bound, device=device)
    sessions = [img.session(whatif_pods(f"l{i}", 2 + i, cpu=("1", "2")[i % 2],
                                        anti_on="svc-1" if i % 3 == 2 else None),
                            drains=(f"n-{i % 4}",) if i % 2 else ())
                for i in range(S)]
    img.ensure_staged()
    S, active_s, carry_np = img._lane_arrays(sessions)
    cry_s = K.Carry(*(torch.tensor(v, device=img.device) for v in carry_np))
    act = torch.from_numpy(active_s).to(img.device)
    routes = [img._wave_route(s) for s in sessions]
    g_s, m_s, cap1_s = (np.asarray(v) for v in zip(*routes))
    N = img._sim.na.N
    block = K.wave_block_for(int(m_s.max()), N)
    wave_kw = dict(block=block, kmax=K.wave_kmax(int(m_s.max()), N, block))
    calls.append(("serve_wave_fanout", img._tables, cry_s, act,
                  (g_s.astype(np.int32), m_s.astype(np.int32), cap1_s.astype(bool)), (0, 1, 2),
                  wave_kw))
    # two chained segments per lane: the lane's group, then lane 0's
    g_sk = np.stack([g_s, np.full(S, g_s[0])], axis=1).astype(np.int32)
    m_sk = np.stack([m_s, m_s[::-1]], axis=1).astype(np.int32)
    cap1_sk = np.stack([cap1_s, np.full(S, cap1_s[0])], axis=1).astype(bool)
    calls.append(("sweep_wave_fanout", img._tables, cry_s, act, (g_sk, m_sk, cap1_sk),
                  (0, 1, 2), wave_kw))
    union, spans = [], []
    for s in sessions:
        spans.append((len(union), len(s.batch)))
        union.extend(s.batch)
    P = bucket_capped(len(union), 2048)
    pod_group = np.zeros(P, np.int32)
    forced_node = np.full(P, -1, np.int32)
    pod_group[:len(union)], forced_node[:len(union)] = np.asarray(union, np.int32).T
    valid_s = np.zeros((S, P), bool)
    for li, (start, length) in enumerate(spans):
        valid_s[li, start:start + length] = True
    serial_kw = dict(n_zones=img._bt.n_zones, enable_gpu=False, enable_storage=False)
    calls.append(("serve_whatif_fanout", img._tables, cry_s, act,
                  (pod_group, forced_node, valid_s), (2,), serial_kw))
    pg_s = np.zeros((S, P), np.int32)
    fn_s = np.full((S, P), -1, np.int32)
    for li, s in enumerate(sessions):
        pg_s[li, :len(s.batch)], fn_s[li, :len(s.batch)] = np.asarray(s.batch, np.int32).T
    calls.append(("sweep_whatif_fanout", img._tables, cry_s, act,
                  (pg_s, fn_s, valid_s), (0, 1, 2), serial_kw))
    return calls


def _flat(out) -> list:
    """A fan-out's outputs as a list of tensors: the carry's leaves, then
    placed, counts or choices."""
    carry, rest = out
    return list(carry) + [rest]


def lane_block_cases(device, blocks: int, only=None, names=None) -> dict:
    """{fan-out: {"lanes": block lanes, "same": bool}}: for every block r of
    `blocks` (only block `only` when given, a rank's own), the fan-out run on
    that block's lanes alone (its carry, active rows and per-lane inputs)
    equals lanes [r*S/k, (r+1)*S/k) of one run over all S lanes, bit for bit
    on every output and carry leaf. On CUDA tensors the fan-outs launch the
    lane kernels; on CPU tensors they run the plain lanes. `names` picks
    fan-outs (all eight by default)."""
    import torch

    from open_simulator_torch.ops import kernels as K

    out = {}
    for name, tb, cry, act, args, per_lane, kw in _fanout_inputs(device):
        if names is not None and name not in names:
            continue
        fn = getattr(K, name)
        full = _flat(fn(tb, cry, act, *args, **kw))
        S = act.shape[0]
        b = S // blocks
        same = True
        for r in ([only] if only is not None else range(blocks)):
            blk = slice(r * b, (r + 1) * b)
            bargs = [a[blk] if i in per_lane else a for i, a in enumerate(args)]
            got = _flat(fn(tb, K.Carry(*(t[blk].contiguous() for t in cry)),
                           act[blk].contiguous(), *bargs, **kw))
            same &= all(torch.equal(x, y[blk]) for x, y in zip(got, full))
        out[name] = {"lanes": b, "same": bool(same)}
    return out


# ------------------------------------------------------------------ ranks ----


def _mesh_record(mesh) -> dict:
    return {"blocks": dict(mesh.blocks), "fetched": dict(mesh.fetched),
            "gathers": dict(mesh.counts["gather_lanes"]), "staged_bytes": mesh.staged_bytes}


def rank_cases(node_mesh, tmp_dir: str) -> dict:
    """Every case on one rank of a gloo world on the CPU (run_ranks hands
    each rank its node mesh; the cases build their scenario meshes)."""
    import torch

    from open_simulator_torch.parallel import (ShardedKernels, gather_lanes, make_node_mesh,
                                               make_scenario_mesh, put_fanout_inputs,
                                               schedule_scenarios_on_mesh)
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_torch.simulator.encode import pad_batch_tables
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.sweep import SweepRunner, build_report, load_spec, report_json

    torch.set_num_threads(1)
    os.nice(10)  # the ranks yield the CPU to the suite's other workers
    R = node_mesh.shards
    out = {"rank": node_mesh.rank, "world": R}

    # the probe session: an explicit mesh, the automatic one, repeated sessions
    out["probe"] = {}
    for name, case in probe_cases().items():
        mesh = make_scenario_mesh(R, device="cpu")
        ses = port_session(case, "cpu", mesh)
        got = probe_rounds(ses, case[5])
        with mesh_env(None):
            auto = port_session(case, "cpu")
            auto_got = probe_rounds(auto, case[5])
        out["probe"][name] = {"rounds": got, "auto_mesh": auto._mesh is not None,
                              "auto_same": auto_got == got, "uploads": ses.uploads,
                              "device_extensions": ses.device_extensions,
                              "segments": len(ses._segs),
                              "kinds": sorted({s[0] for s in ses._segs}), **_mesh_record(mesh)}
    case = probe_cases()["wave"]
    again = [probe_rounds(port_session(case, "cpu", make_scenario_mesh(R, device="cpu")),
                          case[5][:1]) for _ in range(3)]
    out["probe"]["wave"]["repeated_same"] = all(a == again[0] for a in again)
    out["probe"]["wave"]["xray"] = xray_probe_records(
        port_session(case, "cpu", make_scenario_mesh(R, device="cpu")), case[5][0],
        os.path.join(tmp_dir, f"xray{node_mesh.rank}"))

    # the resident image
    mesh = make_scenario_mesh(R, device="cpu")
    nodes, bound = make_cluster(10, 6)
    img = ResidentImage.try_build(copy.deepcopy(nodes), pods=copy.deepcopy(bound), device="cpu",
                                  mesh=mesh)
    responses = serve_steps(img)
    with mesh_env(None):
        auto_img = ResidentImage.try_build(copy.deepcopy(nodes), pods=copy.deepcopy(bound),
                                           device="cpu")
    out["serve"] = {"responses": responses, "auto_mesh": auto_img._mesh is not None,
                    "cache_keys": sorted(img._carry_devcache), **_mesh_record(mesh)}

    # the three example sweeps (parity off: the fresh oracle is not the mesh's path)
    out["sweep"] = {}
    for name in SPECS:
        mesh = make_scenario_mesh(R, device="cpu")
        runner = SweepRunner(load_spec(spec_path(name)), parity="off", mesh=mesh, device="cpu")
        runner.run()
        out["sweep"][name] = {"report": report_json(build_report(runner)),
                              "image_mesh": runner.image._mesh is mesh, **_mesh_record(mesh)}

    # put_fanout_inputs and a ShardedKernels fan-out, gathered (test_parallel.py:186)
    mesh = make_scenario_mesh(R, device="cpu")
    (nodes, pods), counts = fanout_workload()
    sim = Simulator(nodes, device="cpu", use_mesh=False)
    bt = sim.encode_batch(pods)
    S = len(counts)
    active = np.zeros((S, bt.alloc.shape[0]), bool)
    for i, n in enumerate(counts):
        active[i, :n] = True
    seeds = tuple(np.broadcast_to(getattr(bt, "seed_" + f), (S,) + getattr(bt, "seed_" + f).shape)
                  for f in ("requested", "nonzero", "port_used", "counter", "carrier", "dev_used",
                            "vg_req", "sdev_alloc"))
    tables, carry_s, act = put_fanout_inputs(mesh, bt, seeds, active)
    _, placed = ShardedKernels(mesh).probe_serial_fanout(
        tables, carry_s, act, torch.from_numpy(bt.pod_group), torch.from_numpy(bt.forced_node),
        torch.from_numpy(bt.valid), n_zones=bt.n_zones)
    out["put_fanout"] = {"placed": gather_lanes(placed, mesh).tolist(),
                         "carry_lanes": int(carry_s.requested.shape[0]),
                         "active_lanes": int(act.shape[0])}

    # schedule_scenarios_on_mesh on the 2-D mesh (two scenario groups)
    if R == 4:
        mesh2 = make_node_mesh(R, device="cpu", scenario_axis=2)
        nodes, pods = scenarios_workload()
        bt = Simulator(nodes, device="cpu", use_mesh=False).encode_batch(pods)
        seeds = scenario_seeds(pad_batch_tables(bt, mesh2.shards).alloc)
        choices = schedule_scenarios_on_mesh(bt, mesh2, seeds)
        out["scenarios"] = {"choices": choices.tolist(), "shape": mesh2.shape,
                            "lane_group": mesh2.lane_group, **_mesh_record(mesh2)}

    # each lane kernel's block on this rank against one run over all lanes
    out["lane_blocks"] = lane_block_cases("cpu", R, only=mesh.lane_group)

    # the sweep CLI on the ranks, each rank's --out a path of its own
    if R == 2:
        from open_simulator_torch.cli.main import main

        path = os.path.join(tmp_dir, f"rank{node_mesh.rank}.json")
        stdout, stderr = io.StringIO(), io.StringIO()
        with mesh_env(None), contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc = main(["sweep", spec_path("zone-outage"), "--out", path, "--device", "cpu"])
        report = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                report = f.read()
        out["cli"] = {"rc": rc, "report": report, "stdout": stdout.getvalue(),
                      "stderr": stderr.getvalue()}
    return out
