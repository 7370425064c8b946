"""The node-mesh cases of tests/test_torch_mesh.py, run on every spawned rank.

Imports no JAX (the ranks are fresh processes): each rank builds the same
inputs from the fixture builders and a numpy seed, runs the port on its
mesh, and returns plain values (placements by pod name, collective
counters, epoch statistics) that the test holds against the JAX package's
run and the port's unsharded run in the test process.
"""

from __future__ import annotations

import copy
import os
from collections import Counter

import numpy as np

from fixtures import make_node, make_pod

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


def _spread(pod, app, topo, skew):
    pod["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": skew, "topologyKey": topo, "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": app}}}]
    return pod


def _required(pod, kind, app, topo):
    pod["spec"]["affinity"] = {kind: {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"topologyKey": topo, "labelSelector": {"matchLabels": {"app": app}}}]}}
    return pod


def mixed_workload():
    """tests/test_mesh_sharding.py `_mixed_workload`: every route (wave, cap1
    wave, affinity, serial) on 26 nodes (phantom padding)."""
    nodes = [make_node(f"n{i}", cpu="16", memory="32Gi", pods="24") for i in range(26)]
    pods = [make_pod(f"web-{i}", cpu="250m", memory="256Mi", labels={"app": "web"})
            for i in range(40)]
    pods += [_spread(make_pod(f"sp-{i}", cpu="100m", memory="64Mi", labels={"app": "sp"}),
                     "sp", HOST, 2) for i in range(30)]
    pods += [make_pod(f"porty-{i}", cpu="100m", memory="64Mi", labels={"app": "porty"},
                      host_ports=[9090]) for i in range(10)]
    for i in range(6):
        pods.append(make_pod(f"a-{i}", cpu="300m", memory="128Mi"))
        pods.append(make_pod(f"b-{i}", cpu="100m", memory="512Mi"))
    return nodes, pods


def hard_affinity_workload():
    """tests/test_mesh_sharding.py `_hard_affinity_workload`: hostname
    self-anti-affinity that overflows (4 fail), required self-affinity (the
    bootstrap), DoNotSchedule spread at maxSkew 1."""
    nodes = [make_node(f"h{i}", cpu="16", memory="32Gi", pods="24") for i in range(26)]
    pods = [_required(make_pod(f"anti-{i}", cpu="100m", memory="64Mi", labels={"app": "anti"}),
                      "podAntiAffinity", "anti", HOST) for i in range(30)]
    pods += [_required(make_pod(f"pack-{i}", cpu="100m", memory="64Mi", labels={"app": "pack"}),
                       "podAffinity", "pack", HOST) for i in range(12)]
    pods += [_spread(make_pod(f"hs-{i}", cpu="100m", memory="64Mi", labels={"app": "hs"}),
                     "hs", HOST, 1) for i in range(20)]
    return nodes, pods


def hostname_spread_workload():
    """tests/test_parallel.py:150: 200 self-spreading pods on 96 nodes."""
    nodes = [make_node(f"m{i}", pods="6") for i in range(96)]
    pods = [_spread(make_pod(f"sp-{i}", cpu="50m", memory="64Mi", labels={"app": "sp"}),
                    "sp", HOST, 2) for i in range(200)]
    return nodes, pods


def rounds_workload(seed: int = 5, n_nodes: int = 2560):
    """N = 2,560 nodes, above the default epoch limit of 2,048 (so JAX takes
    its per-round GSPMD form and the port K10's path on a node mesh):
    seeded large nodes and three one-cpu nodes spread over the rank blocks,
    which 500m pods exhaust within the wave, so that their leaving the
    feasible set moves the Simon normalizer and the wave takes several
    rounds; then a second, memory-heavy group."""
    rng = np.random.RandomState(seed)
    small = {n_nodes // 24, n_nodes // 2 + 7, n_nodes - 5}
    nodes = [make_node(f"e{i:05d}", cpu="1", memory="2Gi", pods="110") if i in small else
             make_node(f"e{i:05d}", cpu=str(int(rng.choice([8, 16]))),
                       memory=f"{int(rng.choice([16, 32]))}Gi", pods="110")
             for i in range(n_nodes)]
    pods = [make_pod(f"w-{i}", cpu="500m", memory="512Mi", labels={"app": "w"})
            for i in range(6000)]
    pods += [make_pod(f"m-{i}", cpu="200m", memory="2Gi", labels={"app": "m"})
             for i in range(3000)]
    return nodes, pods


WORKLOADS = {"mixed": mixed_workload, "hard_affinity": hard_affinity_workload,
             "hostname_spread": hostname_spread_workload}


def tail_workload(seed: int = 13, n_nodes: int = 2560):
    """N = 2,560 nodes on four zones, above the default epoch limit (so JAX
    partitions the affinity wave's plain loop with GSPMD and the port takes
    its sharded tail, K11's path, on a node mesh): seeded node sizes, and
    every affinity shape: a zone DoNotSchedule spread, a hostname spread,
    hostname and zone self-anti-affinity, required zone self-affinity (its
    bootstrap) and a Service-backed group (live SelectorSpread over zones).
    Returns (nodes, pods, services)."""
    rng = np.random.RandomState(seed)
    nodes = [make_node(f"t{i:05d}", cpu=str(int(rng.choice([8, 16]))),
                       memory=f"{int(rng.choice([16, 32]))}Gi", pods="110",
                       labels={ZONE: f"z{i % 4}"}) for i in range(n_nodes)]
    pods = [_spread(make_pod(f"z-{i}", cpu="200m", memory="128Mi", labels={"app": "z"}),
                    "z", ZONE, 2) for i in range(60)]
    pods += [_spread(make_pod(f"hs-{i}", cpu="100m", memory="64Mi", labels={"app": "hs"}),
                     "hs", HOST, 1) for i in range(80)]
    pods += [_required(make_pod(f"ah-{i}", cpu="100m", memory="64Mi", labels={"app": "ah"}),
                       "podAntiAffinity", "ah", HOST) for i in range(30)]
    pods += [_required(make_pod(f"az-{i}", cpu="100m", memory="64Mi", labels={"app": "az"}),
                       "podAntiAffinity", "az", ZONE) for i in range(6)]
    pods += [_required(make_pod(f"af-{i}", cpu="100m", memory="64Mi", labels={"app": "af"}),
                       "podAffinity", "af", ZONE) for i in range(40)]
    pods += [_required(make_pod(f"sv-{i}", cpu="150m", memory="128Mi", labels={"app": "svc"}),
                       "podAffinity", "svc", ZONE) for i in range(12)]
    return nodes, pods, _services("svc")


def _services(*apps) -> list:
    return [{"apiVersion": "v1", "kind": "Service",
             "metadata": {"name": app, "namespace": "default"},
             "spec": {"selector": {"app": app}}} for app in apps]


def seeded_workload(seed: int = 7, n_nodes: int = 64, cordon_from: int = 32):
    """Seeded node sizes on four zones, nodes from `cordon_from` on cordoned
    (every node of the upper shards' blocks infeasible), and pods of every
    wave and affinity shape: a plain wave, a cap1 wave (host ports), a zone
    DoNotSchedule spread, hostname and zone self-anti-affinity, required
    zone self-affinity, and a Service-backed group (live SelectorSpread)."""
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n_nodes):
        n = make_node(f"s{i}", cpu=str(int(rng.choice([8, 12, 16, 24]))),
                      memory=f"{int(rng.choice([16, 24, 32, 48]))}Gi", pods="40",
                      labels={ZONE: f"z{i % 4}"}, unschedulable=i >= cordon_from)
        nodes.append(n)
    pods = [make_pod(f"w-{i}", cpu="250m", memory="256Mi", labels={"app": "w"})
            for i in range(300)]
    pods += [make_pod(f"p-{i}", cpu="100m", memory="64Mi", labels={"app": "p"},
                      host_ports=[8080]) for i in range(40)]
    pods += [_spread(make_pod(f"z-{i}", cpu="200m", memory="128Mi", labels={"app": "z"}),
                     "z", ZONE, 2) for i in range(60)]
    pods += [_required(make_pod(f"ah-{i}", cpu="100m", memory="64Mi", labels={"app": "ah"}),
                       "podAntiAffinity", "ah", HOST) for i in range(40)]
    pods += [_required(make_pod(f"az-{i}", cpu="100m", memory="64Mi", labels={"app": "az"}),
                       "podAntiAffinity", "az", ZONE) for i in range(8)]
    pods += [_required(make_pod(f"af-{i}", cpu="100m", memory="64Mi", labels={"app": "af"}),
                       "podAffinity", "af", ZONE) for i in range(50)]
    pods += [_required(make_pod(f"sv-{i}", cpu="150m", memory="128Mi", labels={"app": "svc"}),
                       "podAffinity", "svc", ZONE) for i in range(40)]
    return nodes, pods, _services("svc")


def placements(sim, failed) -> dict:
    """{pod name: node name} of every placed pod, and the failed names."""
    out = {}
    for i, nps in enumerate(sim.pods_on_node):
        for p in nps:
            out[p["metadata"]["name"]] = sim.na.names[i]
    return {"placed": out, "failed": sorted(u.pod["metadata"]["name"] for u in failed)}


def run_engine(nodes, pods, services=(), mesh=None, device="cpu") -> dict:
    """The port's Simulator on `mesh` (None: unsharded): placements, the
    segment kinds, WAVE_STATS / AFFINITY_STATS and the mesh's counters."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    K.reset_launch_counts()
    sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=mesh is not None)
    sim.register_cluster_objects(ResourceTypes(services=list(services)))
    taps = {"dispatch": [], "explains": 0, "fetches": 0}
    if mesh is not None:
        assert sim._resolve_mesh().shards == mesh.shards
        sim._mesh = mesh  # read the collective counters of this rank's mesh
        mesh.reset_counts()
        fetch, explain = sim._fetch_results, sim._explain_reasons

        def tapped_fetch(outs):  # the dispatches' collectives, before the fetch's
            taps["dispatch"].append(copy.deepcopy(mesh.counts))
            taps["fetches"] += any(seg[0] != "serial" for seg, _, _ in outs)
            return fetch(outs)

        def tapped_explain(*args):
            taps["explains"] += 1
            return explain(*args)

        sim._fetch_results, sim._explain_reasons = tapped_fetch, tapped_explain
    failed = sim.schedule_pods(copy.deepcopy(pods))
    out = placements(sim, failed)
    out.update(census={k: list(v) for k, v in sim.segment_census.items()},
               wave=K.wave_stats(), affinity=K.affinity_stats(),
               launches={k: v for k, v in K.launch_counts().items() if "sharded" in k},
               shards=sim._mesh.shards if sim._mesh is not None else 1,
               counts=copy.deepcopy(mesh.counts) if mesh is not None else None,
               branches=dict(mesh.tail_branches) if mesh is not None else None,
               fetches=taps["fetches"], explains=taps["explains"],
               # the calls before the last run's fetch (one run: its dispatches')
               dispatch_calls=({k: v["calls"] for k, v in taps["dispatch"][-1].items()}
                               if taps["dispatch"] else None))
    return out


def route_calls(rec: dict, sa_pods: int = 0) -> dict:
    """The collective calls every segment of an engine run (`run_engine` on
    a mesh) makes besides its route's epochs or rounds: two all_gather_rows
    per serial and group-serial pod (K12, K13), a pmax per such pod whose
    group has ScheduleAnyway terms (`sa_pods`), one all_gather_rows per
    commit of a counted segment (K14)."""
    census = rec["census"]
    counted = sum(v[0] for k, v in census.items() if k != "serial")
    scanned = sum(census.get(k, [0, 0])[1] for k in ("serial", "spread"))
    return {"pmax": sa_pods, "all_gather_tiled": 0, "all_gather_rows": 2 * scanned + counted}


def fetch_calls(rec: dict) -> dict:
    """The calls of an engine run besides its dispatches': one
    all_gather_tiled per run that has a counted segment (the block counts'
    fetch) and one per failure diagnosis (K1 on the block, gathered)."""
    return {"pmax": 0, "all_gather_tiled": rec["fetches"] + rec["explains"],
            "all_gather_rows": 0}


def on_mesh(tb, cry, mesh) -> tuple:
    """(tables, carry) as a kernel on `mesh` takes them: this rank's block
    of the partitioned layout, or the whole tables without a mesh."""
    if mesh is None:
        return tb, cry
    from open_simulator_torch.parallel.mesh import block_of

    return block_of(tb, cry, mesh)


def kernel_segments(mesh, device="cpu", seed: int = 7, cordon_from: int = 32) -> list:
    """Every wave and affinity segment of the seeded workload, chained from
    the seed carry by the unsharded path: the plain sharded and unsharded
    kernels from the same carry, side by side (counts, placed, statistics,
    collective calls)."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    nodes, pods, services = seeded_workload(seed, cordon_from=cordon_from)
    sim = Simulator(nodes, device=device, use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt = sim.encode_batch(pods)
    tb, cry = sim._to_device(bt)
    N = int(tb.alloc.shape[0])
    out = []
    for seg in sim._segments(bt, len(pods)):
        kind, _, m, g, cap1 = seg[:5]
        if kind not in ("wave", "affinity"):
            continue
        block = K.wave_block_for(m, sim.na.N)
        runs = []
        for msh in (None, mesh):
            if msh is not None:
                msh.reset_counts()
            tbm, crym = on_mesh(tb, cry, msh)
            if kind == "wave":
                kmax = K.wave_kmax(m, sim.na.N, block)
                j, placed, st = K.schedule_wave_plain(tbm, crym, g, m, bool(cap1), block=block,
                                                      kmax=kmax, gpu_live=bool(seg[5]), mesh=msh)
            else:
                nz = bt.n_zones if seg[5] else 2
                j, placed, st = K.schedule_affinity_wave_plain(
                    tbm, crym, g, m, bool(cap1), ss_live=bool(seg[5]), block=block, n_zones=nz,
                    mesh=msh)
            runs.append({"j": j.tolist(), "placed": int(placed), "stats": dict(st),
                         "counts": copy.deepcopy(msh.counts) if msh is not None else None})
        # every block of the upper shards is cordoned: their partials are all -inf
        runs[0]["kind"] = kind
        runs[0]["ss_live"] = bool(seg[5]) if kind == "affinity" else False
        out.append(runs)
        cry = K.aggregate_commit(tb, cry, g, torch.tensor(runs[0]["j"], dtype=torch.int32),
                                 bool(seg[5]) if kind == "wave" else False)
    out.append({"N": N})
    return out


def round_calls(rounds: int) -> dict:
    """The per-round path's collective calls for `rounds` rounds: two pmax
    (the normalizers, then those without the exhausted nodes) and two
    all_gather_rows (the block summaries, then the candidates)."""
    return {"pmax": 2 * rounds, "all_gather_tiled": 0, "all_gather_rows": 2 * rounds}


def tail_calls(branches: dict) -> dict:
    """The affinity wave's sharded tail's collective calls for its epochs by
    branch: all_gather_rows #1 (the block's reductions) and #2 (the block
    summaries) in every epoch, #3 (the block tops) after use_multi_pre
    ("select", "sandwich"), and pmax #4 after rounds that took pods
    ("sandwich"); the rounds themselves make none."""
    head, sel, sand = (branches.get(k, 0) for k in ("head", "select", "sandwich"))
    return {"pmax": sand, "all_gather_tiled": 0, "all_gather_rows": 2 * head + 3 * (sel + sand)}


def tail_epochs(branches: dict) -> int:
    """The sharded tail's epochs, each counted in one collective branch."""
    return sum(branches.get(k, 0) for k in ("head", "select", "sandwich"))


def tail_verdicts(branches) -> dict:
    """The counts of `NodeMesh.tail_branches` that K11 keeps as its plain
    version does: the epochs by branch and the sandwich's rejections."""
    return {k: v for k, v in branches.items() if k in ("head", "select", "sandwich", "rejected")}


def summed_calls(*calls) -> dict:
    """The element-wise sum of collective-call dicts."""
    out = Counter()
    for c in calls:
        out.update(c)
    return {k: out[k] for k in ("pmax", "all_gather_tiled", "all_gather_rows")}


LIMIT = "OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES"


class epoch_limit:
    """OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES set to `value` inside the
    block, restored after it."""

    def __init__(self, value) -> None:
        self.value = str(value)

    def __enter__(self):
        self.prev = os.environ.get(LIMIT)
        os.environ[LIMIT] = self.value

    def __exit__(self, *exc) -> None:
        if self.prev is None:
            del os.environ[LIMIT]
        else:
            os.environ[LIMIT] = self.prev


def rising_workload(seed: int = 3, n_nodes: int = 32, cordon_from: int = 24):
    """Seeded node sizes, a cpu hog bound on every third node and memory-heavy
    replicas: on a hogged node each copy evens the node out, so its score
    column rises (the guard defers entries, and the head fallback takes the
    rounds where it defers them all). Nodes from `cordon_from` on are
    cordoned. Returns (nodes, bound pods, pods)."""
    rng = np.random.RandomState(seed)
    nodes = [make_node(f"r{i}", cpu=str(int(rng.choice([4, 8]))),
                       memory=f"{int(rng.choice([8, 16]))}Gi", pods="40",
                       unschedulable=i >= cordon_from) for i in range(n_nodes)]
    bound = [make_pod(f"hog{i}", cpu="2500m", memory="100Mi", node_name=f"r{i}")
             for i in range(0, n_nodes, 3)]
    pods = [make_pod(f"mem-{i}", cpu="100m", memory="1Gi", labels={"app": "mem"})
            for i in range(90)]
    pods += [make_pod(f"cpu-{i}", cpu="700m", memory="128Mi", labels={"app": "cpu"})
             for i in range(60)]
    return nodes, bound, pods


def _ties_across_cut(tb, cry, g: int, shards: int, K) -> bool:
    """Whether two feasible nodes of different rank blocks have the same
    first-copy score in the segment's first table (a tie the merge breaks
    on the global flat index)."""
    import torch

    N = int(tb.alloc.shape[0])
    feas, _ = K.feasibility(tb, cry, g, -1, True)
    st = K._wave_statics(tb, cry, g)
    table = K._wave_score_table(tb, cry, st, K._wave_norms(st, feas), g,
                                torch.zeros(N, dtype=torch.int32), block=1)[:, 0]
    seen = {}
    NL = N // shards
    for n in torch.nonzero(feas).flatten().tolist():
        seen.setdefault(float(table[n]), set()).add(n // NL)
    return any(len(b) > 1 for b in seen.values())


def _round_wave_segments(device: str):
    """Every wave segment of the three seeded clusters of `round_segments`,
    chained from the seed carry by the unsharded path: yields (cluster
    label, tables, carry, m, g, cap1, gpu_live, variants), each variant a
    (FilterFlags, block, kmax) to run the segment with."""
    import torch  # noqa: F401  (the plain versions need it loaded)

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_extended_cluster

    nodes, pods, services = seeded_workload()
    ext_nodes, ext_pods, _, scs = synth_extended_cluster(32, 300)
    r_nodes, r_bound, r_pods = rising_workload()
    clusters = (("seeded", nodes, [], pods, services, []),
                ("rising", r_nodes, r_bound, r_pods, [], []),
                ("extended", ext_nodes, [], ext_pods, [], scs))
    for label, nodes, bound, pods, services, scs in clusters:
        sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services),
                                                   storage_classes=list(scs)))
        sim.schedule_pods(copy.deepcopy(bound))
        bt = sim.encode_batch(copy.deepcopy(pods))
        tb, cry = sim._to_device(bt)
        for seg in sim._segments(bt, len(pods)):
            if seg[0] != "wave":
                continue
            _, _, m, g, cap1 = seg[:5]
            gpu_live = bool(seg[5])
            base = K.wave_block_for(m, sim.na.N)
            variants = [(K.DEFAULT_FILTERS, base, K.wave_kmax(m, sim.na.N, base))]
            if label != "extended":
                variants += [(K.DEFAULT_FILTERS, 8, 16), (K.FilterFlags(fit=False), base, 0),
                             (K.FilterFlags(fit=False), 8, 16)]
            yield label, tb, cry, m, g, bool(cap1), gpu_live, variants
            j = K.schedule_wave_plain(tb, cry, g, m, bool(cap1), block=base,
                                      kmax=variants[0][2], gpu_live=gpu_live)[0]
            cry = K.aggregate_commit(tb, cry, g, j, gpu_live)


def round_segments(mesh, device="cpu", limit: int = 16) -> list:
    """The wave's per-round path (the epoch limit lowered to `limit`): on
    every wave segment of three seeded clusters, chained from the seed
    carry by the unsharded path, the plain per-round sharded version
    against the unsharded one from the same carry, with the default depth
    and kmax and with (block 8, kmax 16), and NodeResourcesFit on and off.
    The clusters: `seeded_workload` (the upper half cordoned: whole blocks
    infeasible), `rising_workload` (the guard, head fallbacks) and
    synth_extended_cluster(32, 300) (gpu_live, default variant only). One
    record per run."""
    from open_simulator_torch.ops import kernels as K

    out = []
    with epoch_limit(limit):
        for label, tb, cry, m, g, cap1, gpu_live, variants in _round_wave_segments(device):
            for filters, block, kmax in variants:
                runs = []
                for msh in (None, mesh):
                    if msh is not None:
                        msh.reset_counts()
                    tbm, crym = on_mesh(tb, cry, msh)
                    j, placed, st = K.schedule_wave_plain(tbm, crym, g, m, cap1, filters=filters,
                                                          block=block, kmax=kmax,
                                                          gpu_live=gpu_live, mesh=msh)
                    runs.append((j.tolist(), int(placed), dict(st)))
                out.append({"cluster": label, "N": int(tb.alloc.shape[0]), "m": m, "kmax": kmax,
                            "gpu_live": gpu_live, "fit": filters.fit,
                            "same": runs[0] == runs[1], "stats": runs[0][2],
                            "placed": runs[0][1],
                            "calls": {k: v["calls"] for k, v in mesh.counts.items()},
                            "ties": _ties_across_cut(tb, cry, g, mesh.shards, K)})
    return out


def sched_weights_and_flags():
    """(ScoreWeights, FilterFlags) of the KubeSchedulerConfiguration in
    tests/golden/torch_port_sched_hard_waves.sched.yaml."""
    from open_simulator_torch.api.schedconfig import KERNEL_FILTERS, parse_scheduler_config
    from open_simulator_torch.ops import kernels as K

    sc = parse_scheduler_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             "golden", "torch_port_sched_hard_waves.sched.yaml"))
    return (K.ScoreWeights(**sc.weight_kwargs()),
            K.FilterFlags(**{f: n not in sc.disabled_kernel_filters
                             for n, f in KERNEL_FILTERS.items()}))


def card_round_kernels(mesh, limit: int = 16) -> list:
    """On the card: K10 against its plain per-round version (on the card, on
    the same ranks) and against the unsharded K3, on every run of
    `round_segments` (the epoch limit lowered to `limit`), and once more on
    the first seeded segment under a custom scheduler configuration's
    weights and flags (`sched_weights_and_flags`). One record per run, with
    the rounds' collective calls of K10's run."""
    import torch

    from open_simulator_torch.ops import kernels as K

    out = []
    sched = sched_weights_and_flags()
    with epoch_limit(limit):
        for label, tb, cry, m, g, cap1, gpu_live, variants in _round_wave_segments("cuda"):
            runs = [(K.DEFAULT_WEIGHTS, *v) for v in variants]
            if label == "seeded" and not any(r.get("sched") for r in out):
                # one run under a custom scheduler configuration
                runs.append((sched[0], sched[1], variants[0][1], variants[0][2]))
            for w, filters, block, kmax in runs:
                kw = dict(w=w, filters=filters, block=block, kmax=kmax, gpu_live=gpu_live)
                mesh.reset_counts()
                tbl, cryl = on_mesh(tb, cry, mesh)
                kj, kp, kst = K.schedule_wave_rounds_kernel(tbl, cryl, g, m, cap1, mesh=mesh,
                                                            **kw)
                calls = {k: v["calls"] for k, v in mesh.counts.items()}
                pj, pp, pst = K.schedule_wave_plain(tbl, cryl, g, m, cap1, mesh=mesh, **kw)
                uj, up, ust = K.schedule_wave_kernel(tb, cry, g, m, cap1, **kw)
                out.append({"cluster": label, "m": m, "kmax": kmax, "stats": kst.tolist(),
                            "calls": calls, "sched": w != K.DEFAULT_WEIGHTS,
                            "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp
                            and kst.tolist() == [pst[k] for k in K.WAVE_STATS],
                            "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                            and kst.tolist() == ust.tolist()})
    return out


# the blocks of K10's and K11's card cases over every cluster size: NL nodes
# a rank and the C that ops/cluster.py `choose` gives them (one node a thread)
ROUND_BLOCKS = ((1_024, 2), (2_048, 4), (4_096, 8), (8_192, 16))


def card_cluster_sizes(mesh) -> list:
    """On the card, at blocks that take every cluster size (ROUND_BLOCKS,
    above the epoch limit): K10 on the two largest wave segments of
    synth_cluster's hard shape and K11 on every affinity segment of
    `tail_workload`, each against its plain version on the same ranks and
    the unsharded K3 / K5, with the shape of its stages. One record per
    segment."""
    out = []
    with epoch_limit(16):
        for NL, C in ROUND_BLOCKS:
            out += _cluster_size_cases(mesh, NL, C)
    return out


def _cluster_size_cases(mesh, NL: int, C: int) -> list:
    """`card_cluster_sizes` at one block size."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster

    out = []
    N = NL * mesh.shards
    nodes, pods = synth_cluster(N, 2 * N, hard_predicates=True)
    sim = Simulator(nodes, device="cuda", use_mesh=False)
    bt = sim.encode_batch(pods)
    tb, cry = sim._to_device(bt)
    assert tb.alloc.shape[0] == N
    waves = sorted((s for s in sim._segments(bt, len(pods)) if s[0] == "wave"),
                   key=lambda s: s[2])[-2:]  # the two largest
    for seg in waves:
        _, _, m, g, cap1, gpu_live = seg[:6]
        block = K.wave_block_for(m, N)
        kw = dict(block=block, kmax=K.wave_kmax(m, N, block), gpu_live=bool(gpu_live))
        tbl, cryl = on_mesh(tb, cry, mesh)
        kj, kp, kst = K.schedule_wave_rounds_kernel(tbl, cryl, g, m, cap1, mesh=mesh, **kw)
        shape = K.schedule_wave_rounds_kernel.last_shape
        pj, pp, pst = K.schedule_wave_plain(tbl, cryl, g, m, cap1, mesh=mesh, **kw)
        uj, up, ust = K.schedule_wave_kernel(tb, cry, g, m, cap1, **kw)
        out.append({"kernel": "K10", "NL": NL, "C": shape.C, "want_C": C, "m": m,
                    "stats": kst.tolist(),
                    "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp
                    and kst.tolist() == [pst[k] for k in K.WAVE_STATS],
                    "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                    and kst.tolist() == ust.tolist()})
    nodes, pods, services = tail_workload(n_nodes=N)
    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=list(services)))
    bt = sim.encode_batch(pods)
    tb, cry = sim._to_device(bt)
    for seg in sim._segments(bt, len(pods)):
        if seg[0] != "affinity":
            continue
        _, _, m, g, cap1, ss_live = seg[:6]
        kw = dict(ss_live=bool(ss_live), block=K.wave_block_for(m, N),
                  n_zones=bt.n_zones if ss_live else 2)
        tbl, cryl = on_mesh(tb, cry, mesh)
        mesh.reset_counts()
        kj, kp, kst = K.schedule_affinity_wave_rounds_kernel(tbl, cryl, g, m, bool(cap1),
                                                             mesh=mesh, **kw)
        shape = K.schedule_affinity_wave_rounds_kernel.last_shape
        branches = tail_verdicts(mesh.tail_branches)
        mesh.reset_counts()
        pj, pp, pst = K.schedule_affinity_wave_plain(tbl, cryl, g, m, bool(cap1), mesh=mesh,
                                                     **kw)
        uj, up, ust = K.schedule_affinity_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
        out.append({"kernel": "K11", "NL": NL, "C": shape.C, "want_C": C, "m": m,
                    "stats": kst.tolist(), "branches": branches,
                    "same_branches": branches == tail_verdicts(mesh.tail_branches),
                    "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp
                    and kst.tolist() == [pst[k] for k in K.AFFINITY_STATS],
                    "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                    and kst.tolist() == ust.tolist()})
        cry = K.aggregate_commit(tb, cry, g, uj)
    return out


def unbucketed(sim, pods, shards: int):
    """`sim.encode_batch(pods)` with the node axis padded only to a multiple
    of `shards`, not to the encoder's bucket, so that a rank's block keeps
    a node count that is no multiple of a cluster size."""
    from open_simulator_torch.simulator.encode import pad_batch_tables, pad_encoder_axes

    return pad_batch_tables(pad_encoder_axes(sim.encode_batch_raw(pods)), shards)


# the blocks of K9's card cases over every cluster size: NL nodes a rank
# (not a multiple of the cluster size), the C that ops/cluster.py `choose`
# gives its block stages and the C of its tail over N = 2 * NL
K9_BLOCKS = ((511, 1, 2), (1_001, 2, 4), (2_047, 4, 8), (4_095, 8, 16), (8_191, 16, 16))


def card_k9_cluster_sizes(mesh) -> list:
    """On the card, at blocks whose stages take every cluster size
    (K9_BLOCKS, the epoch limit at N so that the epoch path applies): K9 on
    every affinity segment of `tail_workload` (a zone DoNotSchedule spread,
    a hostname spread, anti-affinity, required self-affinity and its
    bootstrap's head fallbacks, live SelectorSpread over the zones),
    against its plain sharded version on the same ranks and the unsharded
    K5, bit for bit, with the shapes of its block stages and its tail. One
    record per segment."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    out = []
    for NL, want_b, want_t in K9_BLOCKS:
        N = NL * mesh.shards
        nodes, pods, services = tail_workload(n_nodes=N)
        sim = Simulator(nodes, device="cuda", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services)))
        bt = unbucketed(sim, pods, mesh.shards)
        tb, cry = sim._to_device(bt)
        assert tb.alloc.shape[0] == N
        with epoch_limit(N):
            for seg in sim._segments(bt, len(pods)):
                if seg[0] != "affinity":
                    continue
                _, _, m, g, cap1, ss_live = seg[:6]
                kw = dict(ss_live=bool(ss_live), block=K.wave_block_for(m, N),
                          n_zones=bt.n_zones if ss_live else 2)
                tbl, cryl = on_mesh(tb, cry, mesh)
                mesh.reset_counts()
                kj, kp, kst = K.schedule_affinity_wave_sharded_kernel(tbl, cryl, g, m, bool(cap1),
                                                                      mesh=mesh, **kw)
                shape = K.schedule_affinity_wave_sharded_kernel.last_shape
                calls = _calls(mesh)
                pj, pp, pst = K.schedule_affinity_wave_plain(tbl, cryl, g, m, bool(cap1),
                                                             mesh=mesh, **kw)
                uj, up, ust = K.schedule_affinity_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
                out.append({"NL": NL, "C": (shape["block"].C, shape["tail"].C),
                            "want_C": (want_b, want_t), "m": m, "ss_live": bool(ss_live),
                            "stats": kst.tolist(), "calls": calls,
                            "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp
                            and kst.tolist() == [pst[k] for k in K.AFFINITY_STATS],
                            "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                            and kst.tolist() == ust.tolist()})
                cry = K.aggregate_commit(tb, cry, g, uj)
    return out


def overcommit_nodes():
    """tests/test_torch_affinity.py `anti_unlabeled_overcommit`: six zoned
    nodes and the unlabeled node u0 with two pod slots."""
    nodes = [make_node(f"n{i}", cpu="8", labels={ZONE: f"z{i % 3}"}) for i in range(6)]
    return nodes + [make_node("u0", cpu="8", pods="2")]


def overcommit_pods():
    """20 pods of zone self-anti-affinity: u0 sits in the sentinel domain,
    which no budget meters, so the affinity wave puts 17 of them there (the
    JAX result, ROADMAP §C3)."""
    return [_required(make_pod(f"ao-{i}", cpu="400m", memory="128Mi", labels={"app": "ao"}),
                      "podAntiAffinity", "ao", ZONE) for i in range(20)]


def levels_workload(n_nodes: int = 64):
    """A zone DoNotSchedule spread (maxSkew 1) over four zones whose first
    zone already holds nine of its pods: the other zones catch up by several
    levels in one multi-level round (JAX round_body's `use_full` take), then
    single rises. Returns (nodes, bound pods, pods)."""
    nodes = [make_node(f"v{i}", cpu="16", memory="32Gi", labels={ZONE: f"z{i % 4}"})
             for i in range(n_nodes)]
    bound = [make_pod(f"seed-{i}", cpu="100m", memory="64Mi", labels={"app": "lv"},
                      node_name=f"v{4 * (i % 3)}") for i in range(9)]
    pods = [_spread(make_pod(f"lv-{i}", cpu="100m", memory="64Mi", labels={"app": "lv"}),
                    "lv", ZONE, 1) for i in range(120)]
    return nodes, bound, pods


def _tail_segments(device: str):
    """Every affinity segment of the sharded tail's seeded clusters, chained
    from the seed carry by the unsharded path: yields (cluster label, the
    epoch limit to run under, tables, carry, segment, block, n_zones). The
    clusters: `seeded_workload` (the upper half cordoned: whole blocks
    infeasible), the same uncordoned (zone sums from several blocks),
    `hostname_spread_workload` (hostname domains, equal scores across the
    cuts), `levels_workload` (a multi-level round) and the overcommit case
    (N 8 with the phantom node, limit 4)."""
    import torch  # noqa: F401  (the plain versions need it loaded)

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    nodes, pods, services = seeded_workload()
    h_nodes, h_pods = hostname_spread_workload()
    clusters = (("seeded", 16, nodes, [], pods, services),
                ("open", 16, seeded_workload(cordon_from=64)[0], [], pods, services),
                ("hostname", 16, h_nodes, [], h_pods, []),
                ("levels", 16, *levels_workload(), []),
                ("overcommit", 4, overcommit_nodes(), [], overcommit_pods(), []))
    for label, limit, nodes, bound, pods, services in clusters:
        sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services)))
        sim.schedule_pods(copy.deepcopy(bound))
        bt = sim.encode_batch(copy.deepcopy(pods))
        tb, cry = sim._to_device(bt)
        for seg in sim._segments(bt, len(pods)):
            kind, _, m, g, cap1 = seg[:5]
            if kind == "wave":
                j = K.schedule_wave_plain(tb, cry, g, m, bool(cap1),
                                          block=K.wave_block_for(m, sim.na.N),
                                          kmax=K.wave_kmax(m, sim.na.N,
                                                           K.wave_block_for(m, sim.na.N)),
                                          gpu_live=bool(seg[5]))[0]
                cry = K.aggregate_commit(tb, cry, g, j, bool(seg[5]))
            if kind != "affinity":
                continue
            block = K.wave_block_for(m, sim.na.N)
            n_zones = bt.n_zones if seg[5] else 2
            yield label, limit, tb, cry, seg, block, n_zones
            j = K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1), ss_live=bool(seg[5]),
                                               block=block, n_zones=n_zones)[0]
            cry = K.aggregate_commit(tb, cry, g, j)


def _bootstrap(tb, cry, g: int) -> bool:
    """Whether group g's first epoch is a bootstrap: required self-affinity
    with no matching pod placed yet."""
    ids = tb.req_aff_t[g]
    ids = ids[ids >= 0].long()
    return bool(tb.grp_aff_self[g]) and len(ids) > 0 and float(cry.counter[ids].sum()) == 0.0


def tail_segments(mesh, device="cpu") -> list:
    """The affinity wave's sharded tail (the epoch limit lowered): on every
    affinity segment of `_tail_segments`' clusters, the plain sharded-tail
    version against the unsharded plain version from the same carry, with
    the collective calls and `mesh.tail_branches`. One record per segment."""
    from open_simulator_torch.ops import kernels as K

    out = []
    for label, limit, tb, cry, seg, block, n_zones in _tail_segments(device):
        _, _, m, g, cap1, ss_live = seg[:6]
        runs = []
        with epoch_limit(limit):
            for msh in (None, mesh):
                mesh.reset_counts()
                tbm, crym = on_mesh(tb, cry, msh)
                j, placed, st = K.schedule_affinity_wave_plain(
                    tbm, crym, g, m, bool(cap1), ss_live=bool(ss_live), block=block,
                    n_zones=n_zones, mesh=msh)
                runs.append((j.tolist(), int(placed), dict(st)))
        N = int(tb.alloc.shape[0])
        NL = N // mesh.shards
        feas = K.feasibility(tb, cry, g, -1, True)[0]
        out.append({"cluster": label, "N": N, "m": m, "ss_live": bool(ss_live),
                    "zones": int(tb.node_zone.max()) + 1, "same": runs[0] == runs[1],
                    "stats": runs[0][2], "placed": runs[0][1],
                    "calls": {k: v["calls"] for k, v in mesh.counts.items()},
                    "branches": dict(mesh.tail_branches), "bootstrap": _bootstrap(tb, cry, g),
                    "ties": _ties_across_cut(tb, cry, g, mesh.shards, K),
                    "blocks_feasible": len({n // NL for n in feas.nonzero().flatten().tolist()}),
                    "on_last_real": runs[1][0][6] if label == "overcommit" else None})
    return out


def card_tail_kernels(mesh) -> list:
    """On the card: K11 against its plain sharded-tail version (on the card,
    on the same ranks) and against the unsharded K5, on every segment of
    `_tail_segments` (each under its lowered epoch limit). One record per
    segment, with K11's collective calls and branches."""
    import torch

    from open_simulator_torch.ops import kernels as K

    out = []
    for label, limit, tb, cry, seg, block, n_zones in _tail_segments("cuda"):
        _, _, m, g, cap1, ss_live = seg[:6]
        kw = dict(ss_live=bool(ss_live), block=block, n_zones=n_zones)
        with epoch_limit(limit):
            mesh.reset_counts()
            tbl, cryl = on_mesh(tb, cry, mesh)
            kj, kp, kst = K.schedule_affinity_wave_rounds_kernel(tbl, cryl, g, m, bool(cap1),
                                                                 mesh=mesh, **kw)
            calls = {k: v["calls"] for k, v in mesh.counts.items()}
            branches = tail_verdicts(mesh.tail_branches)
            mesh.reset_counts()
            pj, pp, pst = K.schedule_affinity_wave_plain(tbl, cryl, g, m, bool(cap1), mesh=mesh,
                                                         **kw)
            plain_branches = tail_verdicts(mesh.tail_branches)
        uj, up, ust = K.schedule_affinity_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
        out.append({"cluster": label, "m": m, "stats": kst.tolist(), "calls": calls,
                    "branches": branches, "same_branches": branches == plain_branches,
                    "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp
                    and kst.tolist() == [pst[k] for k in K.AFFINITY_STATS],
                    "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                    and kst.tolist() == ust.tolist()})
    return out


def route_rules(mesh, device="cpu") -> dict:
    """The epoch path's limits: an N that the shard count does not divide
    is padded with phantom nodes when the layout is staged
    (`to_device_sharded`) and places the same pods with the epoch path's
    collectives, and at an N above OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES
    the wave segments take the per-round path (two pmax and two
    all_gather_rows per round) and the affinity segments the sharded tail
    (two to four collectives per epoch); both place the same pods."""
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import to_device_sharded
    from open_simulator_torch.simulator.encode import pad_encoder_axes
    from open_simulator_torch.simulator.engine import Simulator

    out = {}
    nodes, pods = hostname_spread_workload()
    nodes = nodes[:mesh.shards * 13 + 1]  # N = 13 * shards + 1: no shard count divides it
    sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=False)
    bt = pad_encoder_axes(sim.encode_batch_raw(pods))
    tb, cry = sim._to_device(bt)
    N = int(tb.alloc.shape[0])
    (kind, _, m, g, cap1, ss) = sim._segments(bt, len(pods))[0]
    block = K.wave_block_for(m, N)
    res = []
    for msh in (None, mesh):
        if msh is not None:
            msh.reset_counts()
            tb, cry, _ = to_device_sharded(bt, msh)
        j, placed, st = K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1), ss_live=ss,
                                                       block=block, mesh=msh)
        res.append((j.tolist()[:N], placed, st))
    out["indivisible"] = {"N": N, "kind": kind, "same": res[0] == res[1],
                          "padded": int(tb.alloc.shape[0]) * mesh.shards,
                          "epochs": res[1][2]["epochs"],
                          "calls": {k: v["calls"] for k, v in mesh.counts.items()}}
    # above the limit: the engine's own run at N 32 with the limit at 16
    with epoch_limit(16):
        nodes, pods = mixed_workload()
        out["above_limit"] = run_engine(nodes, pods, mesh=mesh, device=device)
    return out


def rank_cases(mesh, device="cpu") -> dict:
    """Every case of test_torch_mesh.py on this rank's mesh."""
    out = {"rank": mesh.rank, "shards": mesh.shards, "backend": mesh.backend,
           "transport": mesh.transport}
    for name, make in WORKLOADS.items():
        nodes, pods = make()
        out[name] = run_engine(nodes, pods, mesh=mesh, device=device)
    nodes, pods, services = seeded_workload()
    out["seeded"] = run_engine(nodes, pods, services, mesh=mesh, device=device)
    out["kernels"] = kernel_segments(mesh, device)
    out["rounds"] = run_engine(*rounds_workload(), mesh=mesh, device=device)
    out["round_kernels"] = round_segments(mesh, device)
    out["tail_e2e"] = run_engine(*tail_workload(), mesh=mesh, device=device)
    out["tail"] = tail_segments(mesh, device)
    out["rules"] = route_rules(mesh, device)
    return out


def card_kernels(mesh) -> list:
    """On the card: K8 and K9 against their plain sharded versions (on the
    card, on the same ranks) and against the unsharded K3 / K5, on every
    wave and affinity segment of the seeded workload, chained from the seed
    carry. Returns one record per segment."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    nodes, pods, services = seeded_workload()
    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt = sim.encode_batch(pods)
    tb, cry = sim._to_device(bt)
    out = []
    for seg in sim._segments(bt, len(pods)):
        kind, _, m, g, cap1 = seg[:5]
        if kind not in ("wave", "affinity"):
            continue
        block = K.wave_block_for(m, sim.na.N)
        tbl, cryl = on_mesh(tb, cry, mesh)
        if kind == "wave":
            kw = dict(block=block, kmax=K.wave_kmax(m, sim.na.N, block), gpu_live=bool(seg[5]))
            kj, kp, kst = K.schedule_wave_sharded_kernel(tbl, cryl, g, m, bool(cap1), mesh=mesh,
                                                         **kw)
            pj, pp, pst = K.schedule_wave_plain(tbl, cryl, g, m, bool(cap1), mesh=mesh, **kw)
            uj, up, ust = K.schedule_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
            names = K.WAVE_STATS
        else:
            kw = dict(ss_live=bool(seg[5]), block=block, n_zones=bt.n_zones if seg[5] else 2)
            kj, kp, kst = K.schedule_affinity_wave_sharded_kernel(tbl, cryl, g, m, bool(cap1),
                                                                  mesh=mesh, **kw)
            pj, pp, pst = K.schedule_affinity_wave_plain(tbl, cryl, g, m, bool(cap1), mesh=mesh,
                                                         **kw)
            uj, up, ust = K.schedule_affinity_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
            names = K.AFFINITY_STATS
        out.append({"kind": kind, "m": m, "same_plain": bool(torch.equal(kj, pj)) and
                    int(kp) == pp and kst.tolist() == [pst[k] for k in names],
                    "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                    and kst.tolist() == ust.tolist()})
        cry = K.aggregate_commit(tb, cry, g, kj, bool(seg[5]) if kind == "wave" else False)
    return out


# --------------------------------------------------------- partitioned layout ----
#
# The serial route on the partitioned node layout (each rank holds only its
# block of the node axis): tests/test_torch_partitioned.py spawns the ranks
# and holds these records against the JAX package's partitioned runs.

# tests/test_parallel.py's three schedule_batch_on_mesh batches: synth_cluster
# (nodes, pods, hard predicates)
JAX_BATCHES = ((26, 48, True), (16, 32, False), (10, 20, True))


def _anyway(pod, app, topo, skew):
    pod["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": skew, "topologyKey": topo, "whenUnsatisfiable": "ScheduleAnyway",
        "labelSelector": {"matchLabels": {"app": app}}}]
    return pod


def _pinned(pod, node: str):
    """A DaemonSet-style pin (matchFields metadata.name): a forced node."""
    pod["spec"]["affinity"] = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
        "nodeSelectorTerms": [{"matchFields": [
            {"key": "metadata.name", "operator": "In", "values": [node]}]}]}}}
    return pod


def partitioned_workload(seed: int = 11, n_nodes: int = 64, cordon_from: int = 48):
    """Seeded node sizes on three zones (so the zones cut across every rank
    block), nodes from `cordon_from` on cordoned (at four shards the last
    block holds no feasible node), and pods, interleaved, of every shape
    whose reductions cross the ranks: hostname self-anti-affinity that
    overflows (52 pods on 48 nodes), required zone self-affinity (its
    bootstrap), a hostname DoNotSchedule spread, ScheduleAnyway on the
    hostname and the zone key, a Service-backed group (SelectorSpread over
    the zones), host ports, preferred-free plain pods, and pods pinned to a
    node of every block (one to a cordoned node). Returns (nodes, pods,
    services)."""
    rng = np.random.RandomState(seed)
    nodes = [make_node(f"q{i}", cpu=str(int(rng.choice([4, 8, 16]))),
                       memory=f"{int(rng.choice([8, 16, 32]))}Gi", pods="30",
                       labels={ZONE: f"z{i % 3}"}, unschedulable=i >= cordon_from)
             for i in range(n_nodes)]
    shapes = [
        lambda i: _required(make_pod(f"ah-{i}", cpu="100m", memory="64Mi", labels={"app": "ah"}),
                            "podAntiAffinity", "ah", HOST),
        lambda i: _required(make_pod(f"af-{i}", cpu="100m", memory="64Mi", labels={"app": "af"}),
                            "podAffinity", "af", ZONE),
        lambda i: _spread(make_pod(f"hs-{i}", cpu="150m", memory="96Mi", labels={"app": "hs"}),
                          "hs", HOST, 1),
        lambda i: _anyway(make_pod(f"ha-{i}", cpu="200m", memory="128Mi", labels={"app": "ha"}),
                          "ha", HOST, 1),
        lambda i: _anyway(make_pod(f"za-{i}", cpu="250m", memory="256Mi", labels={"app": "za"}),
                          "za", ZONE, 2),
        lambda i: make_pod(f"sv-{i}", cpu="300m", memory="256Mi", labels={"app": "svc"}),
        lambda i: make_pod(f"pt-{i}", cpu="100m", memory="64Mi", labels={"app": "pt"},
                           host_ports=[8080]),
        lambda i: make_pod(f"w-{i}", cpu=str(int(rng.choice([250, 500, 1000]))) + "m",
                           memory="512Mi", labels={"app": "w"}),
    ]
    pods = [shapes[k % len(shapes)](k // len(shapes)) for k in range(52 * len(shapes))]
    stride = n_nodes // 8
    pods += [_pinned(make_pod(f"pin-{b}", cpu="500m", memory="256Mi"), f"q{b * stride + 3}")
             for b in range(8)]
    pods += [_pinned(make_pod("pin-cordoned", cpu="100m", memory="64Mi"), f"q{n_nodes - 1}")]
    return nodes, pods, _services("svc")


def _carry_np(cry) -> dict:
    return {f: t.cpu().numpy() for f, t in cry._asdict().items()}


def _calls(mesh) -> dict:
    return {k: v["calls"] for k, v in mesh.counts.items()}


def partitioned_batches(mesh, device="cpu") -> list:
    """The three batches of tests/test_parallel.py through the port's
    `schedule_batch_on_mesh` on this rank: its choices, its carry block and
    the collective calls."""
    from open_simulator_torch.parallel import schedule_batch_on_mesh
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster

    out = []
    for n, p, hard in JAX_BATCHES:
        nodes, pods = synth_cluster(n, p, hard_predicates=hard)
        bt = Simulator(nodes, device=device, use_mesh=False).encode_batch(pods)
        mesh.reset_counts()
        cry, ch = schedule_batch_on_mesh(bt, mesh)
        out.append({"choices": ch.tolist(), "carry": _carry_np(cry), "calls": _calls(mesh),
                    "valid": int(bt.valid.sum()), "real_nodes": n})
    return out


def partitioned_clusters():
    """(label, nodes, pods, services, storage classes) of the seeded scans."""
    from open_simulator_torch.utils.synth import synth_extended_cluster

    nodes, pods, services = partitioned_workload()
    ext_nodes, ext_pods, _, scs = synth_extended_cluster(32, 160)
    return (("seeded", nodes, pods, services, []), ("extended", ext_nodes, ext_pods, [], scs))


def partitioned_scans(mesh, device="cpu") -> list:
    """On each seeded cluster: the plain sharded scan against the unsharded
    `schedule_batch_plain` from the same seed (choices; the final carry,
    gathered), with its collective calls, its choices and this rank's block
    of its final carry; then, against the unsharded end
    carry and its block, `feasibility_jit` and `explain_jit` on the block
    (gathered) against the unsharded `feasibility` and packed `explain_pod`
    for every group, unforced and forced into every block. Bit for bit."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import carry_shardings, gather_carry, to_device_sharded
    from open_simulator_torch.simulator.encode import pad_batch_tables, plugin_flags
    from open_simulator_torch.simulator.engine import Simulator

    out = []
    for label, nodes, pods, services, scs in partitioned_clusters():
        sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services),
                                                   storage_classes=list(scs)))
        bt = pad_batch_tables(sim.encode_batch(copy.deepcopy(pods)), mesh.shards)
        gpu, storage = plugin_flags(bt)
        flags = dict(enable_gpu=gpu, enable_storage=storage)
        pg, fn, vd = (torch.from_numpy(a) for a in (bt.pod_group, bt.forced_node, bt.valid))
        tb, seed = K.tables_from_batch(bt, device), K.carry_from_batch(bt, device)
        end, ch = K.schedule_batch_plain(tb, seed, pg, fn, vd, bt.n_zones, **flags)
        tbl, seedl, _ = to_device_sharded(bt, mesh)
        mesh.reset_counts()
        endl, chl = K.schedule_batch_sharded_plain(tbl, seedl, pg, fn, vd, bt.n_zones, mesh,
                                                   **flags)
        calls = _calls(mesh)
        full = gather_carry(endl, mesh)
        N, NL = int(tb.alloc.shape[0]), int(tbl.alloc.shape[0])
        P = int(vd.sum())
        sa_pods = sum(K._has_sa(tb, int(g)) for g, v in zip(bt.pod_group, bt.valid) if v)
        # the diagnostics on the block of the unsharded end carry
        endb = K.Carry(*(rule(t).contiguous() for t, rule in zip(end, carry_shardings(mesh, N))))
        groups = sorted({int(g) for g in bt.pod_group[:P]})
        forced = [-1] + [b * NL + NL // 2 for b in range(mesh.shards)]
        diag_same, diag_cases = True, 0
        mesh.reset_counts()
        for g in groups:
            for f in forced:
                fk, sk = K.feasibility_jit(tbl, endb, g, f, True, **flags, mesh=mesh)
                fu, su = K.feasibility(tb, end, g, f, True, **flags)
                diag_same &= torch.equal(fk, fu) and all(torch.equal(sk[k], su[k])
                                                         for k in K.STAGE_KEYS)
                ek = K.explain_jit(tbl, endb, g, f, True, bt.n_zones, **flags, mesh=mesh)
                eu = K.pack_explain(*K.explain_pod(tb, end, g, f, True, bt.n_zones, **flags))
                diag_same &= bool(torch.equal(ek.view(torch.int32), eu.view(torch.int32)))
                diag_cases += 1
        feas_blocks = K.feasibility(tb, seed, int(bt.pod_group[0]), -1, True, **flags)[0]
        out.append({
            "cluster": label, "N": N, "NL": NL, "pods": P, "sa_pods": sa_pods,
            "flags": (gpu, storage), "same_choices": torch.equal(ch, chl),
            "same_carry": all(torch.equal(a, b) for a, b in zip(full, end)),
            "failed": int((ch[:P] < 0).sum()), "calls": calls,
            "choices": chl.tolist(), "carry": _carry_np(endl),
            "forced_blocks": sorted({int(f) // NL for f in bt.forced_node[:P] if f >= 0}),
            "feasible_blocks": sorted({int(n) // NL for n in feas_blocks.nonzero().flatten()}),
            "placed_blocks": sorted({int(c) // NL for c in ch[:P] if c >= 0}),
            "diag_same": bool(diag_same), "diag_cases": diag_cases,
            "diag_calls": _calls(mesh)})
    return out


def partitioned_layout(mesh, device="cpu") -> dict:
    """The layout on this rank: every node-axis leaf holds NL of the N rows
    or columns (this rank's), every other leaf is whole; the bytes each rank
    holds against the unsharded layout's; carry_reshard_bytes after two
    chained dispatches (0) and of a full-width carry (its node-axis leaves'
    bytes)."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import (_CARRY_NODE_AXIS, _TABLE_NODE_AXIS,
                                                    carry_reshard_bytes, carry_shardings,
                                                    to_device_sharded)
    from open_simulator_torch.simulator.encode import pad_batch_tables
    from open_simulator_torch.simulator.engine import Simulator

    nodes, pods, _ = partitioned_workload()
    sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=False)
    bt = pad_batch_tables(sim.encode_batch(copy.deepcopy(pods)), mesh.shards)
    tb, cry, _ = to_device_sharded(bt, mesh)
    full_tb, full_cry = K.tables_from_batch(bt, device), K.carry_from_batch(bt, device)
    N = int(bt.alloc.shape[0])
    NL = N // mesh.shards
    sl = slice(mesh.rank * NL, (mesh.rank + 1) * NL)
    leaves = {}
    for axes, blk, full in ((_TABLE_NODE_AXIS, tb, full_tb), (_CARRY_NODE_AXIS, cry, full_cry)):
        for f, t, u in zip(blk._fields, blk, full):
            ax = axes.get(f)
            want = u if ax is None else (u[sl] if ax == 0 else u[..., sl])
            leaves[f] = {"axis": ax, "shape": list(t.shape), "full": list(u.shape),
                         "same": bool(torch.equal(t, want))}
    P = int(bt.valid.sum())
    half = P // 2
    args = [torch.from_numpy(a) for a in (bt.pod_group, bt.forced_node, bt.valid)]
    first = [a.clone() for a in args]
    first[2][half:] = False
    second = [a.clone() for a in args]
    second[2][:half] = False
    c1, _ = K.schedule_batch(tb, cry, *first, n_zones=bt.n_zones, mesh=mesh)
    c2, _ = K.schedule_batch(tb, c1, *second, n_zones=bt.n_zones, mesh=mesh)
    decl = carry_shardings(mesh, N)
    node_bytes = sum(t.numel() * t.element_size() for f, t in full_cry._asdict().items()
                     if f in _CARRY_NODE_AXIS)
    return {"N": N, "NL": NL, "leaves": leaves,
            "reshard_chained": carry_reshard_bytes(c2, decl),
            "reshard_full": carry_reshard_bytes(full_cry, decl), "node_carry_bytes": node_bytes,
            "bytes_block": sum(t.numel() * t.element_size() for t in (*tb, *cry)),
            "bytes_full": sum(t.numel() * t.element_size() for t in (*full_tb, *full_cry))}


def phantom_pods(first: int):
    """tests/test_mesh_sharding.py's two-batch phantom test: 80 one-cpu pods
    from index `first`."""
    return [make_pod(f"p-{i}", cpu="1", memory="128Mi", labels={"app": "w"})
            for i in range(first, first + 80)]


def phantom_nodes():
    """26 four-cpu nodes (104 one-cpu pods cluster-wide): 6 phantom columns
    at 8 shards, 6 at 2 and 4 (padded to 32)."""
    return [make_node(f"n{i}", cpu="4", memory="8Gi", pods="8") for i in range(26)]


def _reasons(failed) -> dict:
    return {u.pod["metadata"]["name"]: u.reason for u in failed}


def _xray_lines(prefix) -> list:
    import json

    out = []
    with open(prefix + ".jsonl") as f:
        for line in f:
            rec = json.loads(line)
            for k in ("backend_path", "pid", "created_unix"):
                rec.pop(k, None)
            out.append(rec)
    return out


def _same_xray(a: str, b: str) -> bool:
    if _xray_lines(a) != _xray_lines(b):
        return False
    with np.load(a + ".npz") as za, np.load(b + ".npz") as zb:
        return sorted(za.files) == sorted(zb.files) and all(
            np.array_equal(za[k].view(np.uint8), zb[k].view(np.uint8)) for k in za.files)


def partitioned_engine(mesh, device="cpu", xray_dir=None) -> dict:
    """`Simulator(use_mesh=True)` with `use_waves = False` on this rank's
    mesh (the partitioned layout): the mixed workload (recorded by the xray
    flight recorder, its trace against the unsharded serial run's when
    `xray_dir` is given) and the two-batch phantom test, with placements,
    failures and their reasons, the collective calls, the end carry's
    phantom rows (gathered) and simon_reshard_bytes_total."""
    from open_simulator_torch.obs import REGISTRY
    from open_simulator_torch.obs import xray
    from open_simulator_torch.parallel.collectives import all_gather_rows
    from open_simulator_torch.simulator.engine import Simulator

    def sim_on(nodes, partitioned):
        sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=partitioned)
        sim.use_waves = False
        if partitioned:
            assert sim._resolve_mesh().shards == mesh.shards
            sim._mesh = mesh  # this rank's mesh, whose counters are read
        return sim

    reshard0 = REGISTRY.values().get("simon_reshard_bytes_total", 0)
    out = {}
    nodes, pods = mixed_workload()
    traces = []
    for partitioned in (True, False):
        prefix = None
        if xray_dir is not None:
            prefix = os.path.join(xray_dir, f"r{mesh.rank}_{int(partitioned)}")
            xray.enable(prefix)
        try:
            sim = sim_on(nodes, partitioned)
            mesh.reset_counts()
            failed = sim.schedule_pods(copy.deepcopy(pods))
        finally:
            if prefix is not None:
                xray.disable()
        traces.append(prefix)
        rec = placements(sim, failed)
        rec.update(reasons=_reasons(failed), calls=_calls(mesh),
                   census={k: list(v) for k, v in sim.segment_census.items()})
        out["mixed" if partitioned else "mixed_unsharded"] = rec
    out["mixed"]["same_xray"] = _same_xray(*traces) if xray_dir is not None else None
    sim = sim_on(phantom_nodes(), True)
    mesh.reset_counts()
    f1 = sim.schedule_pods(phantom_pods(0))
    f2 = sim.schedule_pods(phantom_pods(100))
    requested = all_gather_rows(sim._last_carry.requested, mesh)
    rec = placements(sim, f1 + f2)
    rec.update(failed_per_batch=[len(f1), len(f2)], reasons=_reasons(f1 + f2),
               calls=_calls(mesh), block_rows=int(sim._last_carry.requested.shape[0]),
               padded=int(requested.shape[0]),
               phantom_untouched=not bool(requested[26:].any()),
               utilization=sim.probe_utilization())
    out["phantom"] = rec
    out["reshard_bytes"] = REGISTRY.values().get("simon_reshard_bytes_total", 0) - reshard0
    return out


def partitioned_cases(mesh, device="cpu", xray_dir=None) -> dict:
    """Every case of test_torch_partitioned.py on this rank's mesh."""
    return {"rank": mesh.rank, "shards": mesh.shards,
            "batches": partitioned_batches(mesh, device),
            "scans": partitioned_scans(mesh, device),
            "layout": partitioned_layout(mesh, device),
            "engine": partitioned_engine(mesh, device, xray_dir)}


def card_partitioned(mesh) -> list:
    """On the card: K12 against the plain sharded scan (on the card, on the
    same ranks) and against the unsharded K2, on the seeded clusters of
    `partitioned_scans` (EXT false, then true): choices, the final carry
    (gathered for K2) and K12's collective calls; then at the end carry K1
    on the block and K12's explain mode, gathered, against K1 and K7
    unsharded and against the plain versions on the block, for every group,
    unforced and forced into every block. One record per cluster."""
    return [_card_partitioned_cluster(mesh, *c) for c in partitioned_clusters()]


# the blocks of K12's card cases over every cluster size: NL nodes a rank
# (not a multiple of the cluster size) and the C that ops/cluster.py
# `choose` gives its stages
K12_BLOCKS = ((1_001, 2), (2_047, 4), (4_095, 8), (8_191, 16))


def card_k12_cluster_sizes(mesh) -> list:
    """`card_partitioned` at blocks whose stages take every cluster size
    (K12_BLOCKS): `partitioned_workload` over 2 * NL nodes (ScheduleAnyway
    groups on the hostname and the zone key, pods pinned into every block)
    and the extended cluster (EXT: GPU-share and Open-Local), with the shape
    of K12's stages. One record per cluster and block."""
    from open_simulator_torch.utils.synth import synth_extended_cluster

    out = []
    for NL, want in K12_BLOCKS:
        N = NL * mesh.shards
        nodes, pods, services = partitioned_workload(n_nodes=N, cordon_from=N - NL // 2)
        ext_nodes, ext_pods, _, scs = synth_extended_cluster(N, 160)
        for c in (("seeded", nodes, pods, services, []),
                  ("extended", ext_nodes, ext_pods, [], scs)):
            out.append(dict(_card_partitioned_cluster(mesh, *c, bucketed=False), want_C=want))
    return out


def _card_partitioned_cluster(mesh, label, nodes, pods, services, scs, bucketed=True) -> dict:
    """`card_partitioned` on one cluster (`bucketed`: the node axis padded
    to the encoder's bucket, else to the shard count only)."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.collectives import all_gather_tiled
    from open_simulator_torch.parallel.mesh import gather_carry, to_device_sharded
    from open_simulator_torch.simulator.encode import pad_batch_tables, plugin_flags
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(copy.deepcopy(nodes), device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=list(services),
                                               storage_classes=list(scs)))
    bt = pad_batch_tables(sim.encode_batch(copy.deepcopy(pods)) if bucketed
                          else unbucketed(sim, copy.deepcopy(pods), mesh.shards), mesh.shards)
    gpu, storage = plugin_flags(bt)
    flags = dict(enable_gpu=gpu, enable_storage=storage)
    pg, fn, vd = (torch.from_numpy(a) for a in (bt.pod_group, bt.forced_node, bt.valid))
    tb, seed = K.tables_from_batch(bt, "cuda"), K.carry_from_batch(bt, "cuda")
    tbl, seedl, _ = to_device_sharded(bt, mesh)
    mesh.reset_counts()
    kc, kch = K.schedule_batch_sharded_kernel(tbl, seedl, pg, fn, vd, bt.n_zones, mesh,
                                              **flags)
    calls = _calls(mesh)
    shape = K.schedule_batch_sharded_kernel.last_shape
    pc, pch = K.schedule_batch_sharded_plain(tbl, seedl, pg, fn, vd, bt.n_zones, mesh,
                                             **flags)
    uc, uch = K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones, **flags)
    full = gather_carry(kc, mesh)
    N, NL = int(tb.alloc.shape[0]), int(tbl.alloc.shape[0])
    P = int(vd.sum())
    groups = sorted({int(g) for g in bt.pod_group[:P]})
    forced = [-1] + [b * NL + NL // 2 for b in range(mesh.shards)]
    diag = True
    for g in groups:
        for f in forced:
            fk, sk = K.feasibility_jit(tbl, kc, g, f, True, **flags, mesh=mesh)
            fu, su = K.feasibility_kernel(tb, uc, g, f, True, **flags)
            diag &= torch.equal(fk, fu) and all(torch.equal(sk[k], su[k])
                                                for k in K.STAGE_KEYS)
            ek = K.explain_sharded_kernel(tbl, kc, g, f, True, bt.n_zones, **flags, mesh=mesh)
            ep = K.pack_explain(*K.explain_pod(tbl, kc, g, f, True, bt.n_zones, **flags,
                                               mesh=mesh))
            eu = K.explain_kernel(tb, uc, g, f, True, bt.n_zones, **flags)
            diag &= torch.equal(ek.view(torch.int32), ep.view(torch.int32))
            diag &= torch.equal(all_gather_tiled(ek, mesh, axis=1).view(torch.int32),
                                eu.view(torch.int32))
    return {"cluster": label, "N": N, "NL": NL, "pods": P, "flags": (gpu, storage),
            "sa_pods": sum(K._has_sa(tb, int(g)) for g in bt.pod_group[:P]),
            "calls": calls, "C": shape.C,
            "forced_blocks": sorted({int(f) // NL for f in bt.forced_node[:P] if f >= 0}),
            "same_plain": bool(torch.equal(kch, pch))
            and all(torch.equal(a, b) for a, b in zip(kc, pc)),
            "same_unsharded": bool(torch.equal(kch, uch))
            and all(torch.equal(a, b) for a, b in zip(full, uc)),
            "diag_same": bool(diag), "failed": int((kch[:P] < 0).sum())}


# ------------------------------------------------ the default route, partitioned ----
#
# Every route on the partitioned node layout (the group-serial scan K13 and
# the block commit K14 beside K8 - K12): tests/test_torch_partitioned_default.py
# spawns the ranks and holds these records against the JAX package's mesh.

def spread_workload(n_nodes: int = 64, n_pods: int = 600):
    """A prefix of utils/synth.py `synth_spread_cluster` (zoned nodes,
    self-spreading groups): its segments reach the group-serial scan with
    ScheduleAnyway terms (sa_live), with a zoned SelectorSpread (ss_live)
    and with DoNotSchedule terms only, and a wave. Returns (nodes, pods,
    services)."""
    from open_simulator_torch.utils.synth import synth_spread_cluster

    nodes, pods, services = synth_spread_cluster(n_nodes, 2 * n_pods)
    return nodes, pods[:n_pods], services


def _seg_valid(length: int):
    import torch

    from open_simulator_torch.simulator.encode import bucket_capped

    vd = torch.zeros(bucket_capped(length, 2048), dtype=torch.bool)
    vd[:length] = True
    return vd


def group_serial_segments(mesh, device="cpu") -> list:
    """Every segment of `spread_workload` and of the extended cluster's GPU
    waves, chained from the seed carry by the unsharded path: for a spread
    segment the plain block scan (`schedule_group_serial_sharded_plain`)
    against the unsharded plain scan (the block's counts, placed, the
    collective calls); for every segment the plain block commit against the
    unsharded commit of the same counts (the block's carry), with and
    without gpu_live. One record per segment."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_extended_cluster

    ext_nodes, ext_pods, _, scs = synth_extended_cluster(32, 300)
    out = []
    for label, nodes, pods, svc, sc in (("spread", *spread_workload(), []),
                                        ("extended", ext_nodes, ext_pods, [], scs)):
        sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(svc),
                                                   storage_classes=list(sc)))
        bt = sim.encode_batch(copy.deepcopy(pods))
        tb, cry = sim._to_device(bt)
        N = int(tb.alloc.shape[0])
        sl = slice(mesh.rank * (N // mesh.shards), (mesh.rank + 1) * (N // mesh.shards))
        for seg in sim._segments(bt, len(pods)):
            if seg[0] == "serial":
                continue
            kind, _, m, g, cap1 = seg[:5]
            tbl, cryl = on_mesh(tb, cry, mesh)
            rec = {"cluster": label, "kind": kind, "m": m}
            gpu_live = kind == "wave" and bool(seg[5])
            if kind == "spread":
                ss, sa = bool(seg[5]), bool(seg[6])
                kw = dict(ss_live=ss, sa_live=sa, n_zones=bt.n_zones if ss else 2)
                vd = _seg_valid(m)
                mesh.reset_counts()
                bj, bp = K.schedule_group_serial_sharded_plain(tbl, cryl, g, vd, bool(cap1), mesh,
                                                               **kw)
                rec["calls"] = _calls(mesh)
                j, placed = K.schedule_group_serial_plain(tb, cry, g, vd, bool(cap1), **kw)
                rec.update(ss_live=ss, sa_live=sa, placed=placed,
                           same=torch.equal(bj, j[sl]) and bp == placed)
            elif kind == "wave":
                block = K.wave_block_for(m, sim.na.N)
                j = K.schedule_wave_plain(tb, cry, g, m, bool(cap1), block=block,
                                          kmax=K.wave_kmax(m, sim.na.N, block),
                                          gpu_live=gpu_live)[0]
            else:
                j = K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1),
                                                   ss_live=bool(seg[5]),
                                                   block=K.wave_block_for(m, sim.na.N),
                                                   n_zones=bt.n_zones if seg[5] else 2)[0]
            mesh.reset_counts()
            bc = K.aggregate_commit_sharded_plain(tbl, cryl, g, j[sl], gpu_live, mesh)
            rec["commit_calls"] = _calls(mesh)
            uc = K.aggregate_commit_plain(tb, cry, g, j, gpu_live)
            rec.update(gpu_live=gpu_live, commit_same=all(
                torch.equal(a, b) for a, b in zip(bc, on_mesh(tb, uc, mesh)[1])))
            out.append(rec)
            cry = uc
    return out


def chained_layout(mesh, device="cpu") -> dict:
    """The default route's layout over chained dispatches: the seeded
    workload's engine run on the mesh, then this rank's bytes of every
    node-axis table and carry leaf against the unsharded ones, and the carry
    leaves out of the partitioned layout after each segment's dispatch
    (simon_reshard_bytes_total)."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.obs.metrics import REGISTRY
    from open_simulator_torch.parallel.mesh import (_CARRY_NODE_AXIS, _TABLE_NODE_AXIS,
                                                    carry_reshard_bytes, carry_shardings)
    from open_simulator_torch.simulator.engine import Simulator

    nodes, pods, services = seeded_workload()
    reshard0 = REGISTRY.values().get("simon_reshard_bytes_total", 0)
    sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=True)
    sim.register_cluster_objects(ResourceTypes(services=services))
    sim._mesh = mesh
    bt = sim.encode_batch(copy.deepcopy(pods))
    tables, carry = sim._to_device(bt)
    N = int(bt.alloc.shape[0])
    decl = carry_shardings(mesh, N)
    moved = []
    for seg in sim._segments(bt, len(pods)):
        carry, _, _ = sim._dispatch(seg, bt, tables, carry, (False, False))
        moved.append(carry_reshard_bytes(carry, decl))

    def node_bytes(obj, axes) -> int:
        return sum(getattr(obj, f).numel() * getattr(obj, f).element_size() for f in axes)

    full = (sum(getattr(bt, f).nbytes for f in _TABLE_NODE_AXIS)
            + sum(getattr(bt, "seed_" + f).nbytes for f in _CARRY_NODE_AXIS))
    held = node_bytes(tables, _TABLE_NODE_AXIS) + node_bytes(carry, _CARRY_NODE_AXIS)
    return {"segments": len(moved), "moved": moved, "held": held, "full": full,
            "reshard_bytes": REGISTRY.values().get("simon_reshard_bytes_total", 0) - reshard0}


def probe_counts(mesh, device="cpu") -> dict:
    """`Simulator.probe_pods` of the mixed and seeded workloads on the mesh
    (every route, the counts global)."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.engine import Simulator

    out = {}
    for name, (nodes, pods, services) in (("mixed", (*mixed_workload(), [])),
                                          ("seeded", seeded_workload())):
        sim = Simulator(copy.deepcopy(nodes), device=device, use_mesh=mesh is not None)
        sim.register_cluster_objects(ResourceTypes(services=list(services)))
        if mesh is not None:
            sim._mesh = mesh
        out[name] = list(sim.probe_pods(copy.deepcopy(pods)))
        out[name + "_utilization"] = sim.probe_utilization()
    return out


def default_route_cases(mesh, device="cpu", tables=()) -> dict:
    """Every case of test_torch_partitioned_default.py on this rank's mesh;
    `tables`: `block_scans`' table sets."""
    out = {"rank": mesh.rank, "shards": mesh.shards, "blocks": block_scans(mesh, tables)}
    for name in ("mixed", "hard_affinity"):
        out[name] = run_engine(*WORKLOADS[name](), mesh=mesh, device=device)
    out["spread"] = run_engine(*spread_workload(), mesh=mesh, device=device)
    out["segments"] = group_serial_segments(mesh, device)
    out["layout"] = chained_layout(mesh, device)
    out["probe"] = probe_counts(mesh, device)
    out["preempt"] = preempt_engine(mesh, device)
    out["preempt_unsharded"] = preempt_engine(None, device)
    return out


# the node count of the preemption case (tests/test_torch_golden.py
# `preempt_workload`, cut): every lower tier placed, three specs preempting
PREEMPT_MESH_NODES = 32


def preempt_records(sim, calls, failed) -> dict:
    """Placements, the `preempted` records and every failed pod's
    nominatedNodeName of a preemption run."""
    out = placements(sim, failed)
    out["preempted"] = [[r["pod"]["metadata"]["name"], r["node"], r["by"]]
                        for r in sim.preempted]
    out["nominated"] = {u.pod["metadata"]["name"]:
                        (u.pod.get("status") or {}).get("nominatedNodeName") for u in failed}
    return out


def preempt_engine(mesh, device="cpu", n_nodes: int = PREEMPT_MESH_NODES) -> dict:
    """The DefaultPreemption PostFilter on `mesh` (None: unsharded): the
    three calls of the preemption workload through the port's Simulator,
    with the fits counted and, on a mesh, the tiled gathers each fit made
    (K1 on the block, gathered once: `feasibility_packed`)."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator import preemption as P
    from open_simulator_torch.simulator.engine import Simulator
    from test_torch_golden import preempt_workload

    nodes, calls, pdbs = preempt_workload(n_nodes)
    sim = Simulator(nodes, device=device, use_mesh=mesh is not None)
    sim.register_cluster_objects(ResourceTypes(pod_disruption_budgets=pdbs))
    if mesh is not None:
        sim._mesh = mesh  # read the collective counters of this rank's mesh
        mesh.reset_counts()
    tally = {"fits": 0, "gathers": Counter()}
    orig = P._fits

    def counted(s, g, node_i, placed2):
        before = mesh.counts["all_gather_tiled"]["calls"] if mesh is not None else 0
        out = orig(s, g, node_i, placed2)
        tally["fits"] += 1
        if mesh is not None:
            tally["gathers"][mesh.counts["all_gather_tiled"]["calls"] - before] += 1
        return out

    P._fits = counted
    try:
        failed = []
        for call in calls:
            failed.extend(sim.schedule_pods(call))
    finally:
        P._fits = orig
    out = preempt_records(sim, calls, failed)
    out.update(fits=tally["fits"], gathers_per_fit=dict(tally["gathers"]),
               shards=mesh.shards if mesh is not None else 1)
    return out


def card_default_route(mesh) -> dict:
    """On the card: K13 against `schedule_group_serial_sharded_plain` (on
    the card, on the same ranks) and the unsharded K4, and K14 against
    `aggregate_commit_sharded_plain` and the unsharded K3c, on every segment
    of `group_serial_segments`' clusters; then the engine's default route on
    the mesh against the unsharded engine on the card (mixed, hard
    affinity, spread)."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_extended_cluster

    ext_nodes, ext_pods, _, scs = synth_extended_cluster(32, 300)
    segs = []
    for label, nodes, pods, svc, sc in (("spread", *spread_workload(), []),
                                        ("extended", ext_nodes, ext_pods, [], scs)):
        sim = Simulator(copy.deepcopy(nodes), device="cuda", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(svc),
                                                   storage_classes=list(sc)))
        bt = sim.encode_batch(copy.deepcopy(pods))
        tb, cry = sim._to_device(bt)
        N = int(tb.alloc.shape[0])
        sl = slice(mesh.rank * (N // mesh.shards), (mesh.rank + 1) * (N // mesh.shards))
        for seg in sim._segments(bt, len(pods)):
            if seg[0] == "serial":
                continue
            kind, _, m, g, cap1 = seg[:5]
            tbl, cryl = on_mesh(tb, cry, mesh)
            rec = {"cluster": label, "kind": kind, "m": m}
            gpu_live = kind == "wave" and bool(seg[5])
            if kind == "spread":
                ss, sa = bool(seg[5]), bool(seg[6])
                kw = dict(ss_live=ss, sa_live=sa, n_zones=bt.n_zones if ss else 2)
                vd = _seg_valid(m)
                mesh.reset_counts()
                kj, kp = K.schedule_group_serial_sharded_kernel(tbl, cryl, g, vd, bool(cap1),
                                                                mesh, **kw)
                rec["calls"] = _calls(mesh)
                pj, pp = K.schedule_group_serial_sharded_plain(tbl, cryl, g, vd, bool(cap1),
                                                               mesh, **kw)
                j, up = K.schedule_group_serial_kernel(tb, cry, g, vd, bool(cap1), **kw)
                rec.update(ss_live=ss, sa_live=sa, placed=int(kp),
                           same_plain=torch.equal(kj, pj) and int(kp) == pp,
                           same_unsharded=torch.equal(kj, j[sl]) and int(kp) == int(up))
            elif kind == "wave":
                block = K.wave_block_for(m, sim.na.N)
                j = K.schedule_wave_kernel(tb, cry, g, m, bool(cap1), block=block,
                                           kmax=K.wave_kmax(m, sim.na.N, block),
                                           gpu_live=gpu_live)[0]
            else:
                j = K.schedule_affinity_wave_kernel(tb, cry, g, m, bool(cap1),
                                                    ss_live=bool(seg[5]),
                                                    block=K.wave_block_for(m, sim.na.N),
                                                    n_zones=bt.n_zones if seg[5] else 2)[0]
            mesh.reset_counts()
            kc = K.aggregate_commit_sharded_kernel(tbl, cryl, g, j[sl], gpu_live, mesh)
            rec["commit_calls"] = _calls(mesh)
            pc = K.aggregate_commit_sharded_plain(tbl, cryl, g, j[sl], gpu_live, mesh)
            uc = K.aggregate_commit_kernel(tb, cry, g, j, gpu_live)
            rec.update(gpu_live=gpu_live,
                       commit_plain=all(torch.equal(a, b) for a, b in zip(kc, pc)),
                       commit_unsharded=all(torch.equal(a, b)
                                            for a, b in zip(kc, on_mesh(tb, uc, mesh)[1])))
            segs.append(rec)
            cry = uc
    engine = {}
    for name, (nodes, pods, services) in (("mixed", (*mixed_workload(), [])),
                                          ("hard_affinity", (*hard_affinity_workload(), [])),
                                          ("spread", spread_workload())):
        got = run_engine(nodes, pods, services, mesh=mesh, device="cuda")
        want = run_engine(nodes, pods, services, device="cuda")
        engine[name] = {"same": got["placed"] == want["placed"]
                        and got["failed"] == want["failed"],
                        "census": got["census"], "calls": {k: v["calls"]
                                                          for k, v in got["counts"].items()},
                        "launches": got["launches"]}
    return {"segments": segs, "engine": engine}


# K13's card blocks: (nodes of the spread cluster, NL nodes a rank, the C
# that ops/cluster.py `choose` gives its stages: one node a thread)
K13_BLOCKS = ((2_000, 1_024, 2), (5_000, 2_560, 8))


def card_k13_blocks(mesh) -> list:
    """On the card, at blocks of 1,024 and 2,560 nodes (K13_BLOCKS): K13 on
    every group-serial segment of the spread cluster's first 600 pods (with
    ScheduleAnyway terms, with a zoned SelectorSpread, with DoNotSchedule
    terms only), against its plain version on the same ranks and the
    unsharded K4, with the shape of its stages and its collective calls.
    One record per segment."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    out = []
    for n_nodes, NL, want in K13_BLOCKS:
        nodes, pods, services = spread_workload(n_nodes=n_nodes)
        sim = Simulator(nodes, device="cuda", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services)))
        bt = sim.encode_batch(pods)
        tb, cry = sim._to_device(bt)
        assert tb.alloc.shape[0] == NL * mesh.shards
        sl = slice(mesh.rank * NL, (mesh.rank + 1) * NL)
        for seg in sim._segments(bt, len(pods)):
            kind, _, m, g, cap1 = seg[:5]
            if kind == "spread":
                ss, sa = bool(seg[5]), bool(seg[6])
                kw = dict(ss_live=ss, sa_live=sa, n_zones=bt.n_zones if ss else 2)
                vd = _seg_valid(m)
                tbl, cryl = on_mesh(tb, cry, mesh)
                mesh.reset_counts()
                kj, kp = K.schedule_group_serial_sharded_kernel(tbl, cryl, g, vd, bool(cap1),
                                                                mesh, **kw)
                calls = _calls(mesh)
                shape = K.schedule_group_serial_sharded_kernel.last_shape
                pj, pp = K.schedule_group_serial_sharded_plain(tbl, cryl, g, vd, bool(cap1), mesh,
                                                               **kw)
                uj, up = K.schedule_group_serial_kernel(tb, cry, g, vd.cuda(), bool(cap1), **kw)
                out.append({"NL": NL, "C": shape.C, "want_C": want, "m": m, "ss_live": ss,
                            "sa_live": sa, "placed": int(kp), "calls": calls,
                            "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp,
                            "same_unsharded": bool(torch.equal(kj, uj[sl]))
                            and int(kp) == int(up)})
                j = uj
            elif kind == "wave":
                block = K.wave_block_for(m, sim.na.N)
                j = K.schedule_wave_kernel(tb, cry, g, m, bool(cap1), block=block,
                                           kmax=K.wave_kmax(m, sim.na.N, block),
                                           gpu_live=bool(seg[5]))[0]
            else:
                continue
            cry = K.aggregate_commit(tb, cry, g, j)
    return out


# K8's card clusters: (label, the mesh's N, the C of its block stages and of
# its tail that ops/cluster.py `choose` gives them, pods of the cluster)
K8_CLUSTERS = (("overflow_waves", 128, 1, 1, 3_000), ("extended_1gpu", 2_048, 2, 4, 2_500),
               ("northstar", 10_240, 16, 16, 20_000))


def card_k8_clusters(mesh) -> list:
    """On the card, the epoch path at the limit 16,384: K8 on the first wave
    segments (up to three) of overflow_waves' cluster (N 128: clusters of 1),
    on the extended cluster's first 1-GPU wave (N 2,048, EXT) and on the
    northstar shape's first waves (N 10,240, B 64: the gathered rows in
    global memory), against its plain sharded version on the same ranks
    and the unsharded K3, with the shapes of its block stages and its tail
    and its collective calls. One record per segment."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster, synth_extended_cluster

    out = []
    with epoch_limit(16384):
        for label, N, want_b, want_t, n_pods in K8_CLUSTERS:
            scs = []
            if label == "overflow_waves":
                nodes, pods = synth_cluster(100, n_pods, hard_predicates=True)
            elif label == "extended_1gpu":
                nodes, pods, _, scs = synth_extended_cluster(2000, 20000)
                pods = pods[:n_pods]
            else:
                nodes, pods = synth_cluster(10000, n_pods)
            sim = Simulator(nodes, device="cuda", use_mesh=False)
            sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
            bt = sim.encode_batch(pods)
            tb, cry = sim._to_device(bt)
            assert tb.alloc.shape[0] == N
            waves = [s for s in sim._segments(bt, len(pods)) if s[0] == "wave"]
            if label == "extended_1gpu":
                waves = [next(s for s in waves if s[5])]
            for seg in waves[:3]:
                _, _, m, g, cap1, gpu_live = seg[:6]
                block = K.wave_block_for(m, sim.na.N)
                kw = dict(block=block, kmax=K.wave_kmax(m, sim.na.N, block),
                          gpu_live=bool(gpu_live))
                tbl, cryl = on_mesh(tb, cry, mesh)
                mesh.reset_counts()
                kj, kp, kst = K.schedule_wave_sharded_kernel(tbl, cryl, g, m, bool(cap1),
                                                             mesh=mesh, **kw)
                calls = _calls(mesh)
                shape = K.schedule_wave_sharded_kernel.last_shape
                pj, pp, pst = K.schedule_wave_plain(tbl, cryl, g, m, bool(cap1), mesh=mesh, **kw)
                uj, up, ust = K.schedule_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
                out.append({"cluster": label, "N": N, "block": block, "m": m,
                            "gpu_live": bool(gpu_live),
                            "C": (shape["block"].C, shape["tail"].C), "want_C": (want_b, want_t),
                            "stats": kst.tolist(), "calls": calls,
                            "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp
                            and kst.tolist() == [pst[k] for k in K.WAVE_STATS],
                            "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                            and kst.tolist() == ust.tolist()})
                cry = K.aggregate_commit(tb, cry, g, uj, bool(gpu_live))
    return out


def block_scans(mesh, tables: list) -> list:
    """On tables given as numpy arrays (the JAX package's encode of a
    batch: every Tables field and every carry field's `seed_` array), each
    spec of the plain block scan and commit on this rank's block of them:
    for a scan (g, m, cap1, ss_live, sa_live, n_zones), over m pods and three
    padded ones, the block's counts, placed and the carry block after the
    block commit of its counts; for a commit (g, j of every node, gpu_live),
    the carry block after it. One record per table set."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.mesh import block_of

    out = []
    for arrays, scans, commits in tables:
        tb = K.Tables(**{f: torch.tensor(arrays[f]) for f in K.Tables._fields})
        cry = K.Carry(**{f: torch.tensor(arrays["seed_" + f]) for f in K.Carry._fields})
        tbl, cryl = block_of(tb, cry, mesh)
        NL = int(tbl.alloc.shape[0])
        sl = slice(mesh.rank * NL, (mesh.rank + 1) * NL)
        rec = {"scans": [], "commits": []}
        for g, m, cap1, ss, sa, nz in scans:
            vd = torch.arange(m + 3) < m
            mesh.reset_counts()
            j, placed = K.schedule_group_serial_sharded_plain(tbl, cryl, g, vd, cap1, mesh,
                                                              ss_live=ss, sa_live=sa, n_zones=nz)
            calls = _calls(mesh)
            c = K.aggregate_commit_sharded_plain(tbl, cryl, g, j, False, mesh)
            rec["scans"].append({"j": j.numpy(), "placed": placed, "calls": calls,
                                 "carry": _carry_np(c)})
        for g, j, gpu_live in commits:
            c = K.aggregate_commit_sharded_plain(tbl, cryl, g, torch.from_numpy(j[sl]), gpu_live,
                                                 mesh)
            rec["commits"].append(_carry_np(c))
        out.append(rec)
    return out


def card_k14_blocks(mesh, n_nodes: int) -> list:
    """On the card, each rank a block of `n_nodes` nodes: K14 against
    `aggregate_commit_sharded_plain` (on the same ranks) and the unsharded
    K3c, on seeded counts (0-3 copies on about half the nodes) of every
    group of the hard-predicate cluster (every seventh node without a zone)
    and of the extended cluster (the GPU groups also with gpu_live), from
    the seed carry and, after every third group, from the carry K3c
    committed. One record per call: the rows stage's C, the collective
    calls, the block's carry against both, the input block unchanged and no
    output aliasing it."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.encode import pad_encoder_axes
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster, synth_extended_cluster

    N = n_nodes * mesh.shards
    sl = slice(mesh.rank * n_nodes, (mesh.rank + 1) * n_nodes)
    out = []
    for ext in (False, True):
        if ext:
            nodes, pods, _, scs = synth_extended_cluster(N, 300)
        else:
            nodes, pods = synth_cluster(N, 300, hard_predicates=True)
            scs = []
            for i, n in enumerate(nodes):
                if i % 7 == 3:
                    n["metadata"]["labels"].pop("topology.kubernetes.io/zone", None)
        sim = Simulator(nodes, device="cuda", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
        bt = pad_encoder_axes(sim.encode_batch_raw(pods))
        tb, cry = sim._to_device(bt)
        assert int(tb.alloc.shape[0]) == N
        rng = np.random.default_rng(n_nodes + ext)
        for i, g in enumerate(sorted({int(g) for g in bt.pod_group[:len(pods)]})):
            j = torch.from_numpy((rng.integers(0, 4, size=N) * (rng.random(N) < 0.5))
                                 .astype(np.int32)).cuda()
            for gpu_live in (False, True) if float(tb.grp_gpu_mem[g]) > 0 else (False,):
                tbl, cryl = on_mesh(tb, cry, mesh)
                before = K.Carry(*(t.clone() for t in cryl))
                mesh.reset_counts()
                kc = K.aggregate_commit_sharded_kernel(tbl, cryl, g, j[sl].contiguous(),
                                                       gpu_live, mesh)
                calls = _calls(mesh)
                shape = K.aggregate_commit_sharded_kernel.last_shape
                pc = K.aggregate_commit_sharded_plain(tbl, cryl, g, j[sl], gpu_live, mesh)
                uc = on_mesh(tb, K.aggregate_commit_kernel(tb, cry, g, j, gpu_live), mesh)[1]
                out.append({"ext": ext, "g": g, "gpu_live": gpu_live, "C": shape.C,
                            "calls": calls,
                            "same_plain": all(torch.equal(a, b) for a, b in zip(kc, pc)),
                            "same_unsharded": all(torch.equal(a, b) for a, b in zip(kc, uc)),
                            "input_kept": all(torch.equal(a, b) for a, b in zip(cryl, before)),
                            "fresh": all(a.data_ptr() != b.data_ptr()
                                         for a, b in zip(kc, cryl))})
            if i % 3 == 0:
                cry = K.aggregate_commit_kernel(tb, cry, g, j, False)
    return out
