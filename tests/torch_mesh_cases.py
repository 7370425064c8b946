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
    services = [{"apiVersion": "v1", "kind": "Service",
                 "metadata": {"name": "svc", "namespace": "default"},
                 "spec": {"selector": {"app": "svc"}}}]
    return nodes, pods, services


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
    if mesh is not None:
        assert sim._resolve_mesh().shards == mesh.shards
        sim._mesh = mesh  # read the collective counters of this rank's mesh
        mesh.reset_counts()
    failed = sim.schedule_pods(copy.deepcopy(pods))
    out = placements(sim, failed)
    out.update(census={k: list(v) for k, v in sim.segment_census.items()},
               wave=K.wave_stats(), affinity=K.affinity_stats(),
               launches={k: v for k, v in K.launch_counts().items() if "sharded" in k},
               shards=sim._mesh.shards if sim._mesh is not None else 1,
               counts=copy.deepcopy(mesh.counts) if mesh is not None else None)
    return out


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
            if kind == "wave":
                kmax = K.wave_kmax(m, sim.na.N, block)
                j, placed, st = K.schedule_wave_plain(tb, cry, g, m, bool(cap1), block=block,
                                                      kmax=kmax, gpu_live=bool(seg[5]), mesh=msh)
            else:
                nz = bt.n_zones if seg[5] else 2
                j, placed, st = K.schedule_affinity_wave_plain(
                    tb, cry, g, m, bool(cap1), ss_live=bool(seg[5]), block=block, n_zones=nz,
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
                    j, placed, st = K.schedule_wave_plain(tb, cry, g, m, cap1, filters=filters,
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


def card_round_kernels(mesh, limit: int = 16) -> list:
    """On the card: K10 against its plain per-round version (on the card, on
    the same ranks) and against the unsharded K3, on every run of
    `round_segments` (the epoch limit lowered to `limit`). One record per
    run, with the rounds' collective calls of K10's run."""
    import torch

    from open_simulator_torch.ops import kernels as K

    out = []
    with epoch_limit(limit):
        for label, tb, cry, m, g, cap1, gpu_live, variants in _round_wave_segments("cuda"):
            for filters, block, kmax in variants:
                kw = dict(filters=filters, block=block, kmax=kmax, gpu_live=gpu_live)
                mesh.reset_counts()
                kj, kp, kst = K.schedule_wave_rounds_kernel(tb, cry, g, m, cap1, mesh=mesh, **kw)
                calls = {k: v["calls"] for k, v in mesh.counts.items()}
                pj, pp, pst = K.schedule_wave_plain(tb, cry, g, m, cap1, mesh=mesh, **kw)
                uj, up, ust = K.schedule_wave_kernel(tb, cry, g, m, cap1, **kw)
                out.append({"cluster": label, "m": m, "kmax": kmax, "stats": kst.tolist(),
                            "calls": calls,
                            "same_plain": bool(torch.equal(kj, pj)) and int(kp) == pp
                            and kst.tolist() == [pst[k] for k in K.WAVE_STATS],
                            "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                            and kst.tolist() == ust.tolist()})
    return out


def route_rules(mesh, device="cpu") -> dict:
    """The epoch path's limits: an N that the shard count does not divide
    makes no collective call, and at an N above
    OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES the wave segments take the
    per-round path (two pmax and two all_gather_rows per round) while the
    affinity segments run unsharded; both place the same pods."""
    from open_simulator_torch.ops import kernels as K
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
        j, placed, st = K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1), ss_live=ss,
                                                       block=block, mesh=msh)
        res.append((j.tolist(), placed, st))
    out["indivisible"] = {"N": N, "kind": kind, "same": res[0] == res[1],
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
        if kind == "wave":
            kw = dict(block=block, kmax=K.wave_kmax(m, sim.na.N, block), gpu_live=bool(seg[5]))
            kj, kp, kst = K.schedule_wave_sharded_kernel(tb, cry, g, m, bool(cap1), mesh=mesh,
                                                         **kw)
            pj, pp, pst = K.schedule_wave_plain(tb, cry, g, m, bool(cap1), mesh=mesh, **kw)
            uj, up, ust = K.schedule_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
            names = K.WAVE_STATS
        else:
            kw = dict(ss_live=bool(seg[5]), block=block, n_zones=bt.n_zones if seg[5] else 2)
            kj, kp, kst = K.schedule_affinity_wave_sharded_kernel(tb, cry, g, m, bool(cap1),
                                                                  mesh=mesh, **kw)
            pj, pp, pst = K.schedule_affinity_wave_plain(tb, cry, g, m, bool(cap1), mesh=mesh,
                                                         **kw)
            uj, up, ust = K.schedule_affinity_wave_kernel(tb, cry, g, m, bool(cap1), **kw)
            names = K.AFFINITY_STATS
        out.append({"kind": kind, "m": m, "same_plain": bool(torch.equal(kj, pj)) and
                    int(kp) == pp and kst.tolist() == [pst[k] for k in names],
                    "same_unsharded": bool(torch.equal(kj, uj)) and int(kp) == int(up)
                    and kst.tolist() == ust.tolist()})
        cry = K.aggregate_commit(tb, cry, g, kj, bool(seg[5]) if kind == "wave" else False)
    return out
