"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of open_simulator_torch/ops/csrc from this checkout,
holds each kernel against its plain PyTorch version on the card (exact
equality: every output is a bool, an i32 or an f32 count), then drives the
port's main path, `Simulator.schedule_pods`, and holds each run against the
goldens the JAX package computed (tests/golden/torch_port_*.json):

- on the serial route (`use_waves=False`): a 5,000-node / 50,000-pod
  hard-predicate cluster and a 100-node cluster that overflows;
- on the default route (the segment router): the same two clusters, the
  10,000-node / 100,000-pod plain cluster (one wave), a 5,000-node /
  20,000-pod cluster whose pods spread against themselves (group-serial)
  and a 5,000-node / 20,000-pod cluster whose pods constrain themselves
  (self-affinity, self-anti-affinity, DoNotSchedule spread, live
  SelectorSpread: the affinity wave);
- GPU-share and Open-Local: a 2,000-node / 20,000-pod extended cluster on
  both routes (`extended`, `extended_serial`), the reference's primary
  example demo_1 with all four apps and 18 seeded new nodes against
  tests/golden/demo1_placements.json, and the distilled GPU-share example
  with its device ids pinned;
- the capacity planner: `CapacityPlanner.search()` on `capacity` (bench.py's
  capacity row: 64 base nodes, 100,000 pods, MaxCPU 60; its tables grow on
  the card from 128 to 1,024 nodes through the extension kernel K6) and
  `capacity_lanes` (512 base nodes, 20,000 pods of every segment kind,
  MaxCPU 90: rounds of eight candidates through K2-K5 over lanes) against
  the JAX search's goldens, every round's counts and utilization included;
  then `Applier.run()` on the three example configs against the JAX
  reports. Before them, each lane kernel is held against its plain fan-out
  and against its single-lane kernel lane by lane, and K6 against its plain
  version;
- scenario sweeps through the port's CLI entry point (`sweep ... --parity
  full --device cuda`): the three examples/sweeps specs byte for byte
  against the JAX reports (tests/golden/torch_port_sweep_*.json), and
  bench.py's 256-scenario sweep (2,564,314 pods on 960 + 64 nodes, fanout
  32) against the JAX report but for its parity block; then the resident
  image at full width: bench.py's serve shape (10,000 nodes, 5,000 bound
  pods, a 20,000-event watch stream ingested through `apply_events`) and 64
  what-if sessions in one `dispatch_sessions` call, every response against
  `fresh_probe` on the card. Before them, the four serve and sweep fan-outs
  (K2, K3 and K3c over lanes with per-lane pod streams, valid rows and wave
  groups) are held against their plain versions at S = 8 on the sweep's
  1,024-node image, lane by lane against the single-lane kernels, and in a
  call of five lanes padded to eight. The line after the build says which
  path computes the scheduling signature (the native raw-subtree hash or
  the computed tuple).
- the xray flight recorder (`apply --xray`'s engine path): `hard_waves`
  and `extended` again with recording on, against their placement goldens
  (the recorder only observes) and against the JAX package's traces of the
  same runs (tests/golden/torch_port_xray_*.json: every decision set's
  arrays, the set records and the pod rows, bit for bit). K7
  (`explain_jit`) runs once per decision set; before that phase line, K7 is
  held against the plain `explain_pod` on the card for every set without a
  feasible node and a seeded sample of 32 others. The phase prints the
  recording-on and -off walls and the encode and host-commit seconds the
  metric catalog measured.

Every phase prints one JSON line; any mismatch or error exits non-zero. The
line before the card line lists every kernel with its launches on the main
path, its time, its plain version's time and its bound; the last line is the
device record. Without a CUDA device it exits 2 and prints no result. Imports
no JAX and nothing of open_simulator_tpu.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from collections import Counter

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SRC = "open_simulator_torch/ops/csrc/"
JAX_KERNELS = "open_simulator_tpu/ops/kernels.py"
# which kernels run each segment kind of the router
# the probe fan-outs: which lane kernels run each segment kind
FANOUT_KERNELS = {"serial": "probe_serial_fanout", "wave": "probe_wave_fanout",
                  "spread": "probe_group_serial_fanout",
                  "affinity": "probe_affinity_wave_fanout"}
SEGMENT_KERNELS = {"serial": "K2 schedule_batch",
                   "wave": "K3 schedule_wave + K3c aggregate_commit (gpu_live for shared GPUs)",
                   "spread": "K4 schedule_group_serial + K3c aggregate_commit",
                   "affinity": "K5 schedule_affinity_wave + K3c aggregate_commit"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` by CUDA events (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(result, milliseconds) of one call of `fn`, by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def summarize(sim, pods, failed) -> dict:
    """Same digest as tests/test_torch_golden.py summarize()."""
    import numpy as np

    choices = np.array([sim.na.index.get((p.get("spec") or {}).get("nodeName"), -1)
                        for p in pods], dtype="<i4")
    counts = np.bincount(choices[choices >= 0], minlength=sim.na.N)
    census = Counter(u.reason.split("): ", 1)[1] for u in failed)
    return {
        "choices_sha256": hashlib.sha256(choices.tobytes()).hexdigest(),
        "per_node_counts": counts.tolist(),
        "placed": int((choices >= 0).sum()),
        "unscheduled": len(failed),
        "reason_census": dict(sorted(census.items())),
    }


def check_golden(kind: str, got: dict) -> None:
    with open(os.path.join(REPO, "tests", "golden", f"torch_port_{kind}.json")) as f:
        want = json.load(f)
    for k in ("choices_sha256", "per_node_counts", "placed", "unscheduled", "reason_census"):
        if got[k] != want[k]:
            fail(f"{kind}: {k} differs from the JAX golden")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def err_of(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def group_row_bytes(tb, cry, g: int) -> tuple:
    """Bytes one group's step reads once, as (tables, carry): the tables'
    share is its [N] rows (static masks, raw scores), alloc, the domain maps
    of its valid slots and the eligible-domain mask; the carry's share is
    requested, nonzero, the counter rows of its valid slots and its port
    columns. Lanes share the first and each read their own second."""
    N, R = tb.alloc.shape
    D1 = cry.counter.shape[1]
    shared, lane = 5 * N + 6 * 4 * N + 4 * N * R, 4 * N * R + 4 * N * 2
    for ids in (tb.req_aff_t[g], tb.req_anti_t[g], tb.dns_t[g], tb.carr_anti_t[g],
                tb.pref_t[g], tb.sa_t[g]):
        shared += int((ids >= 0).sum()) * 4 * N
        lane += int((ids >= 0).sum()) * 4 * D1
    return (shared + int((tb.dns_t[g] >= 0).sum()) * D1,
            lane + int((tb.grp_ports[g] > 0).sum()) * N)


def k1_bytes(tb, cry, g: int) -> int:
    """Bytes K1 must move for one group: the group's [N] rows, the alloc and
    requested rows, the counter/carrier rows and domain maps of its valid
    slots, its port columns, and the outputs (each read or written once)."""
    N, R = tb.alloc.shape
    D1 = cry.counter.shape[1]
    b = 5 * N + 2 * 4 * N * R                               # static masks, alloc, requested
    for ids in (tb.req_aff_t[g], tb.req_anti_t[g], tb.dns_t[g], tb.carr_anti_t[g]):
        b += int((ids >= 0).sum()) * (4 * N + 4 * D1)       # domain map + counter row
    b += int((tb.dns_t[g] >= 0).sum()) * D1                 # eligible-domain mask
    b += int((tb.grp_ports[g] > 0).sum()) * N               # port columns
    return b + N * (1 + 12 + R)                             # feasible, stages, fit_each


def k2_cost(tb, cry, n_valid: int, P: int) -> tuple:
    """(shared bytes, lane bytes, f32 operations) the serial scan must spend:
    tables and pod arrays read once (shared by lanes), carry in and out and
    choices (each lane's own) moved once; per valid pod and node,
    the f32 operations of one step as counted from csrc/schedule.cu (filters:
    4 per resource and 2 per slot; least/balanced 16; raw terms 3 per
    weighted slot; normalizers and selector spread 30; the total 22)."""
    import torch

    tables = [t for t in tb if isinstance(t, torch.Tensor)]
    carry = [cry.requested, cry.nonzero, cry.port_used, cry.counter, cry.carrier]
    N, R = tb.alloc.shape
    slots = sum(t.shape[1] for t in (tb.req_aff_t, tb.req_anti_t, tb.carr_anti_t, tb.dns_t))
    per_node = 4 * R + 2 * slots + 16 + 3 * (tb.pref_t.shape[1] + tb.carr_w_t.shape[1]) + 30 + 22
    return (nbytes(*tables) + P * (4 + 4 + 1), 2 * nbytes(*carry) + P * 4,
            n_valid * N * per_node)


# f32 operations of one [N, B+1] table entry of K3 (csrc/wave.cu): the copy
# count 1, usage 4, least/balanced 16, the weighted sum 4, the monotone test 1
K3_OPS_PER_ENTRY = 26
# f32 operations of one K3 iteration per node besides its table row:
# normalizers 6, the normalized static terms 16, the guard 2, the end
# normalizers 6
K3_OPS_PER_NODE = 30


def k3_cost(tb, cry, g: int, block: int, iterations: int) -> tuple:
    """(shared bytes, lane bytes, f32 operations) of one wave: the group's
    rows read once and the [N] counts written once; per iteration, the
    table's entries and the per-node passes (the radix passes are integer
    work and not counted)."""
    N = tb.alloc.shape[0]
    ops = iterations * N * ((block + 1) * K3_OPS_PER_ENTRY + K3_OPS_PER_NODE)
    shared, lane = group_row_bytes(tb, cry, g)
    return shared, lane + 4 * N, ops


def k3c_cost(tb, cry) -> tuple:
    """(shared bytes, lane bytes, f32 operations) of one aggregate commit:
    the [U, N] domain maps read once (shared by lanes); the carry's
    requested, nonzero, counter and carrier read and written once and the
    counts read once (each lane's own); one multiply and one add per
    element."""
    N, R = tb.alloc.shape
    D1 = cry.counter.shape[1]
    rows = N * R + 2 * N + (cry.counter.shape[0] + cry.carrier.shape[0]) * D1
    return nbytes(tb.topo_dom), 2 * 4 * rows + 4 * N, 2 * rows + tb.topo_dom.numel()


# f32 operations of one K4 step per node (csrc/group_serial.cu): the live
# DoNotSchedule test 4 per term, least/balanced 20, the normalized terms 16,
# the score 12, SelectorSpread 14, ScheduleAnyway 5 per term and 6
def k4_cost(tb, cry, g: int, n_valid: int) -> tuple:
    N = tb.alloc.shape[0]
    per_node = (4 * int((tb.dns_t[g] >= 0).sum()) + 20 + 16 + 12 + 14
                + 5 * int((tb.sa_t[g] >= 0).sum()) + 6)
    shared, lane = group_row_bytes(tb, cry, g)
    return shared, lane + 4 * N, n_valid * N * per_node


# f32 operations of one K5 epoch per node besides its table row
# (csrc/affinity_wave.cu): the live gates 4 per term slot, ip_raw 2 per
# weighted slot, the normalizer inputs 16, the normalized static terms 16,
# the cut 2, the sandwich 7
K5_OPS_PER_NODE = 41
# f32 operations of one K5 round per candidate position (budget, rank,
# levels: 16) and per domain (the count, the minimum, the level histogram,
# the rise and the block bookkeeping: 12)
K5_OPS_PER_POSITION = 16
K5_OPS_PER_DOMAIN = 12


def k5_cost(tb, cry, g: int, block: int, stats: dict) -> tuple:
    """(shared bytes, lane bytes, f32 operations) of one affinity wave: the
    group's rows and its live [slots, D+1] rows read once and the [N] counts
    written once; per
    epoch the per-node passes and the table (one column for a head-fallback
    epoch, B+1 otherwise); per productive round its K_EP positions and D+1
    domains."""
    N = tb.alloc.shape[0]
    D1 = cry.counter.shape[1]
    slots = sum(int((ids >= 0).sum()) for ids in (tb.dns_t[g], tb.req_aff_t[g], tb.req_anti_t[g],
                                                  tb.carr_anti_t[g], tb.carr_w_t[g])) + 1
    cw = int((tb.carr_w_t[g] >= 0).sum())
    epochs, heads, rounds = stats["epochs"], stats["head_fallbacks"], stats["multi_rounds"]
    columns = (epochs - heads) * (block + 1) + heads
    per_node = K5_OPS_PER_NODE + 4 * slots + 2 * cw
    ops = (columns * N * K3_OPS_PER_ENTRY + epochs * N * per_node
           + rounds * (min(N * block, 2048) * K5_OPS_PER_POSITION + D1 * K5_OPS_PER_DOMAIN))
    shared, lane = group_row_bytes(tb, cry, g)
    return shared, lane + 4 * slots * D1 + 4 * N, ops


def one_lane(cost: tuple) -> tuple:
    """(bytes, f32 operations) of a single-lane launch from a cost triple."""
    shared, lane, ops = cost
    return shared + lane, ops


def gpu_storage_bytes(tb, cry) -> int:
    """Bytes of the GPU-share and Open-Local tables and ledgers, each once."""
    return nbytes(tb.dev_total, cry.dev_used, tb.vg_cap, tb.vg_nameid, cry.vg_req, tb.sdev_cap,
                  tb.sdev_media, cry.sdev_alloc)


def gpu_storage_ops(tb, g: int) -> int:
    """f32 operations per node of one group's GPU filter and storage_alloc,
    as counted from csrc/common.cuh: the GPU filter 6 per device and 4 (only
    for a GPU group); storage_alloc 4 per VG and active LVM slot, 2 per
    storage device (the count pass), 3 per device and active device slot, 4
    per VG (the Binpack score) and 8."""
    M, V, Dv = tb.dev_total.shape[1], tb.vg_cap.shape[1], tb.sdev_cap.shape[1]
    gpu = (6 * M + 4) if float(tb.grp_gpu_mem[g]) > 0 else 0
    lvm = int((tb.grp_lvm_size[g] > 0).sum())
    dev = int((tb.grp_sdev_size[g] > 0).sum())
    return gpu + 4 * V * lvm + 2 * Dv + 3 * Dv * dev + 4 * V + 8


# f32 operations of one K7 node (csrc/explain.cu), counted as K2's step:
# filters 4 per resource and 2 per valid slot, least/balanced 16, the raw
# interpod terms 3 per valid weighted slot, normalizers and selector spread
# 30, the weighted components and their total 22, ScheduleAnyway 5 per valid
# term
def k7_cost(tb, cry, g: int, ext: bool) -> tuple:
    """(bytes, f32 operations) K7 must spend on one decision set: K1's reads
    (not its outputs), the group's six score rows, nonzero, the domain maps
    and counter or carrier rows of its weighted, ScheduleAnyway and
    SelectorSpread slots, and the [26, N] output written once; with the
    GPU-share / Open-Local branches, their tables and ledgers."""
    N, R = tb.alloc.shape
    D1 = cry.counter.shape[1]
    valid = lambda ids: int((ids >= 0).sum())  # noqa: E731
    slots = sum(valid(ids) for ids in (tb.req_aff_t[g], tb.req_anti_t[g], tb.carr_anti_t[g],
                                       tb.dns_t[g]))
    weighted = valid(tb.pref_t[g]) + valid(tb.carr_w_t[g])
    sa = valid(tb.sa_t[g])
    b = k1_bytes(tb, cry, g) - N * (1 + 12 + R) + 6 * 4 * N + 4 * N * 2 + 26 * 4 * N
    b += (weighted + sa + valid(tb.ss_t[g:g + 1])) * (4 * N + 4 * D1)
    ops = N * (4 * R + 2 * slots + 16 + 3 * weighted + 30 + 22 + 5 * sa)
    if ext:
        b += gpu_storage_bytes(tb, cry)
        ops += N * gpu_storage_ops(tb, g)
    return b, ops


def bound_of(b: int, ops: int) -> tuple:
    """(bound ms, "bytes" or "operations")."""
    tb, to = b / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, "operations" if to > tb else "bytes"


def run_simulate(kind: str, cluster, apps, card: str):
    """simulate() on the card with every launch count set to 0 just before
    it: (result, launch counts, wall seconds)."""
    import torch

    from open_simulator_torch import simulate
    from open_simulator_torch.ops import kernels as K

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simulate(cluster, apps, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    placed = sum(len(ns.pods) for ns in result.node_status)
    emit("simulate", kind=kind, route="default", nodes=len(result.node_status), placed=placed,
         unscheduled=len(result.unscheduled_pods), seconds=wall, launches=counts, card=card)
    return result, counts


def demo1(card: str) -> dict:
    """The reference's primary example: demo_1 with the simple, complicate,
    open_local and more_pods apps and 18 seeded new nodes, against
    tests/golden/demo1_placements.json (match_rate 1.0 through the port's
    parity module). Returns the launch counts."""
    from open_simulator_torch.core.types import AppResource
    from open_simulator_torch.models.fakenode import new_fake_nodes
    from open_simulator_torch.parity import load_dump, match_rate, placement_dump
    from open_simulator_torch.utils.yamlio import (load_cluster_from_directory,
                                                   load_resources_from_directory,
                                                   match_and_set_local_storage_annotation)

    cluster = load_cluster_from_directory(os.path.join(REPO, "examples/cluster/demo_1"))
    nn_dir = os.path.join(REPO, "examples/newnode/demo_1")
    nn = load_resources_from_directory(nn_dir)
    match_and_set_local_storage_annotation(nn.nodes, nn_dir)
    cluster.nodes += new_fake_nodes(nn.nodes[0], 18, seed=42)
    apps = [AppResource(name=name, resource=load_resources_from_directory(
        os.path.join(REPO, "examples/application", path)))
        for name, path in (("simple", "simple"), ("complicated", "complicate"),
                           ("open_local", "open_local"), ("more_pods", "more_pods"))]
    result, counts = run_simulate("demo_1", cluster, apps, card)
    rate, detail = match_rate(placement_dump(result),
                              load_dump(os.path.join(REPO, "tests", "golden",
                                                     "demo1_placements.json")))
    if rate != 1.0:
        fail(f"demo_1: match_rate {rate} against the golden ({dict(list(detail.items())[:5])})")
    emit("demo_1", match_rate=rate, golden="match", card=card)
    return counts


def gpushare_example(card: str) -> dict:
    """The distilled GPU-share example (examples/cluster/gpushare with
    examples/application/gpushare) with its outcome pinned as
    tests/test_gpushare.py pins it: every pod placed, the device ids of the
    two annotated pods, the pods per node. Returns the launch counts."""
    from open_simulator_torch.core.types import AppResource
    from open_simulator_torch.utils.yamlio import (load_cluster_from_directory,
                                                   load_resources_from_directory)

    cluster = load_cluster_from_directory(os.path.join(REPO, "examples/cluster/gpushare"))
    app = AppResource(name="pai_gpu", resource=load_resources_from_directory(
        os.path.join(REPO, "examples/application/gpushare")))
    result, counts = run_simulate("gpushare", cluster, [app], card)
    gpu_idx = {p["metadata"]["name"]: (ns.node["metadata"]["name"],
                                       p["metadata"]["annotations"]["alibabacloud.com/gpu-index"])
               for ns in result.node_status for p in ns.pods
               if (p["metadata"].get("annotations") or {}).get("alibabacloud.com/gpu-index")}
    per_node = {ns.node["metadata"]["name"]: len(ns.pods) for ns in result.node_status if ns.pods}
    want_idx = {"gpu-pod-00": ("pai-node-00", "0"), "gpu-pod-02": ("pai-node-00", "0-1")}
    if result.unscheduled_pods or gpu_idx != want_idx or per_node != {"pai-node-00": 4,
                                                                        "pai-node-01": 5}:
        fail(f"gpushare example: {gpu_idx}, {per_node}, "
             f"{len(result.unscheduled_pods)} unscheduled")
    emit("gpushare", gpu_index=gpu_idx, pods_per_node=per_node, pinned="match", card=card)
    return counts


def load_golden(kind: str) -> dict:
    with open(os.path.join(REPO, "tests", "golden", f"torch_port_{kind}.json")) as f:
        return json.load(f)


class max_cpu_env:
    """MaxCPU set (None: unset) for the duration of a block."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.prev = os.environ.pop("MaxCPU", None)
        if self.value is not None:
            os.environ["MaxCPU"] = str(self.value)

    def __exit__(self, *exc):
        os.environ.pop("MaxCPU", None)
        if self.prev is not None:
            os.environ["MaxCPU"] = self.prev


def lanes_session(kind: str, S: int):
    """The capacity probe session of a CAPACITY_SCENARIOS kind on the card,
    grown to its first round of S candidates in the golden, and that
    round's [S, N] node-active masks (as probe_many builds them)."""
    import numpy as np
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.probe import ProbeSession
    from open_simulator_torch.utils.synth import capacity_scenario

    base, template, pods, services, _ = capacity_scenario(kind)
    ses = ProbeSession.try_build(base, template, pods, ResourceTypes(services=services),
                                 device="cuda")
    cands = next(r["candidates"] for r in load_golden(kind)["rounds"]
                 if len(r["candidates"]) == S)
    ses.ensure_capacity(max(cands))
    active = np.zeros((S, ses._n_pad), bool)
    for i, n in enumerate(cands):
        active[i, :ses.n_base + n] = True
    return ses, torch.from_numpy(active).cuda(), cands


def lane_case(ses, seg, active, card: str) -> tuple:
    """One segment's lane kernel against its plain fan-out (counts or
    choices, placed, loop statistics, then K3c over lanes: every carry field
    of every lane) and lane by lane against the single-lane kernel on the
    lane's masked tables; times the lane kernel, the plain lanes, lane 0's
    single-lane kernel and K3c over lanes. Returns the kernels-line rows of
    the lane kernel and of K3c over lanes (None for the serial scan, which
    commits inside K2)."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.encode import bucket_capped

    tb, bt, seed = ses._tables, ses._bt, ses._seed
    S = active.shape[0]
    cry_s = K.carry_lanes(seed, S)
    w, filters = ses._sim.score_w, ses._sim.filter_flags
    n_real = ses.n_base + ses.n_new
    kind, start, length = seg[:3]
    masked = [K._mask_active(tb, active[s]) for s in range(S)]
    if kind == "serial":
        pad = bucket_capped(length, 2048)
        pg = torch.zeros(pad, dtype=torch.int32)
        pg[:length] = torch.from_numpy(bt.pod_group[start:start + length])
        fn = torch.full((pad,), -1, dtype=torch.int32)
        fn[:length] = torch.from_numpy(bt.forced_node[start:start + length])
        pg, fn = pg.cuda(), fn.cuda()
        vd = (torch.arange(pad) < length).cuda()
        args = (pg, fn, vd, bt.n_zones, w, filters, *ses._flags)
        lanes_k = lambda: K.schedule_batch_lanes_kernel(tb, cry_s, active, *args)  # noqa: E731
        lanes_p = lambda: K.schedule_batch_lanes_plain(tb, cry_s, active, *args)  # noqa: E731
        single = lambda s: K.schedule_batch_kernel(masked[s], K.carry_lane(cry_s, s), *args)  # noqa: E731,E501
        (kc, kch), _ = timed(lanes_k)
        (pc, pch), plain_ms = timed(lanes_p)
        if not torch.equal(kch, pch):
            fail(f"probe_serial_fanout: choices differ at {int((kch != pch).sum())} places")
        for s in range(S):
            c1, ch1 = single(s)
            if not torch.equal(ch1, kch[s]) or not torch.equal(c1.requested, kc.requested[s]):
                fail(f"probe_serial_fanout: lane {s} differs from the single-lane K2")
        placed = (kch >= 0).sum(dim=1)
        stats = None
        costs = [k2_cost(tb, seed, length, pad)] * S
        name = "probe_serial_fanout"
        commit = None
    else:
        g, cap1 = seg[3], bool(seg[4])
        block = K.wave_block_for(length, n_real)
        if kind == "wave":
            kw = dict(block=block, kmax=K.wave_kmax(length, n_real, block), gpu_live=seg[5])
            run_k, run_p, run_1 = (K.schedule_wave_lanes_kernel, K.schedule_wave_lanes_plain,
                                   K.schedule_wave_kernel)
            extra = (g, length, cap1)
        elif kind == "spread":
            vd = (torch.arange(bucket_capped(length, 2048)) < length).cuda()
            kw = dict(ss_live=seg[5], sa_live=seg[6], n_zones=bt.n_zones if seg[5] else 2)
            run_k, run_p, run_1 = (K.schedule_group_serial_lanes_kernel,
                                   K.schedule_group_serial_lanes_plain,
                                   K.schedule_group_serial_kernel)
            extra = (g, vd, cap1)
        else:
            kw = dict(ss_live=seg[5], block=block, n_zones=bt.n_zones if seg[5] else 2)
            run_k, run_p, run_1 = (K.schedule_affinity_wave_lanes_kernel,
                                   K.schedule_affinity_wave_lanes_plain,
                                   K.schedule_affinity_wave_kernel)
            extra = (g, length, cap1)
        lanes_k = lambda: run_k(tb, cry_s, active, *extra, w=w, filters=filters, **kw)  # noqa: E731,E501
        single = lambda s: run_1(masked[s], K.carry_lane(cry_s, s), *extra, w=w,  # noqa: E731
                                 filters=filters, **kw)
        ko, _ = timed(lanes_k)
        po, plain_ms = timed(lambda: run_p(tb, cry_s, active, *extra, w=w, filters=filters,
                                           **kw))
        name = FANOUT_KERNELS[kind]
        for a, b_ in zip(ko, po):
            if not torch.equal(a, b_):
                fail(f"{name}: counts, placed or statistics differ from the plain lanes")
        for s in range(S):
            one = single(s)
            if any(not torch.equal(a[s], b_.reshape(a[s].shape)) for a, b_ in zip(ko, one)):
                fail(f"{name}: lane {s} differs from the single-lane kernel")
        gpu_live = kind == "wave" and bool(seg[5])
        commit = lambda: K.aggregate_commit_lanes_kernel(tb, cry_s, g, ko[0], gpu_live)  # noqa: E731,E501
        kc = commit()
        pc, commit_plain_ms = timed(lambda: K.aggregate_commit_lanes_plain(tb, cry_s, g, po[0],
                                                                           gpu_live))
        placed = ko[1]
        stats = ko[2].sum(dim=0).tolist() if len(ko) > 2 else None
        # each lane's work as its own loop statistics say
        if kind == "wave":
            costs = [k3_cost(tb, seed, g, block, int(it)) for it in ko[2][:, 0].tolist()]
        elif kind == "spread":
            costs = [k4_cost(tb, seed, g, length)] * S
        else:
            costs = [k5_cost(tb, seed, g, block, dict(zip(K.AFFINITY_STATS, st)))
                     for st in ko[2].tolist()]
    for f in K.Carry._fields:
        if not torch.equal(getattr(kc, f), getattr(pc, f)):
            fail(f"{name}: carry.{f} differs from the plain lanes")
    ms = cuda_ms(lanes_k, 3)
    single_ms = cuda_ms(lambda: single(0), 3)
    N = int(tb.alloc.shape[0])
    # the tables once for all lanes; each lane's carry, counts, statistics
    # and [N] active row
    b = costs[0][0] + sum(lane + N for _, lane, _ in costs)
    ops = sum(op for _, _, op in costs)
    bound, by = bound_of(b, ops)
    emit(name, segment=kind, lanes=S, nodes=N, pods=length, placed=placed.tolist(),
         stats=stats, kernel_ms=ms, single_lane_ms=single_ms, plain_ms=plain_ms, bound_ms=bound,
         bytes=b, f32_ops=ops, max_abs_err=0.0, card=card)
    row = dict(source=SRC + {"serial": "schedule.cu", "wave": "wave.cu",
                             "spread": "group_serial.cu", "affinity": "affinity_wave.cu"}[kind],
               replaces=JAX_KERNELS + {"serial": ":2361", "wave": ":2302", "spread": ":2322",
                                       "affinity": ":2342"}[kind],
               max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    if commit is None:
        return row, None
    # K3c over lanes: the domain maps once, each lane's carry and counts
    c_ms = cuda_ms(commit, 20)
    shared, lane, c_ops = k3c_cost(tb, seed)
    cb = shared + S * lane
    c_bound, c_by = bound_of(cb, S * c_ops)
    emit("aggregate_commit_lanes", segment=kind, lanes=S, nodes=N,
         copies=ko[0].sum(dim=1).tolist(), kernel_ms=c_ms, plain_ms=commit_plain_ms,
         bound_ms=c_bound, bytes=cb, f32_ops=S * c_ops, max_abs_err=0.0, card=card)
    return row, dict(source=SRC + "wave.cu", replaces=JAX_KERNELS + ":976", max_abs_err=0.0,
                     ms=c_ms, plain_ms=commit_plain_ms, bound_ms=c_bound, bound_by=c_by)


def extend_case(card: str) -> dict:
    """K6 against extend_tables_plain on the `capacity` session's tables:
    the main path's growth (128 -> 1,024 nodes, no phantom pad) and a
    half-size growth with a pad. Times the launch alone (its pointer table
    and outputs built once), the whole wrapper call, the plain version and,
    as the library figure, torch.index_select along the node axis of every
    field (the fill aside). Returns the kernels-line row."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.probe import ProbeSession
    from open_simulator_torch.utils.synth import capacity_scenario

    base, template, pods, services, _ = capacity_scenario("capacity")
    ses = ProbeSession.try_build(base, template, pods, ResourceTypes(services=services),
                                 device="cuda")
    tb = ses._tables
    n_real = ses.n_base + ses.n_new
    sentinel = ses._seed.counter.shape[1] - 1
    out = None
    for n_new, pad in ((1024, 0), (1024, 448)):
        k = n_new - n_real - pad
        args = (tb, n_real, k, ses.n_base, n_new, sentinel)
        got = K.extend_tables_kernel(*args)
        want, plain_ms = timed(lambda: K.extend_tables_plain(*args))
        for f in K.Tables._fields:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                fail(f"extend_tables (pad {pad}): {f} differs from the plain version")
        plan = K.extend_tables_plan(*args)
        ms = cuda_ms(lambda: K.extend_tables_launch(plan), 50)
        wrapper_ms = cuda_ms(lambda: K.extend_tables_kernel(*args), 50)
        idx = torch.cat([torch.arange(n_real), torch.full((k,), ses.n_base)]).cuda()
        fields = [(getattr(tb, f), axis) for f, axis, _, _ in K.EXT_FIELDS]
        lib_ms = cuda_ms(lambda: [a.index_select(axis % a.dim(), idx) for a, axis in fields], 50)
        b = sum(nbytes(a) for a, _ in fields) + sum(nbytes(t) for t in plan.out.values())
        bound, by = bound_of(b, 0)
        emit("extend_tables", nodes_from=int(tb.alloc.shape[0]), nodes_to=n_new, k=k, pad=pad,
             fields=len(fields), kernel_ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=bound, bytes=b, max_abs_err=0.0, card=card)
        if out is None:  # the kernels line reports the main path's growth
            out = dict(source=SRC + "extend.cu",
                       replaces="open_simulator_tpu/parallel/mesh.py:672", max_abs_err=0.0,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms)
    return out


def capacity_search(kind: str, card: str) -> tuple:
    """CapacityPlanner.search() on the card against the JAX golden: found,
    nodes_added, hist, stats and every round's candidates with their
    (scheduled, total, utilization). Every launch count is set to 0 just
    before; returns (launch counts, wall seconds)."""
    import torch

    from open_simulator_torch.apply.applier import CapacityPlanner
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator import probe as PR
    from open_simulator_torch.utils.synth import capacity_scenario

    want = load_golden(kind)
    base, template, pods, services, max_cpu = capacity_scenario(kind)
    rounds = []
    orig = PR.ProbeSession.probe_many

    def probe_many(self, ns):
        res = orig(self, ns)
        rounds.append({"candidates": list(ns),
                       "results": {str(n): [res[n][0], res[n][1], res[n][2]] for n in ns}})
        return res

    PR.ProbeSession.probe_many = probe_many
    try:
        with max_cpu_env(max_cpu):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            planner = CapacityPlanner(base, template, pods,
                                      cluster_objects=ResourceTypes(services=services),
                                      device="cuda")
            found, n, hist = planner.search()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
    finally:
        PR.ProbeSession.probe_many = orig
    stats = {k: planner.stats[k] for k in ("path", "probes", "dispatches", "encodes")}
    got = {"found": found, "nodes_added": n, "hist": [list(h) for h in hist], "stats": stats,
           "rounds": json.loads(json.dumps(rounds))}
    for k, v in got.items():
        if v != want[k]:
            fail(f"{kind}: {k} differs from the JAX golden ({v} vs {want[k]})")
    ses = planner.session
    emit("capacity_search", kind=kind, nodes_added=n, rounds=len(rounds),
         lanes=[len(r["candidates"]) for r in rounds], stats=stats,
         encode_s=planner.stats["encode_s"], extensions=ses.extensions,
         device_extensions=ses.device_extensions, uploads=ses.uploads,
         seconds=wall, pods_per_s=len(pods) / wall, launches=counts,
         wave_stats=K.wave_stats(), affinity_stats=K.affinity_stats(), golden="match", card=card)
    return counts, wall, ses


def apply_config(kind: str, card: str) -> dict:
    """Applier.run() on the card on an example config against the JAX
    golden: nodes added, unscheduled and the report with normalized
    fake-node names. Returns the launch counts."""
    import io

    import torch

    from open_simulator_torch.apply.applier import Applier, Options
    from open_simulator_torch.models.workloads import reset_name_counter
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parity import normalize_report

    want = load_golden(kind)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with max_cpu_env(want["max_cpu"]):
            reset_name_counter()
            K.reset_launch_counts()
            applier = Applier(Options(simon_config=want["config"], device="cuda",
                                      extended_resources=list(want["extended_resources"])))
            applier.out = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = applier.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
    finally:
        os.chdir(cwd)
    added = sum(1 for ns in result.node_status
                if "simon/new-node" in (ns.node["metadata"].get("labels") or {}))
    got = {"nodes_added": added, "unscheduled": len(result.unscheduled_pods),
           "report": normalize_report(applier.out.getvalue())}
    for k, v in got.items():
        if v != want[k]:
            fail(f"{kind}: {k} differs from the JAX golden")
    planner = applier.planner
    emit("apply", kind=kind, config=want["config"], nodes_added=added,
         search=planner.stats if planner is not None else "full simulations",
         seconds=wall, launches=counts, golden="match", card=card)
    return counts


# ---------------------------------------------------- the serve and sweep lanes

BENCH_SPEC = "tests/golden/torch_port_sweep_bench.spec.json"
SWEEP_EXAMPLES = ("zone-outage", "monte-carlo-mix", "preemption-storm")
# the kernels line's source and TPU kernel of each serve and sweep fan-out
LANE_ROWS = {"serve_whatif_fanout": ("schedule.cu", ":2383"),
             "serve_wave_fanout": ("wave.cu", ":2412"),
             "sweep_wave_fanout": ("wave.cu", ":2447"),
             "sweep_whatif_fanout": ("schedule.cu", ":2480")}


def bench_image():
    """The resident image of bench.py's sweep base on the card: 960 zoned
    nodes plus the 64 nodepool nodes built drained (1,024 columns), as the
    sweep runner stages it, with the spec's scenarios."""
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_torch.sweep import load_spec
    from open_simulator_torch.sweep.families import build_base, compile_families

    spec = load_spec(os.path.join(REPO, BENCH_SPEC))
    base, bound = build_base(spec)
    comp = compile_families(spec, spec.seed, base)
    img = ResidentImage.try_build(base + comp.pool_nodes, pods=bound, device="cuda")
    img.apply_events([{"type": "node_drain", "name": n["metadata"]["name"]}
                      for n in comp.pool_nodes])
    return img, comp.scenarios


def lane_inputs(img, sessions, activates):
    """([S, N] active rows, [S]-lane carry) of sessions' overlays on the card."""
    import numpy as np
    import torch

    from open_simulator_torch.ops import kernels as K

    rows = [img.lane_overlay(ses, act) for ses, act in zip(sessions, activates)]
    active = torch.from_numpy(np.stack([a for a, _ in rows])).cuda()
    carry = K.Carry(*(torch.from_numpy(np.stack([seeds[k] for _, seeds in rows])).cuda()
                      for k in range(len(K.Carry._fields))))
    return active, carry


def padded(t, S_real: int):
    """Lanes S_real.. repeat lane 0, as the image pads a dispatch to a power of two."""
    t = t.clone()
    t[S_real:] = t[0]
    return t


def serve_sweep_lane_cases(card: str) -> dict:
    """The four serve and sweep fan-outs against their plain versions on the
    card, at S = 8 on bench.py's sweep image (1,024 nodes), the lanes being
    the overlays of eight scenarios of every family (zone outages, drains,
    storms, rollouts, pool activations): every output and every carry field
    of every lane, then lane by lane against the single-lane kernel on the
    lane's masked tables; then one call of five lanes padded to eight.
    Returns the kernels-line rows."""
    import numpy as np
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.encode import bucket_capped
    from open_simulator_torch.sweep.families import build_pod
    from open_simulator_torch.sweep.spec import PodTemplate

    img, scenarios = bench_image()
    # a hostname self-anti-affinity group: a cap1 wave
    anti = [build_pod(f"anti-{i}", PodTemplate(name="anti", replicas=0, cpu="1",
                                               memory="1Gi", anti_affinity_on="anti"))
            for i in range(2)]
    g_anti = img.session(anti).batch[0][0]
    picks = [0, 3, 20, 60, 200, 219, 227, 240]  # baseline, outages, drains, storm, pool, mc
    lanes = [scenarios[i] for i in picks]
    sessions = [img.session(sc.pods, drains=sc.drains) for sc in lanes]
    img.ensure_staged()  # the tables of every group the sessions interned
    sim, tb = img._sim, img._tables
    route = sim._wave_eligibility(g_anti)
    if route.kind != "wave" or not route.cap1:
        fail(f"the anti-affinity group routes {route}, not a cap1 wave")
    active, cry_s = lane_inputs(img, sessions, [sc.activates for sc in lanes])
    seed = K.Carry(*(t[0] for t in cry_s))
    S, N, n_real = 8, int(tb.alloc.shape[0]), sim.na.N
    apps = sorted({g for g, _ in sessions[0].batch})
    rng = np.random.default_rng(6)
    w, filters, nz = sim.score_w, sim.filter_flags, img._bt.n_zones
    emit("lane_image", nodes=N, real_nodes=n_real, lanes=[sc.label for sc in lanes],
         groups=len(sim.encoder.group_list), card=card)
    masked = [K._mask_active(tb, active[s]) for s in range(S)]
    rows = {}

    def compare(name, kernel, plain, reps):
        """Kernel and plain calls of one fan-out: equal outputs and carries,
        the base carry untouched; (kernel ms, plain ms, kernel outputs)."""
        before = [t.clone() for t in cry_s]
        (kc, ko), _ = timed(kernel)
        (pc, po), plain_ms = timed(plain)
        if not torch.equal(ko, po):
            fail(f"{name}: outputs differ from the plain version at {int((ko != po).sum())} places")
        for f in K.Carry._fields:
            if not torch.equal(getattr(kc, f), getattr(pc, f)):
                fail(f"{name}: carry.{f} differs from the plain version")
        if any(not torch.equal(a, b) for a, b in zip(before, cry_s)):
            fail(f"{name}: the input carry was written")
        return cuda_ms(kernel, reps), plain_ms, kc, ko

    def row(name, ms, plain_ms, b, ops, **extra):
        bound, by = bound_of(b, ops)
        emit(name, lanes=S, nodes=N, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bytes=b,
             f32_ops=ops, max_abs_err=0.0, card=card, **extra)
        src, line = LANE_ROWS[name]
        rows[name] = dict(source=SRC + src, replaces=JAX_KERNELS + line, max_abs_err=0.0, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by)

    # ---- sweep_whatif_fanout: 8 pod streams of ~1,000 pods each (rows of
    # each lane's own scenario in batch order)
    lengths = [int(rng.integers(900, 1101)) for _ in range(S)]
    P = bucket_capped(max(lengths), 2048)
    pg = np.zeros((S, P), np.int32)
    fn = np.full((S, P), -1, np.int32)
    vd = np.zeros((S, P), bool)
    for s, L in enumerate(lengths):
        batch = np.asarray(sessions[s].batch, np.int32)
        rows_ = np.sort(rng.choice(len(batch), size=L, replace=False))
        pg[s, :L], fn[s, :L], vd[s, :L] = batch[rows_, 0], batch[rows_, 1], True
    pg, fn, vd = (torch.from_numpy(a).cuda() for a in (pg, fn, vd))
    args = (pg, fn, vd, nz, False, False, w, filters)
    ms, plain_ms, kc, ko = compare(
        "sweep_whatif_fanout", lambda: K.sweep_whatif_fanout(tb, cry_s, active, *args),
        lambda: K.schedule_batch_lanes_plain(tb, cry_s, active, pg, fn, vd, nz, w, filters), 3)
    for s in range(S):
        c1, ch1 = K.schedule_batch_kernel(masked[s], K.carry_lane(cry_s, s), pg[s], fn[s], vd[s],
                                          nz, w, filters)
        if not torch.equal(ch1, ko[s]) or not torch.equal(c1.requested, kc.requested[s]):
            fail(f"sweep_whatif_fanout: lane {s} differs from the single-lane K2")
    costs = [k2_cost(tb, seed, L, P) for L in lengths]
    row("sweep_whatif_fanout", ms, plain_ms, costs[0][0] + sum(c[1] + N for c in costs),
        sum(c[2] for c in costs), pods=lengths, placed=(ko >= 0).sum(dim=1).tolist())

    # ---- serve_whatif_fanout: one union of 8 requests of ~125 pods
    union, spans = [], []
    for s in range(S):
        batch = sessions[s].batch
        take = np.sort(rng.choice(len(batch), size=int(rng.integers(100, 151)), replace=False))
        spans.append((len(union), len(take)))
        union += [batch[i] for i in take]
    P = bucket_capped(len(union), 2048)
    upg = np.zeros(P, np.int32)
    ufn = np.full(P, -1, np.int32)
    upg[:len(union)], ufn[:len(union)] = np.asarray(union, np.int32).T
    valid = np.zeros((S, P), bool)
    for s, (a, n) in enumerate(spans):
        valid[s, a:a + n] = True
    upg, ufn, valid = (torch.from_numpy(a).cuda() for a in (upg, ufn, valid))
    args = (upg, ufn, valid, nz, False, False, w, filters)

    def plain_serve_whatif(cry, act, vd):
        carry, choices = K.schedule_batch_lanes_plain(tb, cry, act, upg, ufn, vd, nz, w, filters)
        return carry, (choices >= 0).sum(dim=1, dtype=torch.int32)

    ms, plain_ms, kc, ko = compare(
        "serve_whatif_fanout", lambda: K.serve_whatif_fanout(tb, cry_s, active, *args),
        lambda: plain_serve_whatif(cry_s, active, valid), 5)
    for s in range(S):
        c1, ch1 = K.schedule_batch_kernel(masked[s], K.carry_lane(cry_s, s), upg, ufn, valid[s],
                                          nz, w, filters)
        if int((ch1 >= 0).sum()) != int(ko[s]) or not torch.equal(c1.requested,
                                                                   kc.requested[s]):
            fail(f"serve_whatif_fanout: lane {s} differs from the single-lane K2")
    costs = [k2_cost(tb, seed, n, P) for _, n in spans]
    row("serve_whatif_fanout", ms, plain_ms, costs[0][0] + sum(c[1] + N for c in costs),
        sum(c[2] for c in costs), union=len(union), placed=ko.tolist())

    def plain_wave(cry, act, g, m, c, **kw):
        """The plain lanes of K3 then K3c, segment by segment ([S, K] inputs)."""
        return K._wave_chain(tb, cry, act, g, m, c, w, filters, kw["block"], kw["kmax"],
                             K.schedule_wave_lanes_plain, K.aggregate_commit_lanes_plain)

    def plain_serve_wave(cry, act, g, m, c, **kw):
        carry, _, placed = plain_wave(cry, act, g[:, None], m[:, None], c[:, None], **kw)
        return carry, placed[:, 0]

    # ---- serve_wave_fanout: 8 different (g, m, cap1), one m = 0, m = 1
    # beside m = 2,000 (the shared block and kmax of the largest m); the row
    # times the whole fan-out, K3 and K3c over lanes (2 launches), against
    # the plain lanes of both and a bound of both
    gs = [apps[0], apps[1], g_anti, apps[3], apps[4], apps[5], g_anti, apps[7]]
    g_s = torch.tensor(gs, dtype=torch.int32).cuda()
    m_s = torch.tensor([2000, 0, 1, 500, 50, 1250, 300, 10], dtype=torch.int32).cuda()
    c_s = torch.tensor([g == g_anti for g in gs]).cuda()
    block = K.wave_block_for(2000, n_real)
    kw = dict(block=block, kmax=K.wave_kmax(2000, n_real, block))
    ms, plain_ms, kc, ko = compare(
        "serve_wave_fanout",
        lambda: K.serve_wave_fanout(tb, cry_s, active, g_s, m_s, c_s, w, filters, **kw),
        lambda: plain_serve_wave(cry_s, active, g_s, m_s, c_s, **kw), 20)
    j_s, p_s, st_s = K.schedule_wave_lanes_kernel(tb, cry_s, active, g_s, m_s, c_s, w, filters,
                                                  **kw)
    if not torch.equal(p_s, ko):
        fail("serve_wave_fanout: K3 over lanes differs from the fan-out")
    for s in range(S):
        j, p, st = K.schedule_wave_kernel(masked[s], K.carry_lane(cry_s, s), gs[s],
                                          int(m_s[s]), bool(c_s[s]), w, filters, **kw)
        if not torch.equal(j, j_s[s]) or int(p) != int(p_s[s]) or not torch.equal(st, st_s[s]):
            fail(f"serve_wave_fanout: lane {s} differs from the single-lane K3")
    if int(ko[1]) != 0 or int(ko[2]) != 1:
        fail(f"serve_wave_fanout: placed {ko.tolist()}: m = 0 or m = 1 lane wrong")
    # K3 over lanes alone, printed beside the row
    k3_ms = cuda_ms(lambda: K.schedule_wave_lanes_kernel(tb, cry_s, active, g_s, m_s, c_s, w,
                                                         filters, **kw), 20)
    costs = [k3_cost(tb, seed, gs[s], block, int(st_s[s, 0])) for s in range(S)]
    c_shared, c_lane, c_ops = k3c_cost(tb, seed)
    row("serve_wave_fanout", ms, plain_ms,
        sum(c[0] for c in costs) + sum(c[1] + N for c in costs) + c_shared + S * c_lane,
        sum(c[2] for c in costs) + S * c_ops, launches_per_call=2, k3_ms=k3_ms,
        placed=ko.tolist(), iterations=st_s[:, 0].tolist())

    # ---- sweep_wave_fanout: K = 4 segments per lane, the last a padding
    # segment (m = 0); the chain as the fan-out runs it: 2K launches
    depth = 4
    g_sk = np.zeros((S, depth), np.int32)
    m_sk = np.zeros((S, depth), np.int32)
    c_sk = np.zeros((S, depth), bool)
    for s in range(S):
        for k in range(depth - 1):
            g = apps[(s + 3 * k) % len(apps)] if (s + k) % 5 else g_anti
            g_sk[s, k], m_sk[s, k], c_sk[s, k] = g, int(rng.integers(100, 1300)), g == g_anti
    block = K.wave_block_for(int(m_sk.max()), n_real)
    kw = dict(block=block, kmax=K.wave_kmax(int(m_sk.max()), n_real, block))
    g_sk, m_sk, c_sk = (torch.from_numpy(a).cuda() for a in (g_sk, m_sk, c_sk))
    ms, plain_ms, kc, ko = compare(
        "sweep_wave_fanout",
        lambda: K.sweep_wave_fanout(tb, cry_s, active, g_sk, m_sk, c_sk, w, filters, **kw),
        lambda: plain_wave(cry_s, active, g_sk, m_sk, c_sk, **kw)[:2], 5)
    for s in range(S):
        lane = K.carry_lane(cry_s, s)
        for k in range(depth):
            j, _, _ = K.schedule_wave_kernel(masked[s], lane, int(g_sk[s, k]), int(m_sk[s, k]),
                                             bool(c_sk[s, k]), w, filters, **kw)
            if not torch.equal(j, ko[s, k]):
                fail(f"sweep_wave_fanout: lane {s} segment {k} differs from the single-lane K3")
            lane = K.aggregate_commit_kernel(masked[s], lane, int(g_sk[s, k]), j)
        if not torch.equal(lane.counter, kc.counter[s]) or not torch.equal(lane.requested,
                                                                           kc.requested[s]):
            fail(f"sweep_wave_fanout: lane {s}'s end carry differs from the single-lane chain")
    if int(ko[:, depth - 1].sum()) != 0:
        fail("sweep_wave_fanout: a padding segment placed pods")
    # one chain's work: per segment, K3 over lanes (its iterations as the
    # kernel counts them in one call) and K3c over lanes
    K.schedule_wave.stats = None
    K.sweep_wave_fanout(tb, cry_s, active, g_sk, m_sk, c_sk, w, filters, **kw)
    iters = K.wave_stats()["iterations"]
    shared3 = sum(group_row_bytes(tb, seed, g)[0] for g in set(g_sk.flatten().tolist()))
    lane3 = sum(group_row_bytes(tb, seed, g)[1] + 5 * N for g in g_sk.flatten().tolist())
    c_shared, c_lane, c_ops = k3c_cost(tb, seed)
    b = shared3 + lane3 + depth * (c_shared + S * c_lane)
    ops = iters * N * ((block + 1) * K3_OPS_PER_ENTRY + K3_OPS_PER_NODE) + depth * S * c_ops
    row("sweep_wave_fanout", ms, plain_ms, b, ops, segments=depth, launches_per_call=2 * depth,
        placed=ko.sum(dim=2).tolist(), iterations=iters)

    # ---- one call of five lanes padded to eight (lanes 5-7 repeat lane 0)
    act5, cry5 = padded(active, 5), K.Carry(*(padded(t, 5) for t in cry_s))
    g5, m5, c5 = padded(g_s, 5), padded(m_s, 5), padded(c_s, 5)
    block = K.wave_block_for(2000, n_real)
    kw = dict(block=block, kmax=K.wave_kmax(2000, n_real, block))
    v5 = padded(valid, 5)
    for name, kernel, plain in (
            ("serve_wave_fanout",
             lambda: K.serve_wave_fanout(tb, cry5, act5, g5, m5, c5, w, filters, **kw),
             lambda: plain_serve_wave(cry5, act5, g5, m5, c5, **kw)),
            ("serve_whatif_fanout",
             lambda: K.serve_whatif_fanout(tb, cry5, act5, upg, ufn, v5, nz, False, False, w,
                                           filters),
             lambda: plain_serve_whatif(cry5, act5, v5))):
        kc, ko = kernel()
        pc, po = plain()
        if not torch.equal(ko, po) or any(not torch.equal(a, b) for a, b in zip(kc, pc)):
            fail(f"{name}: the padded five-lane call differs from its plain version")
        if not torch.equal(ko[5:], ko[:1].expand(3)):
            fail(f"{name}: a padding lane differs from lane 0")
    emit("lanes_padded", lanes=5, padded_to=8, fanouts=["serve_wave_fanout",
                                                        "serve_whatif_fanout"], card=card)
    return rows


def run_cli_sweep(name: str, card: str, extra=()) -> dict:
    """`python -m open_simulator_torch.cli sweep SPEC --parity full --device
    cuda` in this process (so the launch counts are read), its report held
    against the JAX golden: byte for byte for the example specs; for the
    bench spec every byte but the parity block (the golden ran with parity
    off). Returns the launch counts of the run."""
    import contextlib
    import io
    import re

    import torch

    from open_simulator_torch.cli.main import main as cli
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.sweep import report_json

    spec = BENCH_SPEC if name == "bench" else f"examples/sweeps/{name}.yaml"
    out = os.path.join(REPO, "build", "chip_smoke", f"sweep_{name}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    K.reset_launch_counts()
    err = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["sweep", os.path.join(REPO, spec), "--out", out, "--parity", "full",
                  "--device", "cuda", *extra])
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    if rc != 0:
        fail(f"sweep {name}: exit {rc}: {err.getvalue()[-2000:]}")
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(REPO, "tests", "golden", f"torch_port_sweep_{name}.json"), "rb") as f:
        want = f.read()
    report = json.loads(got)
    if name == "bench":
        golden = json.loads(want)
        if report["parity"] != {"mode": "full", "checked": 256, "mismatches": 0}:
            fail(f"sweep bench: parity {report['parity']}")
        report.pop("parity")
        golden.pop("parity")
        if report_json(report) != report_json(golden):
            fail("sweep bench: the report differs from the JAX golden")
    elif got != want:
        fail(f"sweep {name}: the report differs from the JAX golden")
    m = re.search(r"batched ([0-9.]+)s, parity ([0-9.]+)s", err.getvalue())
    n = len(report["scenarios"])
    emit("sweep", spec=name, scenarios=n, pods=sum(r["pods"] for r in report["scenarios"]),
         lanes=report["lanes"], dispatches=report["dispatches"], seconds=wall,
         batched_s=float(m.group(1)), parity_s=float(m.group(2)),
         scenarios_per_s=n / float(m.group(1)), launches={k: v for k, v in counts.items() if v},
         golden="match", card=card)
    return counts


def watch_batches(lines):
    """The resident image's events from kube-watch JSONL lines, one batch
    per BOOKMARK: node ADDED -> node_add, node MODIFIED unschedulable ->
    node_drain, pod ADDED / DELETED -> pod_add / pod_delete."""
    batch = []
    for line in lines:
        ev = json.loads(line)
        typ, obj = ev["type"], ev["object"]
        md = obj.get("metadata") or {}
        if typ == "BOOKMARK":
            yield batch
            batch = []
        elif obj.get("kind") == "Node":
            if typ == "ADDED":
                batch.append({"type": "node_add", "node": obj})
            elif (obj.get("spec") or {}).get("unschedulable"):
                batch.append({"type": "node_drain", "name": md["name"]})
        elif typ == "DELETED":
            batch.append({"type": "pod_delete", "namespace": md.get("namespace", "default"),
                          "name": md["name"]})
        elif typ == "ADDED":
            batch.append({"type": "pod_add", "pod": obj})
    if batch:
        yield batch


def serve_full_width(card: str, n_nodes: int = 10_000, n_events: int = 20_000) -> dict:
    """bench.py's serve shape on the card: a 10,000-node image with 5,000
    bound pods, the 20,000-event watch stream ingested through apply_events,
    then 64 sessions in one dispatch_sessions call (48 uniform-replica
    requests of 50 to 2,000 pods, some with drains: the wave lane; 16 mixed
    requests of ~200 pods: the serial lane over their union), each response
    held against fresh_probe of the same request on the card. Returns the
    launch counts of the ingest and the dispatch."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_torch.utils.synth import synth_pod, synth_watch_stream

    nodes, bound, lines = synth_watch_stream(n_nodes, n_events, seed=11, bookmark_every=64,
                                             n_bound=n_nodes // 2)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    img = ResidentImage.try_build(nodes, pods=bound, device="cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    applied = batches = 0
    for batch in watch_batches(lines):
        applied += img.apply_events(batch)["applied"]
        batches += 1
    ingest_s = time.perf_counter() - t0
    live = [name for name, i in img._sim.na.index.items() if img.active[i]]
    requests = []
    for j in range(48):
        m = 50 + (1950 * j) // 47
        pods = [synth_pod(0, cpu_milli=100 + 25 * (j % 16), labels={"app": f"req-{j}"})
                for _ in range(m)]
        for i, p in enumerate(pods):
            p["metadata"]["name"] = f"req-{j}-{i:05d}"
        drains = tuple(live[(j * 997 + 13 * k) % len(live)] for k in range(3)) if j % 4 == 0 \
            else ()
        requests.append((pods, drains))
    for j in range(16):
        pods = []
        t = 0
        while len(pods) < 200:
            t = (t + 1 + j) % 4
            for _ in range(1 + (len(pods) + j) % 3):
                pods.append(synth_pod(len(pods), cpu_milli=150 + 40 * t,
                                      labels={"app": f"mix-{j}-{t}"}))
        for i, p in enumerate(pods):
            p["metadata"]["name"] = f"mix-{j}-{i:05d}"
        requests.append((pods, ()))
    sessions = [img.session(pods, drains=d) for pods, d in requests]
    route_s = {}
    for attr in ("_dispatch_wave", "_dispatch_serial"):
        def timed_route(*a, fn=getattr(img, attr), attr=attr):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            route_s[attr[len("_dispatch_"):]] = time.perf_counter() - t1
            return out
        setattr(img, attr, timed_route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = img.dispatch_sessions(sessions)
    torch.cuda.synchronize()
    dispatch_s = time.perf_counter() - t0
    counts = K.launch_counts()
    # one wave dispatch (K3 and K3c over lanes) and one serial dispatch (K2)
    if counts["serve_wave_fanout"] != 2 or counts["serve_whatif_fanout"] != 1:
        fail(f"serve: launches {counts}")
    t0 = time.perf_counter()
    for (pods, drains), resp in zip(requests, responses):
        want = img.fresh_probe(pods, drains=drains)
        for k in ("scheduled", "total", "unscheduled", "utilization"):
            if resp[k] != want[k]:
                fail(f"serve: {k} {resp[k]} != fresh_probe {want[k]}")
    oracle_s = time.perf_counter() - t0
    emit("serve", nodes=img._sim.na.N, live_nodes=img.n_nodes, bound=len(bound),
         events=applied, batches=batches, epoch=img.epoch, sessions=len(sessions),
         requested_pods=sum(len(p) for p, _ in requests),
         scheduled=sum(r["scheduled"] for r in responses), build_s=build_s, ingest_s=ingest_s,
         dispatch_s=dispatch_s, route_s=route_s, oracle_s=oracle_s,
         launches={k: v for k, v in counts.items() if v}, fresh_probe="match", card=card)
    return counts


def xray_path(kind: str, nodes, pods, wall_off: float, card: str, storage_classes=()):
    """The flight recorder on the card: `Simulator.schedule_pods` of a
    golden cluster with recording on and every launch count set to 0 just
    before it; the placements against the cluster's golden, the trace
    against the JAX trace's golden, then K7 against plain explain_pod on the
    card for every empty decision set and a seeded sample of 32 others (on
    each set's own segment-start carry, kept by wrapping
    `Simulator._xray_set`). Returns (the kernels-line row, launch counts)."""
    import random

    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.obs import REGISTRY, xray
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parity import xray_trace_digest
    from open_simulator_torch.simulator.engine import Simulator

    sets = []  # per decision set, in set order: (key, tables, start carry, n_zones, flags)
    orig = Simulator._xray_set

    def spy(self, key3, tables, carry_start, bt, flags):
        sets.append((key3, tables, carry_start, bt.n_zones, flags))
        return orig(self, key3, tables, carry_start, bt, flags)

    prefix = os.path.join(REPO, "build", "xray", kind)
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    before = REGISTRY.values()
    Simulator._xray_set = spy
    xray.enable(prefix)
    try:
        K.reset_launch_counts()
        sim = Simulator(nodes, device="cuda")
        sim.register_cluster_objects(ResourceTypes(storage_classes=list(storage_classes)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        failed = sim.schedule_pods(pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        xray.disable()
        Simulator._xray_set = orig
    after = REGISTRY.values()
    got = summarize(sim, pods, failed)
    check_golden(kind, got)
    digest = xray_trace_digest(prefix)
    want = load_golden(f"xray_{kind}")
    for k in ("sets", "empty_sets", "pods", "unscheduled_rows", "set_sha256",
              "set_records_sha256", "pod_rows_sha256"):
        if digest[k] != want[k]:
            bad = ([i for i, (a, b) in enumerate(zip(digest[k], want[k])) if a != b][:8]
                   if k == "set_sha256" else "")
            fail(f"xray {kind}: trace {k} differs from the JAX golden {bad}")
    if counts["explain_jit"] != digest["sets"] or len(sets) != digest["sets"]:
        fail(f"xray {kind}: {counts['explain_jit']} K7 launches for {digest['sets']} sets")
    # K7 against its plain version, bit for bit, on the main path's own inputs
    tr = xray.XrayTrace.load(prefix)
    empty = [i for i in range(len(sets)) if tr.sets[i]["n_feasible"] == 0]
    others = [i for i in range(len(sets)) if tr.sets[i]["n_feasible"] > 0]
    chosen = empty + sorted(random.Random(7).sample(others, min(32, len(others))))
    err = 0.0
    for i in chosen:
        (g, forced, _), tb, cry, nz, (gpu, storage) = sets[i]
        args = (tb, cry, g, forced, True, nz, gpu, storage)
        k = K.explain_kernel(*args)
        p = K.pack_explain(*K.explain_pod(*args))
        if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
            bad = sorted({K.EXPLAIN_ROWS[r] for r in
                           (k.view(torch.int32) != p.view(torch.int32)).any(1).nonzero()
                           .flatten().tolist()})
            fail(f"xray {kind}: K7 differs from explain_pod on set {i} (group {g}), rows {bad}")
        err = max(err, err_of(k, p))
    (g, forced, _), tb, cry, nz, (gpu, storage) = sets[0]
    args = (tb, cry, g, forced, True, nz, gpu, storage)
    ms = cuda_ms(lambda: K.explain_kernel(*args), 50)
    plain_ms = cuda_ms(lambda: K.explain_pod(*args), 5)
    b, ops = k7_cost(tb, cry, g, gpu or storage)
    bound, by = bound_of(b, ops)

    def seconds(name):
        return after.get(name + "_sum", 0.0) - before.get(name + "_sum", 0.0)

    emit("xray", kind=kind, nodes=len(nodes), pods=len(pods), sets=digest["sets"],
         empty_sets=digest["empty_sets"], checked_sets=len(chosen),
         unscheduled=got["unscheduled"], launches=counts["explain_jit"], k7_ms=ms,
         k7_plain_ms=plain_ms, k7_bound_ms=bound, k7_bytes=b, k7_f32_ops=ops,
         ext=bool(gpu or storage), max_abs_err=err, recording_on_s=wall,
         recording_off_s=wall_off, encode_s=seconds("simon_encode_seconds"),
         host_commit_s=seconds("simon_host_commit_seconds"), golden="match", card=card)
    return (dict(source=SRC + "explain.cu", replaces=JAX_KERNELS + ":751", max_abs_err=err,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None),
            counts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import build
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import (synth_affinity_cluster, synth_cluster,
                                                  synth_extended_cluster, synth_spread_cluster)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    card = smi()
    emit("device", name=device_name, count=torch.cuda.device_count(), smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build: one nvcc per source, started together, then the link
    t0 = time.perf_counter()
    lib_path = build.compile_library()
    build.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=build.build_seconds,
         library=os.path.relpath(lib_path, REPO),
         ptxas=[ln for ln in build.ptxas_log.splitlines() if "registers" in ln or "spill" in ln])
    # the scheduling signature's path: the native raw-subtree hash (built with
    # the host's C++ compiler) or, where it cannot be, the computed tuple
    from open_simulator_torch import native
    emit("signature", path=native.backend())
    rows = {}  # kernel name -> kernels-line fields measured below

    # ---- the 5,000-node / 2,500-pod batch, on the card
    nodes, pods = synth_cluster(5000, 2500, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    P = len(pods)
    pad = bt.pod_group.shape[0]
    pg = torch.from_numpy(bt.pod_group).cuda()
    fn = torch.from_numpy(bt.forced_node).cuda()
    vd = torch.from_numpy(bt.valid).cuda()
    kinds = sorted({int(g) for g in bt.pod_group[:P]})

    # ---- schedule_batch: K2 against its plain version, full width
    torch.cuda.synchronize()
    end_k, ch_k = K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones)
    (end_p, ch_p), plain_ms_k2 = timed(lambda: K.schedule_batch_plain(tb, seed, pg, fn, vd,
                                                                      bt.n_zones))
    err_k2 = 0.0
    if not torch.equal(ch_k, ch_p):
        fail(f"schedule_batch choices differ at {int((ch_k != ch_p).sum())} pods")
    for f in ("requested", "nonzero", "port_used", "counter", "carrier"):
        a, b = getattr(end_k, f), getattr(end_p, f)
        if not torch.equal(a, b):
            fail(f"schedule_batch carry.{f} differs")
        err_k2 = max(err_k2, err_of(a, b))
    k2_ms = cuda_ms(lambda: K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones), 3)
    k2_b, k2_ops = one_lane(k2_cost(tb, seed, P, pad))
    k2_bound, k2_by = bound_of(k2_b, k2_ops)
    emit("schedule_batch", nodes=int(tb.alloc.shape[0]), pods=P, padded=pad, groups=len(kinds),
         placed=int((ch_k >= 0).sum()), kernel_ms=k2_ms, plain_ms=plain_ms_k2,
         bound_ms=k2_bound, bytes=k2_b, f32_ops=k2_ops, max_abs_err=err_k2, card=card)
    rows["schedule_batch"] = dict(source=SRC + "schedule.cu", replaces=JAX_KERNELS + ":2267",
                                  max_abs_err=err_k2, ms=k2_ms, plain_ms=plain_ms_k2,
                                  bound_ms=k2_bound, bound_by=k2_by)

    # ---- feasibility: K1 against its plain version, every group, seed and
    # end carry, with and without the DoNotSchedule filter
    checked = 0
    for label, cry in (("seed", seed), ("end", end_k)):
        for g in kinds:
            for forced, dns in ((-1, True), (g % int(tb.alloc.shape[0]), True), (-1, False)):
                f_k, s_k = K.feasibility_kernel(tb, cry, g, forced, True, include_dns=dns)
                f_p, s_p = K.feasibility(tb, cry, g, forced, True, include_dns=dns)
                if not torch.equal(f_k, f_p):
                    fail(f"feasibility mask differs (group {g}, forced {forced}, {label} carry)")
                for k in K.STAGE_KEYS:
                    if not torch.equal(s_k[k], s_p[k]):
                        fail(f"feasibility stage {k} differs (group {g}, {label} carry)")
                checked += 1
    g0 = kinds[0]
    k1_ms = cuda_ms(lambda: K.feasibility_kernel(tb, end_k, g0, -1, True), 200)
    k1_plain_ms = cuda_ms(lambda: K.feasibility(tb, end_k, g0, -1, True), 50)
    k1_b = k1_bytes(tb, end_k, g0)
    k1_bound = k1_b / HBM_BYTES_PER_S * 1e3
    emit("feasibility", cases=checked, groups=len(kinds), kernel_ms=k1_ms,
         plain_ms=k1_plain_ms, bound_ms=k1_bound, bytes=k1_b, max_abs_err=0.0, card=card)
    rows["feasibility"] = dict(source=SRC + "schedule.cu", replaces=JAX_KERNELS + ":743",
                               max_abs_err=0.0, ms=k1_ms, plain_ms=k1_plain_ms,
                               bound_ms=k1_bound, bound_by="bytes")

    # ---- schedule_wave + aggregate_commit: K3 and K3c against their plain
    # versions on the 10,000-node / 100,000-pod wave and on a cap1 segment of
    # the 5,000-node hard shape, at the engine's block and kmax
    def wave_case(label, sim, pods, pick):
        """K3 and K3c against their plain versions on one wave segment (with
        the segment's gpu_live: the GPU filter, the units clamp and the
        device-ledger replay); returns the two kernels-line rows."""
        bt = sim.encode_batch(pods)
        tb, seed = sim._to_device(bt)
        seg = pick(sim._segments(bt, len(pods)))
        _, _, m, g, cap1, gpu_live = seg
        N = sim.na.N
        block = K.wave_block_for(m, N)
        kmax = K.wave_kmax(m, N, block)
        kw = dict(block=block, kmax=kmax, gpu_live=gpu_live)
        (kj, kp, kst), _ = timed(lambda: K.schedule_wave_kernel(tb, seed, g, m, cap1, **kw))
        (pj, pp, pst), plain_ms = timed(lambda: K.schedule_wave_plain(tb, seed, g, m, cap1, **kw))
        if not torch.equal(kj, pj) or int(kp) != pp:
            fail(f"schedule_wave {label}: counts differ at {int((kj != pj).sum())} nodes")
        if kst.tolist() != [pst[k] for k in K.WAVE_STATS]:
            fail(f"schedule_wave {label}: loop statistics {kst.tolist()} vs {pst}")
        kc = K.aggregate_commit_kernel(tb, seed, g, kj, gpu_live)
        pc, c_plain_ms = timed(lambda: K.aggregate_commit_plain(tb, seed, g, pj, gpu_live))
        c_err = 0.0
        for f in K.Carry._fields:
            if not torch.equal(getattr(kc, f), getattr(pc, f)):
                fail(f"aggregate_commit {label}: carry.{f} differs")
            c_err = max(c_err, err_of(getattr(kc, f), getattr(pc, f)))
        ms = cuda_ms(lambda: K.schedule_wave_kernel(tb, seed, g, m, cap1, **kw), 3)
        c_ms = cuda_ms(lambda: K.aggregate_commit_kernel(tb, seed, g, kj, gpu_live), 20)
        b, ops = one_lane(k3_cost(tb, seed, g, block, pst["iterations"]))
        cb, cops = one_lane(k3c_cost(tb, seed))
        if gpu_live:
            # K3: dev_total and dev_used read once, the units 6 per device and
            # 2 per node; K3c: dev_total read, dev_used read and written, 8
            # operations per copy and device
            M = int(tb.dev_total.shape[1])
            b += nbytes(tb.dev_total, seed.dev_used)
            ops += int(tb.alloc.shape[0]) * (6 * M + 2)
            cb += 3 * nbytes(tb.dev_total)
            cops += int(kj.sum()) * M * 8
        bound, by = bound_of(b, ops)
        c_bound, c_by = bound_of(cb, cops)
        emit("schedule_wave", case=label, nodes=int(tb.alloc.shape[0]), pods=m, cap1=bool(cap1),
             gpu_live=bool(gpu_live), block=block, kmax=kmax, placed=pp, **pst, kernel_ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bytes=b, f32_ops=ops,
             max_abs_err=err_of(kj, pj), card=card)
        emit("aggregate_commit", case=label, gpu_live=bool(gpu_live), copies=int(kj.sum()),
             kernel_ms=c_ms, plain_ms=c_plain_ms, bound_ms=c_bound, bytes=cb, f32_ops=cops,
             max_abs_err=c_err, card=card)
        return (dict(max_abs_err=err_of(kj, pj), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                     bound_by=by),
                dict(max_abs_err=c_err, ms=c_ms, plain_ms=c_plain_ms, bound_ms=c_bound,
                     bound_by=c_by))

    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    wave_case("hard_cap1", Simulator(nodes, device="cuda"), pods,
              lambda segs: next(s for s in segs if s[0] == "wave" and s[4]))
    nodes, pods = synth_cluster(10000, 100000)
    w_row, c_row = wave_case("northstar", Simulator(nodes, device="cuda"), pods,
                             lambda segs: next(s for s in segs if s[0] == "wave"))
    rows["schedule_wave"] = dict(source=SRC + "wave.cu", replaces=JAX_KERNELS + ":1113", **w_row)
    rows["aggregate_commit"] = dict(source=SRC + "wave.cu", replaces=JAX_KERNELS + ":976",
                                    **c_row)

    # ---- schedule_group_serial: K4 against its plain version on full-width
    # segments of the spread workload, one of each spread flag (500 pods each)
    nodes, pods, services = synth_spread_cluster(5000, 20000)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    firsts = {}
    for s in sim._segments(bt, len(pods)):
        if s[0] == "spread":
            firsts.setdefault((s[5], s[6]), s)
    k4 = None
    for (ss_live, sa_live), (_, _, m, g, cap1, _, _) in sorted(firsts.items()):
        valid = torch.ones(m, dtype=torch.bool, device="cuda")
        nz = bt.n_zones if ss_live else 2
        (kj, kp), _ = timed(lambda: K.schedule_group_serial_kernel(
            tb, seed, g, valid, cap1, ss_live=ss_live, sa_live=sa_live, n_zones=nz))
        (pj, pp), plain_ms = timed(lambda: K.schedule_group_serial_plain(
            tb, seed, g, valid, cap1, ss_live=ss_live, sa_live=sa_live, n_zones=nz))
        if not torch.equal(kj, pj) or int(kp) != pp:
            fail(f"schedule_group_serial (ss_live={ss_live}, sa_live={sa_live}): counts differ")
        ms = cuda_ms(lambda: K.schedule_group_serial_kernel(
            tb, seed, g, valid, cap1, ss_live=ss_live, sa_live=sa_live, n_zones=nz), 3)
        b, ops = one_lane(k4_cost(tb, seed, g, m))
        bound, by = bound_of(b, ops)
        emit("schedule_group_serial", nodes=int(tb.alloc.shape[0]), pods=m, ss_live=ss_live,
             sa_live=sa_live, placed=pp, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
             bytes=b, f32_ops=ops, max_abs_err=err_of(kj, pj), card=card)
        if sa_live:  # the kernels line reports the ScheduleAnyway segment
            k4 = dict(max_abs_err=err_of(kj, pj), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by=by)
    if set(firsts) != {(True, False), (False, True), (False, False)}:
        fail(f"spread workload: segment flags {sorted(firsts)}")
    rows["schedule_group_serial"] = dict(source=SRC + "group_serial.cu",
                                         replaces=JAX_KERNELS + ":2104", **k4)

    # ---- schedule_affinity_wave: K5 against its plain version (counts,
    # placed, epoch statistics, then K3c's carry) on three full-width
    # segments: a 1,000-pod zone spread of the hard shape (one epoch of many
    # rounds), the hostname spread of the affinity cluster (D+1 8,193) and a
    # 500-pod Service-backed segment (one head-fallback epoch per pod)
    def affinity_case(label, sim, pods, pick):
        bt = sim.encode_batch(pods)
        tb, seed = sim._to_device(bt)
        _, _, m, g, cap1, ss_live = pick(sim._segments(bt, len(pods)))
        block = K.wave_block_for(m, sim.na.N)
        nz = bt.n_zones if ss_live else 2
        kw = dict(ss_live=ss_live, block=block, n_zones=nz)
        (kj, kp, kst), _ = timed(lambda: K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1,
                                                                         **kw))
        (pj, pp, pst), plain_ms = timed(lambda: K.schedule_affinity_wave_plain(tb, seed, g, m,
                                                                               cap1, **kw))
        if not torch.equal(kj, pj) or int(kp) != pp:
            fail(f"schedule_affinity_wave {label}: counts differ at {int((kj != pj).sum())} "
                 f"nodes (placed {int(kp)} vs {pp})")
        if kst.tolist() != [pst[k] for k in K.AFFINITY_STATS]:
            fail(f"schedule_affinity_wave {label}: epoch statistics {kst.tolist()} vs {pst}")
        kc = K.aggregate_commit_kernel(tb, seed, g, kj)
        pc = K.aggregate_commit_plain(tb, seed, g, pj)
        for f in K.Carry._fields:
            if not torch.equal(getattr(kc, f), getattr(pc, f)):
                fail(f"aggregate_commit after schedule_affinity_wave {label}: carry.{f} differs")
        ms = cuda_ms(lambda: K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1, **kw), 3)
        b, ops = one_lane(k5_cost(tb, seed, g, block, pst))
        bound, by = bound_of(b, ops)
        emit("schedule_affinity_wave", case=label, nodes=int(tb.alloc.shape[0]), pods=m,
             domains=int(seed.counter.shape[1]), ss_live=bool(ss_live), cap1=bool(cap1),
             block=block, placed=pp, **pst, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
             bytes=b, f32_ops=ops, max_abs_err=err_of(kj, pj), card=card)
        return dict(max_abs_err=err_of(kj, pj), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by)

    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    k5 = affinity_case("hard_zone_spread", Simulator(nodes, device="cuda"), pods,
                       lambda segs: next(s for s in segs if s[0] == "affinity"))
    nodes, pods, services = synth_affinity_cluster(5000, 20000)
    sim = Simulator(nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(services=services))
    # the second block of each cycle is the hostname spread
    affinity_case("hostname_spread", sim, pods, lambda segs: segs[1])
    affinity_case("service_zoned", sim, pods, lambda segs: next(s for s in segs
                                                                if s[0] == "affinity" and s[5]))
    rows["schedule_affinity_wave"] = dict(source=SRC + "affinity_wave.cu",
                                          replaces=JAX_KERNELS + ":1311", **k5)

    # ---- the GPU-share and Open-Local branches: K2 and K1 with both on
    # against their plain versions on a 2,500-pod serial slice of the
    # 2,000-node extended cluster (choices, every carry field with the device
    # and storage ledgers; every stage), then K3 + K3c with gpu_live on one
    # 1-GPU and one 2-GPU wave segment of the whole workload
    ext_nodes, ext_pods, _, ext_scs = synth_extended_cluster(2000, 20000)
    sim = Simulator(ext_nodes, device="cuda")
    sim.register_cluster_objects(ResourceTypes(storage_classes=ext_scs))
    bt = sim.encode_batch(ext_pods[:2500])
    tb, seed = sim._to_device(bt)
    P = 2500
    pad = bt.pod_group.shape[0]
    pg, fn, vd = (torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid))
    flags = dict(enable_gpu=True, enable_storage=True)
    end_k, ch_k = K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones, **flags)
    (end_p, ch_p), plain_ms = timed(lambda: K.schedule_batch_plain(tb, seed, pg, fn, vd,
                                                                   bt.n_zones, **flags))
    if not torch.equal(ch_k, ch_p):
        fail(f"schedule_batch (gpu, storage): choices differ at {int((ch_k != ch_p).sum())} pods")
    err = 0.0
    for f in K.Carry._fields:
        if not torch.equal(getattr(end_k, f), getattr(end_p, f)):
            fail(f"schedule_batch (gpu, storage): carry.{f} differs")
        err = max(err, err_of(getattr(end_k, f), getattr(end_p, f)))
    ms = cuda_ms(lambda: K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones, **flags), 3)
    b, ops = one_lane(k2_cost(tb, seed, P, pad))
    N = int(tb.alloc.shape[0])
    ops += N * sum(gpu_storage_ops(tb, int(g)) for g in bt.pod_group[:P])
    b += gpu_storage_bytes(tb, seed) + nbytes(seed.dev_used, seed.vg_req, seed.sdev_alloc)
    bound, by = bound_of(b, ops)
    emit("schedule_batch_gpu_storage", nodes=N, pods=P, padded=pad,
         placed=int((ch_k >= 0).sum()), kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
         bytes=b, f32_ops=ops, max_abs_err=err, card=card)
    rows["schedule_batch/gpu_storage"] = dict(
        source=SRC + "schedule.cu", replaces=JAX_KERNELS + ":2265", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    kinds = sorted({int(g) for g in bt.pod_group[:P]})
    checked = 0
    for label, cry in (("seed", seed), ("end", end_k)):
        for g in kinds:
            f_k, s_k = K.feasibility_kernel(tb, cry, g, -1, True, **flags)
            f_p, s_p = K.feasibility(tb, cry, g, -1, True, **flags)
            if not torch.equal(f_k, f_p):
                fail(f"feasibility (gpu, storage) mask differs (group {g}, {label} carry)")
            for k in K.STAGE_KEYS:
                if not torch.equal(s_k[k], s_p[k]):
                    fail(f"feasibility (gpu, storage) stage {k} differs (group {g}, {label})")
            checked += 1
    # time K1 on a group with LVM and device volumes, against the end carry
    g_st = next(g for g in kinds if bool((tb.grp_lvm_size[g] > 0).any()))
    ms = cuda_ms(lambda: K.feasibility_kernel(tb, end_k, g_st, -1, True, **flags), 200)
    plain_ms = cuda_ms(lambda: K.feasibility(tb, end_k, g_st, -1, True, **flags), 20)
    b = k1_bytes(tb, end_k, g_st) + gpu_storage_bytes(tb, end_k)
    bound, by = bound_of(b, N * gpu_storage_ops(tb, g_st))
    emit("feasibility_gpu_storage", cases=checked, groups=len(kinds), kernel_ms=ms,
         plain_ms=plain_ms, bound_ms=bound, bytes=b, max_abs_err=0.0, card=card)
    rows["feasibility/gpu_storage"] = dict(
        source=SRC + "schedule.cu", replaces=JAX_KERNELS + ":743", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by)

    def gpu_wave(units):
        """The first shared-GPU wave segment asking for `units` GPUs."""
        def pick(segs):
            got = next((s for s in segs if s[0] == "wave" and s[5]
                        and int(sim.encoder.group_list[s[3]].gpu_num) == units), None)
            if got is None:
                fail(f"extended workload: no {units}-GPU wave segment")
            return got
        return pick

    for units in (1, 2):
        w_row, c_row = wave_case(f"extended_{units}gpu", sim, ext_pods, gpu_wave(units))
        if units == 1:  # the kernels line reports the one-GPU segment
            rows["schedule_wave/gpu_live"] = dict(source=SRC + "wave.cu",
                                                  replaces=JAX_KERNELS + ":963", **w_row)
            rows["aggregate_commit/gpu_live"] = dict(source=SRC + "wave.cu",
                                                     replaces=JAX_KERNELS + ":1007", **c_row)

    # ---- the capacity probe's kernels: K2-K5 over lanes (then K3c over
    # lanes) on the capacity_lanes session at S = 8 with the masks of the
    # search's first round of eight, one segment of each kind, and K6
    ses, active, cands = lanes_session("capacity_lanes", 8)
    emit("lanes_session", candidates=cands, nodes=int(ses._n_pad), segments=len(ses._segs),
         card=card)
    for kind in ("serial", "wave", "spread", "affinity"):
        seg = next(sg for sg in ses._segs if sg[0] == kind)
        rows[FANOUT_KERNELS[kind]], commit_row = lane_case(ses, seg, active, card)
        if kind == "wave":  # the kernels line reports K3c over lanes on the wave
            rows["aggregate_commit_lanes"] = commit_row
    del ses, active
    rows["extend_tables"] = extend_case(card)
    # ---- the serve and sweep fan-outs: K2, K3 and K3c over lanes with
    # per-lane inputs, on bench.py's sweep image
    rows.update(serve_sweep_lane_cases(card))

    # ---- the main path: Simulator.schedule_pods against the JAX goldens,
    # each run with every launch count set to 0 just before it
    launches = Counter()
    walls = {}

    def main_path(kind, nodes, pods, services=(), serial=False, storage_classes=()):
        K.reset_launch_counts()
        sim = Simulator(nodes, device="cuda")
        sim.use_waves = not serial
        sim.register_cluster_objects(ResourceTypes(services=list(services),
                                                   storage_classes=list(storage_classes)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        failed = sim.schedule_pods(pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        stats = K.wave_stats()
        aff_stats = K.affinity_stats()
        launches.update(counts)
        got = summarize(sim, pods, failed)
        if got["placed"] + got["unscheduled"] != len(pods):
            fail(f"{kind}: a pod was neither placed nor reported")
        check_golden(kind, got)
        walls[kind] = wall
        census = {k: {"segments": v[0], "pods": v[1], "kernels": SEGMENT_KERNELS[k]}
                  for k, v in sorted(sim.segment_census.items())}
        emit("simulate", kind=kind, route="serial" if serial else "default", pods=len(pods),
             nodes=len(nodes), placed=got["placed"], unscheduled=got["unscheduled"],
             reasons=len(got["reason_census"]), choices_sha256=got["choices_sha256"],
             seconds=wall, pods_per_s=len(pods) / wall, launches=counts, wave_stats=stats,
             affinity_stats=aff_stats, census=census, golden="match", card=card)
        return counts

    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    main_path("hard", nodes, pods, serial=True)
    nodes, pods = synth_cluster(100, 30000, hard_predicates=True)
    if main_path("overflow", nodes, pods, serial=True)["feasibility"] <= 0:
        fail("overflow: the feasibility kernel never launched")
    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    main_path("hard_waves", nodes, pods)
    nodes, pods = synth_cluster(100, 30000, hard_predicates=True)
    main_path("overflow_waves", nodes, pods)
    nodes, pods = synth_cluster(10000, 100000)
    main_path("northstar", nodes, pods)
    nodes, pods, services = synth_spread_cluster(5000, 20000)
    main_path("spread", nodes, pods, services)
    nodes, pods, services = synth_affinity_cluster(5000, 20000)
    main_path("affinity", nodes, pods, services)
    for kind, serial in (("extended", False), ("extended_serial", True)):
        nodes, pods, _, scs = synth_extended_cluster(2000, 20000)
        main_path(kind, nodes, pods, serial=serial, storage_classes=scs)
    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    rows["explain_jit"], counts = xray_path("hard_waves", nodes, pods, walls["hard_waves"], card)
    launches.update(counts)
    nodes, pods, _, scs = synth_extended_cluster(2000, 20000)
    launches.update(xray_path("extended", nodes, pods, walls["extended"], card,
                              storage_classes=scs)[1])
    launches.update(demo1(card))
    launches.update(gpushare_example(card))
    # the capacity planner: both searches, then apply on the example configs
    for kind in ("capacity", "capacity_lanes"):
        counts, wall, ses = capacity_search(kind, card)
        launches.update(counts)
        walls[f"search_{kind}"] = wall
        if kind == "capacity" and (ses.device_extensions < 1 or counts["extend_tables"] < 1):
            fail("capacity: the tables did not grow on the device")
    for kind in ("apply_smoke", "apply_gpushare", "apply_demo1"):
        launches.update(apply_config(kind, card))
    # scenario sweeps through the CLI entry point (parity full on the card)
    # against the JAX reports, then the resident image at full width
    for spec in SWEEP_EXAMPLES:
        launches.update(run_cli_sweep(spec, card))
    launches.update(run_cli_sweep("bench", card, ("--fanout", "32")))
    launches.update(serve_full_width(card))
    for k in rows:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms")}
        for k, r in rows.items()]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1), walls=walls)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
