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
  with its device ids pinned.

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


def group_row_bytes(tb, cry, g: int) -> int:
    """Bytes of the tables one group's step reads once: its [N] rows (static
    masks, raw scores), alloc, requested and nonzero, and the domain maps and
    counter rows of its valid slots."""
    N, R = tb.alloc.shape
    D1 = cry.counter.shape[1]
    b = 5 * N + 6 * 4 * N + 2 * 4 * N * R + 4 * N * 2
    for ids in (tb.req_aff_t[g], tb.req_anti_t[g], tb.dns_t[g], tb.carr_anti_t[g],
                tb.pref_t[g], tb.sa_t[g]):
        b += int((ids >= 0).sum()) * (4 * N + 4 * D1)
    return b + int((tb.dns_t[g] >= 0).sum()) * D1 + int((tb.grp_ports[g] > 0).sum()) * N


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
    """(bytes, f32 operations) the serial scan must spend: tables, carry in
    and out, pod arrays and choices each moved once; per valid pod and node,
    the f32 operations of one step as counted from csrc/schedule.cu (filters:
    4 per resource and 2 per slot; least/balanced 16; raw terms 3 per
    weighted slot; normalizers and selector spread 30; the total 22)."""
    import torch

    tables = [t for t in tb if isinstance(t, torch.Tensor)]
    carry = [cry.requested, cry.nonzero, cry.port_used, cry.counter, cry.carrier]
    b = nbytes(*tables) + 2 * nbytes(*carry) + P * (4 + 4 + 1 + 4)
    N, R = tb.alloc.shape
    slots = sum(t.shape[1] for t in (tb.req_aff_t, tb.req_anti_t, tb.carr_anti_t, tb.dns_t))
    per_node = 4 * R + 2 * slots + 16 + 3 * (tb.pref_t.shape[1] + tb.carr_w_t.shape[1]) + 30 + 22
    return b, n_valid * N * per_node


# f32 operations of one [N, B+1] table entry of K3 (csrc/wave.cu): the copy
# count 1, usage 4, least/balanced 16, the weighted sum 4, the monotone test 1
K3_OPS_PER_ENTRY = 26
# f32 operations of one K3 iteration per node besides its table row:
# normalizers 6, the normalized static terms 16, the guard 2, the end
# normalizers 6
K3_OPS_PER_NODE = 30


def k3_cost(tb, cry, g: int, block: int, iterations: int) -> tuple:
    """(bytes, f32 operations) of one wave: the group's rows read once and the
    [N] counts written once; per iteration, the table's entries and the
    per-node passes (the radix passes are integer work and not counted)."""
    N = tb.alloc.shape[0]
    ops = iterations * N * ((block + 1) * K3_OPS_PER_ENTRY + K3_OPS_PER_NODE)
    return group_row_bytes(tb, cry, g) + 4 * N, ops


def k3c_cost(tb, cry) -> tuple:
    """(bytes, f32 operations) of one aggregate commit: the carry's requested,
    nonzero, counter and carrier read and written once, the [U, N] domain
    maps and the counts read once; one multiply and one add per element."""
    N, R = tb.alloc.shape
    D1 = cry.counter.shape[1]
    rows = N * R + 2 * N + (cry.counter.shape[0] + cry.carrier.shape[0]) * D1
    return 2 * 4 * rows + nbytes(tb.topo_dom) + 4 * N, 2 * rows + tb.topo_dom.numel()


# f32 operations of one K4 step per node (csrc/group_serial.cu): the live
# DoNotSchedule test 4 per term, least/balanced 20, the normalized terms 16,
# the score 12, SelectorSpread 14, ScheduleAnyway 5 per term and 6
def k4_cost(tb, cry, g: int, n_valid: int) -> tuple:
    N = tb.alloc.shape[0]
    per_node = (4 * int((tb.dns_t[g] >= 0).sum()) + 20 + 16 + 12 + 14
                + 5 * int((tb.sa_t[g] >= 0).sum()) + 6)
    return group_row_bytes(tb, cry, g) + 4 * N, n_valid * N * per_node


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
    """(bytes, f32 operations) of one affinity wave: the group's rows and its
    live [slots, D+1] rows read once and the [N] counts written once; per
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
    return group_row_bytes(tb, cry, g) + 4 * slots * D1 + 4 * N, ops


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
    name = torch.cuda.get_device_name(0)
    card = smi()
    emit("device", name=name, count=torch.cuda.device_count(), smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build: one nvcc per source, started together, then the link
    t0 = time.perf_counter()
    lib_path = build.compile_library()
    build.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=build.build_seconds,
         library=os.path.relpath(lib_path, REPO),
         ptxas=[ln for ln in build.ptxas_log.splitlines() if "registers" in ln or "spill" in ln])
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
    k2_b, k2_ops = k2_cost(tb, seed, P, pad)
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
        b, ops = k3_cost(tb, seed, g, block, pst["iterations"])
        cb, cops = k3c_cost(tb, seed)
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
        b, ops = k4_cost(tb, seed, g, m)
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
        b, ops = k5_cost(tb, seed, g, block, pst)
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
    b, ops = k2_cost(tb, seed, P, pad)
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
    launches.update(demo1(card))
    launches.update(gpushare_example(card))
    for k in rows:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": None}
        for k, r in rows.items()]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1), walls=walls)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
