"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of open_simulator_torch/ops/csrc from this checkout,
times one fused cluster round of K2 / K4 at each cluster size (a run of
empty pod steps: the latency floor of their pod steps), holds each kernel
against its plain PyTorch version on the card (exact equality: every output
is a bool, an i32 or an f32 count; K2 also at 10,000 nodes; every K2 / K4
line with its cluster shape, µs a pod and rounds and cluster barriers a
pod), then drives the port's main path,
`Simulator.schedule_pods`, and holds each run against the goldens the JAX
package computed (tests/golden/torch_port_*.json):

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
  32, its parity pass on a seeded sample of 64 lanes: `--parity sample`)
  against the JAX report but for its parity block; then the resident
  image at full width: bench.py's serve shape (10,000 nodes, 5,000 bound
  pods, a 20,000-event watch stream ingested through `apply_events`) and 64
  what-if sessions in one `dispatch_sessions` call, every response against
  `fresh_probe`'s answer on the card (`oracle_answers`). Before them, the four serve and sweep fan-outs
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
  (`explain_jit`, one thread-block cluster over the nodes; the phase line
  shows its shape) runs once per decision set; before that phase line, K7 is
  held against the plain `explain_pod` on the card for every set without a
  feasible node and a seeded sample of 32 others. The phase prints the
  recording-on and -off walls and the encode and host-commit seconds the
  metric catalog measured.
- preemption (`preempt_phase`): the DefaultPreemption PostFilter at full
  width, three `Simulator.schedule_pods` calls of rising priority on the
  1,000 nodes of `synth_cluster(1000, ·, hard_predicates=True)`
  (`preempt_workload`: 2,000 batch pods under a PDB, 1,000 service pods,
  40 production pods in four specs, one with preemptionPolicy Never),
  every fit of the PostFilter required to be exactly one K1 launch, against
  the JAX golden (tests/golden/torch_port_preempt.json: summarize()'s
  digest, the `preempted` records' sha256, every failed pod's
  nominatedNodeName, the preemption counters' deltas); K1 is then held
  against its plain version on the first fit's tables and carry and on
  one fit's after an eviction (N 1,024, C 2). Two sampled runs then time
  a fit's host split on `_fits`' own callees and K1's device time on the
  fits (under torch.profiler; CUDA events where it traces no K1 launch). Then `sched_hard_waves`: `hard_waves` under the
  KubeSchedulerConfiguration of
  tests/golden/torch_port_sched_hard_waves.sched.yaml (custom score
  weights, NodePorts and TaintToleration disabled) against its golden, and
  (`sched_kernels`) K2, K1, K7 and K4, which that run does not reach, under
  the same configuration at full width against their plain versions.
- the node mesh (`parallel/`), every run on the partitioned default route
  (each rank stages and holds only its block of the node axis): first the
  port's unsharded runs of bench.py's `mesh8_1m` cluster (100,000 nodes,
  1,000,000 pods, in one chunk as bench.py's store form streams it:
  OPEN_SIMULATOR_STREAM_PODS=2097152) and of `spread`'s first 2,000 pods
  on the card; then two ranks spawned after the build share cuda:0 over
  gloo (NCCL refuses two ranks on one card; the collectives stage CUDA
  tensors through pinned host memory) and run `extended` (N 2,048 at the
  default epoch limit: K8 with the GPU-share branch, its 10,025 serial pods
  on K12 with EXT, K1 on the block for its 6,109 failures), `affinity` (N
  5,120, OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES=8192: K9), `affinity`
  again at the default limit (the affinity wave's sharded tail, K11),
  `overflow_waves` (N 128: K8, K9, and K1 on the block for 4,400
  failures), `spread`'s first 2,000 pods (K13 on its ScheduleAnyway,
  SelectorSpread and DoNotSchedule segments, K10 on its wave), `northstar`
  (N 10,240 at the default limit: the wave's per-round path, K10) and
  `mesh8_1m` (K10, one chunk) through `Simulator(use_mesh=True)` against
  their goldens on both ranks (`mesh8_1m` and the spread prefix against
  the unsharded runs: digest, counts, reasons), every counted segment
  committed by K14. Each run's collectives must equal its formula
  (`expected_calls`: one `pmax` and one all-gather per epoch on K8 / K9,
  two `pmax` and two `all_gather_rows` per round on K10, two to four
  collectives per epoch by branch on K11, two `all_gather_rows` per serial
  or group-serial pod and a `pmax` per such pod with ScheduleAnyway
  terms, one `all_gather_rows` per commit, one tiled gather per fetch and
  per failure diagnosis), no unsharded kernel may launch, and each rank
  must hold 50% ± 5% of the node-axis table and carry bytes. Then K8 and
  K9 against their plain sharded versions (on the card, on the same ranks,
  on the rank's block) and the unsharded K3 / K5 on one segment each (K8's
  on northstar with the limit at 16,384), K10 against its plain per-round
  version and K3 on northstar's first wave, K11 against its plain version
  and K5 on the affinity cluster's hostname spread and zone spread, K13
  against its plain version and K4 on spread's first three segments, and
  K14 against its plain version and K3c on extended's first 1-GPU wave and
  on northstar's wave, with `torch.topk` of the block's scores at K10's
  and K11's select widths beside them. The phase prints the epochs or
  rounds, the branches, the collective calls and bytes, the staged bytes,
  the host reads, the sharded kernels' per-stage and setup times, the
  bytes held and each rank's wall; a rank that fails fails the phase.
- the scenario mesh (`parallel/`, the probe, serve and sweep fan-outs on a
  'scenarios' axis): two ranks spawned after the build share cuda:0 over
  gloo, each a scenario group that stages and runs its block of every
  fan-out's lanes and gathers the outputs at the fetch. On both ranks:
  `CapacityPlanner.search()` on `capacity_lanes` against its golden, the
  64 what-if sessions of the serve phase (10,000 nodes, 20,000 events
  ingested) against the single-rank responses above, and the sweep CLI
  (`--parity off`) on bench.py's sweep and on monte-carlo-mix against the
  JAX reports, rank 0 writing `--out` and rank 1 nothing. Then each of the
  eight fan-outs on the rank's block of 4 of 8 lanes against one launch
  over all 8 (and, gathered, against all of it), bit for bit, timed with
  its plain version on the block. The phase prints each run's walls,
  launches, fetches, gathered calls and bytes and staged bytes per rank.
- the partitioned layout's serial route (`use_waves = False`): the port's
  unsharded serial run of `hard`'s first 2,500 pods in this process, then
  two ranks sharing cuda:0 over gloo, each staging only its block of the
  node axis, hold K12 (`ops/csrc/batch_sharded.cu`, the serial scan on the
  block) against its plain version and the unsharded K2 on the first 256
  pods of `hard` and `extended` (EXT), and its explain mode against K7,
  then run that serial run through `Simulator(use_mesh=True)` with
  `use_waves = False` against the unsharded one (choices digest, census,
  every reason) and `demo_1` against its golden. Every scan on the block
  must make exactly two all_gather_rows a pod and one pmax per pod whose
  group has ScheduleAnyway terms. The phase prints per rank the wall and
  wall per pod, collectives per pod by kind, the bytes gathered and
  staged, K12's per-stage times and the table and carry bytes each rank
  holds against the unsharded layout's.

Every phase prints one JSON line; any mismatch or error exits non-zero. The
line before the card line lists every kernel with its launches on the main
path, its time, its plain version's time and its bound; the last line is the
device record. Without a CUDA device it exits 2 and prints no result. Imports
no JAX and nothing of open_simulator_tpu.
"""

from __future__ import annotations

import copy
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


def k1_checks(label: str, tables: dict, carries: dict, groups, flags: dict,
              forced_too: bool = True) -> int:
    """K1 against its plain version, bit for bit, on every table variant,
    carry and group: the packed buffer (`feasibility_packed`, one launch)
    against the plain pair packed, then the mask and every stage
    (`feasibility_kernel`), forced (with `forced_too`) and not, with and
    without the DoNotSchedule filter. Returns the cases checked."""
    import torch

    from open_simulator_torch.ops import kernels as K

    checked = 0
    for tname, tb in tables.items():
        N = int(tb.alloc.shape[0])
        for cname, cry in carries.items():
            for g in groups:
                cases = ((-1, True), (g % N, True), (-1, False)) if forced_too else ((-1, True),)
                for forced, dns in cases:
                    where = f"{label}: group {g}, forced {forced}, {tname} tables, {cname} carry"
                    f_p, s_p = K.feasibility(tb, cry, g, forced, True, include_dns=dns, **flags)
                    if dns:
                        rows = K.feasibility_packed(tb, cry, g, forced, True, **flags)
                        if not torch.equal(rows, K.pack_feasibility(f_p, s_p)):
                            fail(f"feasibility {where}: the packed buffer differs")
                    f_k, s_k = K.feasibility_kernel(tb, cry, g, forced, True, include_dns=dns,
                                                    **flags)
                    if not torch.equal(f_k, f_p):
                        fail(f"feasibility {where}: the mask differs")
                    for k in K.STAGE_KEYS:
                        if not torch.equal(s_k[k], s_p[k]):
                            fail(f"feasibility {where}: stage {k} differs")
                    checked += 1
    return checked


def k1_shape() -> dict:
    """The cluster shape of K1's last launch."""
    from open_simulator_torch.ops import kernels as K

    shape = K.feasibility_jit.last_shape
    return dict(cluster_ctas=shape.C, threads=shape.threads, smem=shape.smem,
                items_per_thread=shape.nodes_per_thread)


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


def k3c_cost(tb, cry, out_of_place: bool = True) -> tuple:
    """(shared bytes, lane bytes, f32 operations) of one aggregate commit:
    the [U, N] domain maps read once (shared by lanes); the carry's
    requested, nonzero, counter and carrier read and written once and the
    counts read once (each lane's own); one multiply and one add per
    element. Out of place (K3c and K14, which write a new carry) also the
    fields they copy, each read and written once: port_used, dev_used,
    vg_req and sdev_alloc (`out_of_place` False: the in-place one-block
    forms of both, which left them where they were)."""
    N, R = tb.alloc.shape
    D1 = cry.counter.shape[1]
    rows = N * R + 2 * N + (cry.counter.shape[0] + cry.carrier.shape[0]) * D1
    lane = 2 * 4 * rows + 4 * N
    if out_of_place:
        lane += 2 * nbytes(cry.port_used, cry.dev_used, cry.vg_req, cry.sdev_alloc)
    return nbytes(tb.topo_dom), lane, 2 * rows + tb.topo_dom.numel()


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


def cluster_fields(wrapper, ms: float) -> dict:
    """The cluster shape of `wrapper`'s last K2 / K4 launch (ops/cluster.py
    Shape), its time a pod from `ms` (the launch's mean), its rounds (each a
    cluster-wide exchange) and cluster barriers a pod, over the pods lane 0
    stepped (the kernel's own counts)."""
    from open_simulator_torch.ops.cluster import STATS_WORDS

    shape = wrapper.last_shape
    rounds, barriers, steps = wrapper.last_stats.reshape(-1, STATS_WORDS)[0].tolist()
    steps = max(steps, 1)
    return dict(cluster_ctas=shape.C, threads=shape.threads,
                nodes_per_thread=shape.nodes_per_thread, resident=shape.resident,
                us_per_pod=ms * 1e3 / steps, rounds_per_pod=rounds / steps,
                barriers_per_pod=barriers / steps)


def wave_cluster_fields(wrapper, ms: float, unit: str, steps: int = 0) -> dict:
    """The cluster shape of `wrapper`'s last K3 ("iteration") or K5
    ("epoch") launch (ops/cluster.py Shape), that launch's device time
    between the CUDA events around it (`device_ms`: the kernel without the
    wrapper's host work, which `ms`, the mean of a run of calls, includes),
    its time a wave iteration or epoch from `ms` over `steps` (by default
    the most steps a lane of the launch made, the kernel's own count) and
    from device_ms, and its cluster rounds a step; for K5 the head-fallback
    epochs of those lanes."""
    shape = wrapper.last_shape
    st = wrapper.last_cluster_stats.reshape(-1, 5).tolist()  # placed, steps, heads, _, rounds
    steps = max(steps or max(r[1] for r in st), 1)
    start, end = wrapper.last_events
    end.synchronize()
    device_ms = start.elapsed_time(end)
    out = dict(cluster_ctas=shape.C, threads=shape.threads,
               nodes_per_thread=shape.nodes_per_thread, resident=shape.resident,
               smem=shape.smem, device_ms=device_ms)
    out[f"us_per_{unit}"] = ms * 1e3 / steps
    out[f"device_us_per_{unit}"] = device_ms * 1e3 / steps
    out[f"rounds_per_{unit}"] = max(r[4] for r in st) / steps
    if unit == "epoch":
        out["head_fallback_epochs"] = sum(r[2] for r in st)
    return out


def cluster_round_case(card: str) -> None:
    """The latency floor of K2's and K4's pod steps: a run of empty pod
    steps (csrc/schedule.cu cluster_round_probe_kernel, no node work), each
    one fused round of phase B's shape with 9 zone sums and one argmax
    round, on one cluster of each size; and a cluster barrier alone (what a
    round adds whose ScheduleAnyway marks are too wide to ride it). Prints
    microseconds a round or barrier."""
    from open_simulator_torch.ops import kernels as K

    rounds = 2000
    us = {name: {C: cuda_ms(lambda: K.cluster_round_probe_kernel(C, rounds, 9, mode), 3) * 1e3
                 / (2 * rounds) for C in (1, 2, 4, 8, 16)}
          for mode, name in enumerate(("us_per_round", "us_per_barrier"))}
    emit("cluster_round", rounds=2 * rounds, **us, card=card)


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


def demo1_inputs() -> tuple:
    """(cluster, apps) of the reference's primary example: demo_1 with the
    simple, complicate, open_local and more_pods apps and 18 seeded new
    nodes."""
    from open_simulator_torch.core.types import AppResource
    from open_simulator_torch.models.fakenode import new_fake_nodes
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
    return cluster, apps


def demo1_rate(result, label: str) -> float:
    """demo_1's match_rate against tests/golden/demo1_placements.json
    (through the port's parity module); fails below 1.0."""
    from open_simulator_torch.parity import load_dump, match_rate, placement_dump

    rate, detail = match_rate(placement_dump(result),
                              load_dump(os.path.join(REPO, "tests", "golden",
                                                     "demo1_placements.json")))
    if rate != 1.0:
        fail(f"{label}: match_rate {rate} against the golden ({dict(list(detail.items())[:5])})")
    return rate


def demo1(card: str) -> dict:
    """demo_1 (`demo1_inputs`) through simulate() against its golden
    (match_rate 1.0). Returns the launch counts."""
    cluster, apps = demo1_inputs()
    result, counts = run_simulate("demo_1", cluster, apps, card)
    emit("demo_1", match_rate=demo1_rate(result, "demo_1"), golden="match", card=card)
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
    shape = (cluster_fields(K.probe_serial_fanout if kind == "serial"
                            else K.probe_group_serial_fanout, ms)
             if kind in ("serial", "spread") else
             wave_cluster_fields(K.probe_wave_fanout, ms, "iteration") if kind == "wave" else
             wave_cluster_fields(K.probe_affinity_wave_fanout, ms, "epoch"))
    single_ms = cuda_ms(lambda: single(0), 3)
    N = int(tb.alloc.shape[0])
    # the tables once for all lanes; each lane's carry, counts, statistics
    # and [N] active row
    b = costs[0][0] + sum(lane + N for _, lane, _ in costs)
    ops = sum(op for _, _, op in costs)
    bound, by = bound_of(b, ops)
    emit(name, segment=kind, lanes=S, nodes=N, pods=length, placed=placed.tolist(),
         stats=stats, kernel_ms=ms, single_lane_ms=single_ms, plain_ms=plain_ms, bound_ms=bound,
         bytes=b, f32_ops=ops, max_abs_err=0.0, **shape, card=card)
    row = dict(source=SRC + {"serial": "schedule.cu", "wave": "wave.cu",
                             "spread": "group_serial.cu", "affinity": "affinity_wave.cu"}[kind],
               replaces=JAX_KERNELS + {"serial": ":2361", "wave": ":2302", "spread": ":2322",
                                       "affinity": ":2342"}[kind],
               max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    if commit is None:
        return row, None
    # K3c over lanes: the domain maps once, each lane's carry (every field
    # read and written once: out of place) and counts; the in-place bound
    # beside it
    c_ms = cuda_ms(commit, 20)
    shared, lane, c_ops = k3c_cost(tb, seed)
    cb = shared + S * lane
    cb_in_place = shared + S * k3c_cost(tb, seed, out_of_place=False)[1]
    c_bound, c_by = bound_of(cb, S * c_ops)
    emit("aggregate_commit_lanes", segment=kind, lanes=S, nodes=N,
         copies=ko[0].sum(dim=1).tolist(), kernel_ms=c_ms, plain_ms=commit_plain_ms,
         bound_ms=c_bound, bound_ms_in_place=bound_of(cb_in_place, S * c_ops)[0], bytes=cb,
         f32_ops=S * c_ops, max_abs_err=0.0, **shape_fields(K.aggregate_commit_lanes),
         card=card)
    return row, dict(source=SRC + "aggregate_commit.cu", replaces=JAX_KERNELS + ":976",
                     max_abs_err=0.0, ms=c_ms, plain_ms=commit_plain_ms, bound_ms=c_bound,
                     bound_by=c_by)


def scratch_cases(card: str) -> None:
    """K3 and K5 at a node count where a CTA's rows no longer fit its shared
    memory (20,480 nodes at table depth 64, clusters of 16: 1,280 nodes a
    CTA, ~370 KB of rows), so they live in its slice of global scratch: a
    cap1 wave, another wave and an affinity segment of the hard shape
    against their plain versions, bit for bit, and timed."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster

    t0 = time.perf_counter()
    nodes, pods = synth_cluster(20_480, 20_000, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    segs = sim._segments(bt, len(pods))
    picks = [("wave_cap1", next(s for s in segs if s[0] == "wave" and s[4])),
             ("wave", next(s for s in segs if s[0] == "wave" and not s[4])),
             ("affinity", next(s for s in segs if s[0] == "affinity"))]
    for label, (kind, _, m, g, cap1, flag) in picks:
        if kind == "wave":
            kw = dict(block=64, kmax=K.wave_kmax(m, sim.na.N, 64), gpu_live=flag)
            run_k, run_p, wrapper, unit = (K.schedule_wave_kernel, K.schedule_wave_plain,
                                           K.schedule_wave, "iteration")
        else:
            kw = dict(ss_live=flag, block=64, n_zones=bt.n_zones if flag else 2)
            run_k, run_p, wrapper, unit = (K.schedule_affinity_wave_kernel,
                                           K.schedule_affinity_wave_plain,
                                           K.schedule_affinity_wave, "epoch")
        kj, kp, kst = run_k(tb, seed, g, m, cap1, **kw)
        (pj, pp, pst), plain_ms = timed(lambda: run_p(tb, seed, g, m, cap1, **kw))
        names = K.WAVE_STATS if kind == "wave" else K.AFFINITY_STATS
        if (not torch.equal(kj, pj) or int(kp) != pp
                or kst.tolist() != [pst[k] for k in names]):
            fail(f"scratch {label}: the kernel differs from its plain version")
        ms = cuda_ms(lambda: run_k(tb, seed, g, m, cap1, **kw), 3)
        fields = wave_cluster_fields(wrapper, ms, unit)
        shape = wrapper.last_shape
        if shape.smem >= 4 * 65 * shape.chunk:  # less than the table's rows alone
            fail(f"scratch {label}: the rows did not go to scratch (smem {shape.smem})")
        emit("scratch_" + ("schedule_wave" if kind == "wave" else "schedule_affinity_wave"),
             case=label, nodes=int(tb.alloc.shape[0]), pods=m, block=64, placed=pp, **pst,
             kernel_ms=ms, plain_ms=plain_ms, max_abs_err=err_of(kj, pj), **fields, card=card)
    emit("scratch_done", seconds=time.perf_counter() - t0, card=card)


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


def capacity_search(kind: str, card: str, report: bool = True) -> tuple:
    """CapacityPlanner.search() on the card against the JAX golden: found,
    nodes_added, hist, stats and every round's candidates with their
    (scheduled, total, utilization). Every launch count is set to 0 just
    before; prints its line when `report`; returns (launch counts, wall
    seconds, the planner's probe session)."""
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
    if not report:
        return counts, wall, ses
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
# lanes of bench.py's sweep the parity pass re-runs on fresh Simulators (of
# 256; the example sweeps re-run every lane)
BENCH_PARITY_SAMPLE = 64
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
        sum(c[2] for c in costs), pods=lengths, placed=(ko >= 0).sum(dim=1).tolist(),
        **cluster_fields(K.sweep_whatif_fanout, ms))

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
        sum(c[2] for c in costs), union=len(union), placed=ko.tolist(),
        **cluster_fields(K.serve_whatif_fanout, ms))

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
        placed=ko.tolist(), iterations=st_s[:, 0].tolist(),
        **wave_cluster_fields(K.probe_wave_fanout, k3_ms, "iteration"))

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
    # the call's time over every lane's iterations (lanes run at once), the
    # shape of its segment launches
    sweep_fields = wave_cluster_fields(K.sweep_wave_fanout, ms, "iteration", steps=iters)
    for k in ("device_ms", "device_us_per_iteration"):  # the last (padding) segment's
        sweep_fields.pop(k)
    shared3 = sum(group_row_bytes(tb, seed, g)[0] for g in set(g_sk.flatten().tolist()))
    lane3 = sum(group_row_bytes(tb, seed, g)[1] + 5 * N for g in g_sk.flatten().tolist())
    c_shared, c_lane, c_ops = k3c_cost(tb, seed)
    b = shared3 + lane3 + depth * (c_shared + S * c_lane)
    ops = iters * N * ((block + 1) * K3_OPS_PER_ENTRY + K3_OPS_PER_NODE) + depth * S * c_ops
    row("sweep_wave_fanout", ms, plain_ms, b, ops, segments=depth, launches_per_call=2 * depth,
        placed=ko.sum(dim=2).tolist(), iterations=iters, **sweep_fields)

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
    bench spec, whose parity pass re-runs a seeded sample of
    BENCH_PARITY_SAMPLE of its 256 lanes (`--parity sample`), every byte but
    the parity block (the golden ran with parity off). Returns the launch
    counts of the run."""
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
        parity = (("--parity", "sample", "--parity-sample", str(BENCH_PARITY_SAMPLE))
                  if name == "bench" else ("--parity", "full"))
        rc = cli(["sweep", os.path.join(REPO, spec), "--out", out, *parity,
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
        if report["parity"] != {"mode": "sample", "checked": BENCH_PARITY_SAMPLE,
                                "mismatches": 0}:
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


def serve_image(n_nodes: int = 10_000, n_events: int = 20_000) -> tuple:
    """bench.py's serve shape on the card: a 10,000-node image with 5,000
    bound pods and the 20,000-event watch stream ingested through
    apply_events. Returns (image, bound pods, events applied, batches,
    build seconds, ingest seconds)."""
    from open_simulator_torch.serve import ResidentImage
    from open_simulator_torch.utils.synth import synth_watch_stream

    nodes, bound, lines = synth_watch_stream(n_nodes, n_events, seed=11, bookmark_every=64,
                                             n_bound=n_nodes // 2)
    t0 = time.perf_counter()
    img = ResidentImage.try_build(nodes, pods=bound, device="cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    applied = batches = 0
    for batch in watch_batches(lines):
        applied += img.apply_events(batch)["applied"]
        batches += 1
    return img, bound, applied, batches, build_s, time.perf_counter() - t0


def serve_requests(img) -> list:
    """The 64 what-if requests of the serve phase, (pods, drains) each: 48
    uniform-replica requests of 50 to 2,000 pods, some with drains (the
    wave lane), and 16 mixed requests of ~200 pods (the serial lane)."""
    from open_simulator_torch.utils.synth import synth_pod

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
    return requests


RESPONSE_KEYS = ("scheduled", "total", "unscheduled", "utilization")


def oracle_answers(img, requests) -> list:
    """fresh_probe's answer to each (pods, drains) request, built apart
    from the image's resident state: a request with drains gets its own
    img.fresh_probe; the requests without drains share one fresh Simulator
    over the live cluster with the bound pods replayed once (a probe's run
    writes nothing back to the Simulator), each probed on it with
    fresh_probe's arithmetic, and the first of them is also held against
    its own img.fresh_probe. A fresh Simulator at 10,000 nodes takes 2-3 s
    to build and replay."""
    base = None
    out = []
    for pods, drains in requests:
        if drains:
            out.append(img.fresh_probe(pods, drains=drains))
            continue
        first = base is None
        if first:
            sim, bound, _ = img.fresh_simulator()
            base = (sim, len(bound), *sim.probe_pods(bound))  # the bound pods commit
        sim, n_bound, s0, t0 = base
        s1, t1 = sim.probe_pods([copy.deepcopy(p) for p in pods])
        scheduled, total = s0 + s1, t0 + t1
        ans = {"scheduled": scheduled - n_bound, "total": total - n_bound,
               "unscheduled": total - scheduled, "utilization": sim.probe_utilization()}
        if first:
            want = img.fresh_probe(pods)
            for k in RESPONSE_KEYS:
                if ans[k] != want[k]:
                    fail(f"serve: the shared fresh Simulator's {k} {ans[k]} != fresh_probe "
                         f"{want[k]}")
        out.append(ans)
    return out


def serve_full_width(card: str) -> tuple:
    """bench.py's serve shape on the card (serve_image), then the 64
    sessions of serve_requests in one dispatch_sessions call, each
    response held against fresh_probe's answer to the same request on the
    card (oracle_answers). Returns (the launch counts of the ingest and the
    dispatch, the responses)."""
    import torch

    from open_simulator_torch.ops import kernels as K

    K.reset_launch_counts()
    img, bound, applied, batches, build_s, ingest_s = serve_image()
    requests = serve_requests(img)
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
    for resp, want in zip(responses, oracle_answers(img, requests)):
        for k in RESPONSE_KEYS:
            if resp[k] != want[k]:
                fail(f"serve: {k} {resp[k]} != fresh_probe {want[k]}")
    oracle_s = time.perf_counter() - t0
    emit("serve", nodes=img._sim.na.N, live_nodes=img.n_nodes, bound=len(bound),
         events=applied, batches=batches, epoch=img.epoch, sessions=len(sessions),
         requested_pods=sum(len(p) for p, _ in requests),
         scheduled=sum(r["scheduled"] for r in responses), build_s=build_s, ingest_s=ingest_s,
         dispatch_s=dispatch_s, route_s=route_s, oracle_s=oracle_s,
         launches={k: v for k, v in counts.items() if v}, fresh_probe="match", card=card)
    return counts, [{k: r[k] for k in RESPONSE_KEYS} for r in responses]


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
         ext=bool(gpu or storage), **shape_fields(K.explain_jit), max_abs_err=err,
         recording_on_s=wall,
         recording_off_s=wall_off, encode_s=seconds("simon_encode_seconds"),
         host_commit_s=seconds("simon_host_commit_seconds"), golden="match", card=card)
    return (dict(source=SRC + "explain.cu", replaces=JAX_KERNELS + ":751", max_abs_err=err,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None),
            counts)


# ---- preemption: the DefaultPreemption PostFilter on the card -----------------
# (tests/test_torch_golden.py keeps the same workload function; a tier-1 test
# holds the two copies to one result)

PREEMPT_NODES = 1000
PREEMPT_BATCH = (7000, 24)   # (cpu milli, memory GiB) of every call-1 / call-2 pod
PREEMPT_PROD = (20000, 48)   # the same of every call-3 pod
PREEMPT_COUNTERS = ("simon_preemption_attempts_total", "simon_preemption_victims_total",
                    "simon_preemption_replay_pods_total", "simon_commit_rollbacks_total")
PREEMPT_KEYS = ("choices_sha256", "per_node_counts", "placed", "unscheduled", "reason_census",
                "preempted", "preempted_sha256", "nominations", "counters")
# K1's device time a launch on hard's first decision set before preemption
# (PERF.md §6, the feasibility_jit row)
K1_HARD_MS = 0.0079
PREEMPT_SAMPLE_REPLAYS = 1  # PostFilter passes of the timing runs
REPLAY_CAP = "OPEN_SIMULATOR_MAX_PREEMPTION_REPLAYS"


def preempt_pod(name: str, priority: int, cpu_milli: int, mem_gi: int, app: str,
                tolerate: bool = False, spread: bool = False, never: bool = False) -> dict:
    spec = {"priority": priority,
            "containers": [{"name": "app", "image": "nginx:1.25", "resources": {
                "requests": {"cpu": f"{cpu_milli}m", "memory": str(mem_gi << 30)}}}]}
    if tolerate:
        spec["tolerations"] = [{"key": "synth/dedicated", "operator": "Equal",
                                "value": "batch", "effect": "NoSchedule"}]
    if spread:
        spec["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": app}}}]
    if never:
        spec["preemptionPolicy"] = "Never"
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default", "labels": {"app": app}},
            "spec": spec}


def preempt_workload(n_nodes: int = PREEMPT_NODES) -> tuple:
    """(nodes, calls, pdbs): synth_cluster(n_nodes, 0, hard_predicates=True)'s
    nodes; call 1 at priority 0 (`batch-a`, and `batch-b` tolerating the
    taint under a PDB allowing 2 disruptions), call 2 at priority 100
    (`svc-c`), call 3 at priority 1000 (`prod-x`, `prod-y` with a zone
    DoNotSchedule spread, `prod-z` tolerating the taint, `prod-n` with
    preemptionPolicy Never)."""
    from open_simulator_torch.utils.synth import synth_cluster

    nodes, _ = synth_cluster(n_nodes, 0, hard_predicates=True)
    bc, bm = PREEMPT_BATCH
    pc, pm = PREEMPT_PROD
    call1 = ([preempt_pod(f"batch-a-{i:05d}", 0, bc, bm, "batch-a") for i in range(n_nodes)]
             + [preempt_pod(f"batch-b-{i:05d}", 0, bc, bm, "batch-b", tolerate=True)
                for i in range(n_nodes)])
    call2 = [preempt_pod(f"svc-c-{i:05d}", 100, bc, bm, "svc-c") for i in range(n_nodes)]
    k = max(2, n_nodes // 100)
    call3 = [preempt_pod(f"{app}-{i:03d}", 1000, pc, pm, app, **kw)
             for app, kw in (("prod-x", {}), ("prod-y", {"spread": True}),
                             ("prod-z", {"tolerate": True}), ("prod-n", {"never": True}))
             for i in range(k)]
    pdb = {"apiVersion": "policy/v1beta1", "kind": "PodDisruptionBudget",
           "metadata": {"name": "batch-b", "namespace": "default"},
           "spec": {"selector": {"matchLabels": {"app": "batch-b"}}},
           "status": {"disruptionsAllowed": 2}}
    return nodes, [call1, call2, call3], [pdb]


SCHED_CONFIG = os.path.join(REPO, "tests", "golden", "torch_port_sched_hard_waves.sched.yaml")


def sched_kernel_cases(sched, card: str) -> None:
    """The kernels `sched_hard_waves` does not reach (its segments are waves
    and affinity runs, none failing) under its configuration at full width:
    K2 on 256 pods strided over `hard`'s 50 blocks (every kind of the
    cluster) and K1 on their groups (seed and end carries, forced and not,
    with and without DoNotSchedule), K7 on each group, and K4 on the first
    segment of each spread flag of `spread`, all on tables encoded under the
    configuration (TaintToleration off), each against its plain version
    with the configuration's ScoreWeights / FilterFlags, bit for bit."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster, synth_spread_cluster

    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    sim = Simulator(nodes, device="cuda", sched_config=sched)
    wf = dict(w=sim.score_w, filters=sim.filter_flags)
    batch = pods[::196][:256]
    bt = sim.encode_batch(batch)
    tb, seed = sim._to_device(bt)
    dev = tb.alloc.device
    pg, fn, vd = (torch.from_numpy(a).to(dev) for a in (bt.pod_group, bt.forced_node, bt.valid))
    end_k, ch_k = K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones, **wf)
    end_p, ch_p = K.schedule_batch_plain(tb, seed, pg, fn, vd, bt.n_zones, **wf)
    if not torch.equal(ch_k, ch_p):
        fail(f"sched: schedule_batch choices differ at {int((ch_k != ch_p).sum())} pods")
    for f in K.Carry._fields:
        if not torch.equal(getattr(end_k, f), getattr(end_p, f)):
            fail(f"sched: schedule_batch carry.{f} differs")
    kinds = sorted({int(g) for g in bt.pod_group[:len(batch)]})
    k1 = k1_checks("sched", {"encoded": tb}, {"seed": seed, "end": end_k}, kinds,
                   {"filters": sim.filter_flags})
    for g in kinds:
        for cry in (seed, end_k):
            k = K.explain_kernel(tb, cry, g, -1, True, bt.n_zones, **wf)
            p = K.pack_explain(*K.explain_pod(tb, cry, g, -1, True, bt.n_zones, **wf))
            if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
                fail(f"sched: explain_kernel differs on group {g}")
    sp_nodes, sp_pods, sp_services = synth_spread_cluster(5000, 20000)
    sp = Simulator(sp_nodes, device="cuda", sched_config=sched)
    sp.register_cluster_objects(ResourceTypes(services=sp_services))
    sp_bt = sp.encode_batch(sp_pods)
    sp_tb, sp_seed = sp._to_device(sp_bt)
    firsts = {}
    for seg in sp._segments(sp_bt, len(sp_pods)):
        if seg[0] == "spread":
            firsts.setdefault((seg[5], seg[6]), seg)
    for (ss_live, sa_live), (_, _, m, g, cap1, _, _) in sorted(firsts.items()):
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        kw = dict(ss_live=ss_live, sa_live=sa_live, n_zones=sp_bt.n_zones if ss_live else 2, **wf)
        kj, kp = K.schedule_group_serial_kernel(sp_tb, sp_seed, g, valid, cap1, **kw)
        pj, pp = K.schedule_group_serial_plain(sp_tb, sp_seed, g, valid, cap1, **kw)
        if not torch.equal(kj, pj) or int(kp) != pp:
            fail(f"sched: schedule_group_serial (ss_live={ss_live}, sa_live={sa_live}) differs")
    emit("sched_kernels", nodes=int(tb.alloc.shape[0]), k2_pods=len(batch),
         k2_placed=int((ch_k >= 0).sum()), k1_cases=k1, k7_cases=2 * len(kinds),
         k4_segments=len(firsts), score_weights=sim.score_w._asdict(),
         filter_flags=sim.filter_flags._asdict(), max_abs_err=0.0, card=card)


def cuda_profiling() -> bool:
    """Whether torch.profiler can trace the card here (CUPTI)."""
    from torch.profiler import ProfilerActivity, supported_activities

    return ProfilerActivity.CUDA in supported_activities()


def preempt_phase(card: str) -> Counter:
    """The PostFilter at full width on the card. Run 1 (the main path, every
    launch count set to 0 just before it): the three calls of
    `preempt_workload()` through `Simulator.schedule_pods`, each fit counted
    and required to be exactly one K1 launch, against the JAX golden
    (tests/golden/torch_port_preempt.json: digests, the `preempted` sha256,
    the nominations, the counters' deltas). The tables and carry of its
    first fit and of its first fit after an eviction are kept, and K1 is
    held against its plain version on them after the run (`k1_checks`: the
    packed buffer, the mask and every stage at the fits' shape). Run 2: the
    same with each fit's host split timed on the port's own callees of
    `preemption._fits` (the table build, the upload, the launch call, the
    one-byte fetch; synchronized after the upload). Run 3: call 3 under
    torch.profiler for K1's device time on the fits (where the profiler
    shows no K1 launch: CUDA events over the kept fits' launches back to
    back). Runs 2 and 3 stop after PREEMPT_SAMPLE_REPLAYS PostFilter passes
    (OPEN_SIMULATOR_MAX_PREEMPTION_REPLAYS), so they time a sample of the
    fits; only run 1 is held to the golden. Returns run 1's launch counts."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.obs import REGISTRY
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator import preemption as PRE
    from open_simulator_torch.simulator.encode import plugin_flags
    from open_simulator_torch.simulator.engine import Simulator

    want = load_golden("preempt")
    orig = {f: getattr(PRE, f) for f in ("_fits", "try_preempt", "_fit_tables", "_fit_byte")}
    tally = Counter()
    kept = {}  # "first" / "after_eviction" -> (g, tables, carry, K1's flags)

    def counted_fit(sim, g, node_i, placed2):
        key = ("first" if not kept else
               "after_eviction" if sim.preempted and "after_eviction" not in kept else None)
        if key is not None:
            bt = orig["_fit_tables"](sim, g, placed2)
            gpu, storage = plugin_flags(bt)
            kept[key] = (g, *sim._to_device(bt),
                         dict(filters=sim.filter_flags, enable_gpu=gpu, enable_storage=storage))
        before = K.feasibility_jit.launches
        out = orig["_fits"](sim, g, node_i, placed2)
        if K.feasibility_jit.launches != before + 1:
            fail("preempt: a fit was not exactly one K1 launch")
        tally["fits"] += 1
        return out

    def counted_try(sim, pod):
        before = K.feasibility_jit.launches
        out = orig["try_preempt"](sim, pod)
        tally["k1_preemption"] += K.feasibility_jit.launches - before
        tally["replays"] += 1
        return out

    def run(patch=None, hook=None, profile_call3=False, replays=None):
        nodes, calls, pdbs = preempt_workload()
        sim = Simulator(nodes, device="cuda")
        sim.register_cluster_objects(ResourceTypes(pod_disruption_budgets=pdbs))
        if hook is not None:
            hook(sim)
        v0 = REGISTRY.values()
        failed, walls, prof = [], [], None
        for f, fn in (patch or {}).items():
            setattr(PRE, f, fn)
        cap = os.environ.get(REPLAY_CAP)
        if replays is not None:
            os.environ[REPLAY_CAP] = str(replays)
        try:
            for i, call in enumerate(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if profile_call3 and i == 2 and cuda_profiling():
                    from torch.profiler import ProfilerActivity, profile

                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        failed.extend(sim.schedule_pods(call))
                        torch.cuda.synchronize()
                else:
                    failed.extend(sim.schedule_pods(call))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        finally:
            for f, fn in orig.items():
                setattr(PRE, f, fn)
            os.environ.pop(REPLAY_CAP, None)
            if cap is not None:
                os.environ[REPLAY_CAP] = cap
        pods = [p for call in calls for p in call]
        rows = [[r["pod"]["metadata"]["name"], r["node"], r["by"]] for r in sim.preempted]
        after = REGISTRY.values()
        got = {**summarize(sim, pods, failed), "preempted": len(rows),
               "preempted_sha256": hashlib.sha256(json.dumps(rows).encode()).hexdigest(),
               "nominations": [[u.pod["metadata"]["name"],
                                (u.pod.get("status") or {}).get("nominatedNodeName")]
                               for u in failed],
               "counters": {k: after[k] - v0.get(k, 0) for k in sorted(after)
                            if k.split("{")[0] in PREEMPT_COUNTERS
                            and after[k] != v0.get(k, 0)}}
        for k in PREEMPT_KEYS if replays is None else ():
            if got[k] != want[k]:
                fail(f"preempt: {k} differs from the JAX golden")
        return got, walls, prof, [len(call) for call in calls]

    # run 1: the main path
    K.reset_launch_counts()
    got, walls, _, sizes = run({"_fits": counted_fit, "try_preempt": counted_try})
    counts = K.launch_counts()
    # each PostFilter pass: one K1 launch for the preemptor's reasons, one a fit
    if tally["fits"] <= 0 or tally["k1_preemption"] != tally["replays"] + tally["fits"]:
        fail(f"preempt: {tally['fits']} fits and {tally['replays']} passes made "
             f"{tally['k1_preemption']} K1 launches")
    if set(kept) != {"first", "after_eviction"}:
        fail(f"preempt: kept fits {sorted(kept)}, wanted a first one and one after an eviction")
    # K1 against its plain version at the fits' shape (not counted: after run 1)
    k1_cases = sum(k1_checks(f"preempt {key} fit", {"fit": tables}, {"fit": carry}, [g], flags)
                   for key, (g, tables, carry, flags) in sorted(kept.items()))
    fit_shape = dict(nodes=int(kept["first"][1].alloc.shape[0]), **k1_shape())

    # run 2: the host split of every fit, timed on the callees `_fits` calls
    split = Counter()
    in_fit = [False]

    def timer(name, fn, sync=False):
        def wrapped(*a, **kw):
            if not in_fit[0]:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            split[name] += time.perf_counter() - t0
            return out
        return wrapped

    def timed_fit(sim, g, node_i, placed2):
        in_fit[0] = True
        try:
            return orig["_fits"](sim, g, node_i, placed2)
        finally:
            in_fit[0] = False
            split["fits"] += 1

    def time_callees(sim):
        sim._to_device = timer("upload", sim._to_device, sync=True)
        sim._feasibility_packed = timer("launch", sim._feasibility_packed)

    _, split_walls, _, _ = run({"_fits": timed_fit,
                                "_fit_tables": timer("build", orig["_fit_tables"]),
                                "_fit_byte": timer("fetch", orig["_fit_byte"])},
                               hook=time_callees, replays=PREEMPT_SAMPLE_REPLAYS)
    if split["fits"] <= 0:
        fail("preempt: the split run made no fit")
    host_ms = {k: split[k] * 1e3 / split["fits"] for k in ("build", "upload", "launch", "fetch")}

    # run 3: K1's device time on call 3's launches under torch.profiler
    _, prof_walls, prof, _ = run(profile_call3=True, replays=PREEMPT_SAMPLE_REPLAYS)
    dev = {"launches": 0, "ms": 0.0}
    for e in (prof.key_averages() if prof is not None else ()):
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and "feasibility_kernel" in e.key:
            dev["launches"] += e.count
            dev["ms"] += us / 1e3
    if dev["launches"]:
        k1_ms, k1_source = dev["ms"] / dev["launches"], "torch.profiler (run 3's fits)"
    else:  # no device time traced: events over the kept fits' launches
        k1_ms = sum(cuda_ms(lambda: K.feasibility_packed(tables, carry, g, -1, True, **flags),
                            200) for g, tables, carry, flags in kept.values()) / len(kept)
        k1_source = "CUDA events (the kept fits, 200 launches back to back)"
    if not k1_ms > 0:
        fail("preempt: no device time for K1 on the fits")
    c = got["counters"]
    emit("preempt", nodes=PREEMPT_NODES, pods=sizes, walls_s=walls,
         attempts={k.split('"')[1]: v for k, v in c.items()
                   if k.startswith("simon_preemption_attempts_total")},
         victims=got["preempted"], replays=tally["replays"],
         replay_pods=c.get("simon_preemption_replay_pods_total", 0),
         rollbacks=c.get("simon_commit_rollbacks_total", 0), fits=tally["fits"],
         k1_launches_preemption=tally["k1_preemption"], k1_launches=counts["feasibility"],
         k1_fit_cases=k1_cases, k1_fit_shape=fit_shape, max_abs_err=0.0,
         k1_device_ms=k1_ms, k1_device_source=k1_source, k1_device_launches=dev["launches"],
         k1_hard_ms=K1_HARD_MS, fit_host_ms=host_ms,
         fit_host_total_ms=sum(host_ms.values()), split_fits=split["fits"],
         split_run_walls_s=split_walls,
         profiled_run_walls_s=prof_walls, nominated=sum(1 for _, v in got["nominations"] if v),
         unscheduled=got["unscheduled"], golden="match", card=card)
    return counts


# ---- the node mesh: two ranks that share the card ----------------------------

EPOCH_LIMIT = "OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES"
# (label, cluster kind, the epoch path's node limit: None keeps the default
# 2,048, the path: "epoch" (K8, K9) or "rounds" (above the limit: K10 for
# the wave, K11 for the affinity wave)). Every run takes the default route
# on the partitioned layout (serial segments on K12, group-serial ones on
# K13, every counted segment's commit on K14). Each run equals its kind's
# golden but mesh8_1m (bench.py's 100,000-node row) and spread_prefix,
# which have none: they equal the port's unsharded run of the same pods on
# the card (UNSHARDED_RUNS).
MESH_RUNS = (("extended", "extended", None, "epoch"), ("affinity", "affinity", 8192, "epoch"),
             ("affinity_tail", "affinity", None, "rounds"),
             ("overflow_waves", "overflow_waves", None, "epoch"),
             ("spread_prefix", "spread_prefix", None, "rounds"),
             ("northstar", "northstar", None, "rounds"), ("mesh8_1m", "mesh8_1m", None, "rounds"))
UNSHARDED_RUNS = ("spread_prefix", "mesh8_1m")
# spread's first pods: its ScheduleAnyway, SelectorSpread and DoNotSchedule
# segments (K13) and one wave
SPREAD_PREFIX = 2000
MESH_SHARDS = 2
# bench.py runs mesh8_1m in store form, which the JAX engine streams in one
# chunk of 2,097,152 pods (JAX engine.py:1216-1224); an explicit
# OPEN_SIMULATOR_STREAM_PODS cuts the port's dict batch the same way
STREAM_PODS_1M = "2097152"
# the epoch limit under which K8's own northstar case runs (N 10,240)
K8_NORTHSTAR_LIMIT = 16384


def mesh_cluster(kind: str):
    """(nodes, pods, services, storage classes) of a MESH_RUNS kind."""
    from open_simulator_torch.utils.synth import (synth_affinity_cluster, synth_cluster,
                                                  synth_extended_cluster)

    if kind == "extended":
        nodes, pods, _, scs = synth_extended_cluster(2000, 20000)
        return nodes, pods, [], scs
    if kind == "affinity":
        nodes, pods, services = synth_affinity_cluster(5000, 20000)
        return nodes, pods, services, []
    if kind == "mesh8_1m":
        nodes, pods = synth_cluster(100_000, 1_000_000)
        return nodes, pods, [], []
    if kind == "overflow_waves":
        nodes, pods = synth_cluster(100, 30000, hard_predicates=True)
        return nodes, pods, [], []
    if kind == "spread_prefix":
        from open_simulator_torch.utils.synth import synth_spread_cluster

        nodes, pods, services = synth_spread_cluster(5000, 20000)
        return nodes, pods[:SPREAD_PREFIX], services, []
    nodes, pods = synth_cluster(10000, 100000)
    return nodes, pods, [], []


def k8_cost(tb, cry, g: int, block: int, shards: int) -> tuple:
    """(bytes, f32 operations) of one K8 epoch on one rank's block: K3's
    counts of one iteration over N / shards nodes (the table and the
    per-node passes of the block; the group's rows, read once, split
    between the ranks)."""
    b, ops = one_lane(k3_cost(tb, cry, g, block, 1))
    return b // shards, ops // shards


def k9_cost(tb, cry, g: int, block: int, stats: dict, shards: int) -> tuple:
    """(bytes, f32 operations) of one K9 epoch on one rank's block: K5's
    counts of the segment over N / shards nodes, per epoch."""
    b, ops = one_lane(k5_cost(tb, cry, g, block, stats))
    return b // shards, ops // (shards * max(stats["epochs"], 1))


def k10_cost(tb, cry, g: int, block: int, shards: int, c: int) -> tuple:
    """(bytes, f32 operations) of one K10 round on one rank's block: K8's
    (K3's counts of one iteration over N / shards nodes), and the [c + 1]
    candidate rows written and the shards * (c + 1) gathered rows read
    (16 bytes each); the radix passes are integer work and not counted."""
    b, ops = k8_cost(tb, cry, g, block, shards)
    return b + 16 * (c + 1) * (1 + shards), ops


def k11_cost(tb, cry, g: int, block: int, stats: dict, shards: int, c: int) -> tuple:
    """(bytes, f32 operations) of one K11 epoch on one rank's block: the
    block's [NL, B+1] table written once, the [c + 1] candidate rows written
    and the shards * (c + 1) gathered rows read (16 bytes each); K5's f32
    operations per epoch over NL nodes (k9_cost), the radix passes and the
    rounds' integer work not counted."""
    NL = int(tb.alloc.shape[0]) // shards
    _, ops = k9_cost(tb, cry, g, block, stats, shards)
    return 4 * NL * (block + 1) + 16 * (c + 1) * (1 + shards), ops


def stage_ms(events: dict) -> dict:
    """Milliseconds per K8 - K14 stage, summed over its recorded launches
    (SHARDED_STAGE_EVENTS), the setup stages left out."""
    return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in events.items()
            if "setup" not in k}


def setup_ms(events: dict) -> float:
    """Milliseconds of the setup stages' recorded launches."""
    return sum(s.elapsed_time(e) for k, v in events.items() if "setup" in k for s, e in v)


def block_of_staged(tb, seed, mesh) -> tuple:
    """This rank's block of staged whole tables and carry (the partitioned
    layout `to_device_sharded` stages), and its node slice."""
    from open_simulator_torch.parallel.mesh import block_of

    NL = int(tb.alloc.shape[0]) // mesh.shards
    return (*block_of(tb, seed, mesh), slice(mesh.rank * NL, (mesh.rank + 1) * NL))


class gathered_rows:
    """Inside the block, every int64 `all_gather_rows` result (the block
    tops' candidate rows of K10 and K11) is kept in `.rows`."""

    def __enter__(self):
        import torch

        from open_simulator_torch.parallel import collectives

        self.mod, self.real, self.rows = collectives, collectives.all_gather_rows, []

        def spy(x, mesh):
            out = self.real(x, mesh)
            if out.dtype == torch.int64:
                self.rows.append(out)
            return out

        collectives.all_gather_rows = spy
        return self

    def __exit__(self, *exc):
        self.mod.all_gather_rows = self.real


def merge_yardstick(rows, R: int, c: int, k_max: int) -> tuple:
    """(ms, k) of torch.topk of a merge's gathered keys (the first c of each
    rank's c + 1 rows, pads included) at k = min(k_max, its nonzero keys):
    the library's call for the merge's selection."""
    import torch

    keys = rows.view(R, c + 1, -1)[:, :c, 0].reshape(-1).contiguous()
    k = min(k_max, int((keys != 0).sum()))
    return cuda_ms(lambda: torch.topk(keys, k), 10), k


def shape_fields(wrapper) -> dict:
    """The cluster shape of a K10 / K11 call's stages, or of the last K3c
    or K7 launch."""
    sh = wrapper.last_shape
    return dict(C=sh.C, threads=sh.threads, smem=sh.smem, nodes_per_thread=sh.nodes_per_thread,
                occupancy=sh.occupancy)


def mesh_rounds_case(mesh, nodes, pods) -> dict:
    """K10 against its plain per-round version on the card (bit for bit:
    counts, placed, WAVE_STATS) and against the unsharded K3, on the first
    wave segment of the cluster from the seed carry, on this rank of `mesh`
    at the default epoch limit; then K10 timed per stage by CUDA events and
    per call by the host clock, with its stages' cluster shape, and beside
    it torch.topk of the block's flat scores at k = c (the first round's
    local select) and of the first round's R * c gathered keys at k = m_cand
    (its merge)."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(nodes, device="cuda", use_mesh=False)
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    _, _, m, g, cap1, flag = next(s for s in sim._segments(bt, len(pods)) if s[0] == "wave")[:6]
    N = int(tb.alloc.shape[0])
    block = K.wave_block_for(m, sim.na.N)
    kmax = K.wave_kmax(m, sim.na.N, block)
    kw = dict(block=block, kmax=kmax, gpu_live=bool(flag))
    tbl, seedl, _ = block_of_staged(tb, seed, mesh)
    kernel = lambda: K.schedule_wave_rounds_kernel(  # noqa: E731
        tbl, seedl, g, m, cap1, mesh=mesh, **kw)
    plain = lambda: K.schedule_wave_plain(tbl, seedl, g, m, cap1, mesh=mesh, **kw)  # noqa: E731
    with gathered_rows() as gr:
        (kj, kp, kst), _ = timed(kernel)
    plain()  # warm-up: the rank's first calls of some PyTorch ops load their kernels
    (pj, pp, pst), plain_ms = timed(plain)
    uj, up, ust = K.schedule_wave_kernel(tb, seed, g, m, cap1, **kw)
    if not torch.equal(kj, pj) or int(kp) != pp or kst.tolist() != [pst[k] for k in K.WAVE_STATS]:
        fail(f"mesh rounds: K10 differs from its plain version ({int((kj != pj).sum())} nodes, "
             f"placed {int(kp)} vs {pp}, {kst.tolist()} vs {pst})")
    if not torch.equal(kj, uj) or int(kp) != int(up) or kst.tolist() != ust.tolist():
        fail("mesh rounds: K10 differs from the unsharded K3")
    rounds = int(kst[0])
    reps = 3
    mesh.reset_counts()
    K.schedule_wave_rounds_kernel.host_reads = 0
    events = K.SHARDED_STAGE_EVENTS = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kernel()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (reps * rounds)
    K.SHARDED_STAGE_EVENTS = None
    stages = stage_ms(events)
    setup = setup_ms(events) / reps
    NL = N // mesh.shards
    c = min(kmax, m, NL * block)
    # the library's yardstick: the k = c largest of the block's flat scores
    feas, _ = K.feasibility(tb, seed, g, -1, True)
    st = K._wave_statics(tb, seed, g)
    table = K._wave_score_table(tb, seed, st, K._wave_norms(st, feas), g,
                                torch.zeros(N, dtype=torch.int32, device=tb.alloc.device),
                                block=block)
    flat = table[mesh.rank * NL:(mesh.rank + 1) * NL, :block].reshape(-1).contiguous()
    topk_ms = cuda_ms(lambda: torch.topk(flat, c), 10)
    # and the merge's: the first round's R * c gathered keys at k = m_cand
    merge_topk_ms, m_cand = merge_yardstick(gr.rows[0], mesh.shards, c, min(kmax, m))
    b, ops = k10_cost(tb, seed, g, block, mesh.shards, c)
    bound, by = bound_of(b, ops)
    coll = {k: {"calls": v["calls"] // reps, "bytes": v["bytes"] // reps}
            for k, v in mesh.counts.items()}
    return dict(label="northstar", nodes=N, pods=m, block=block, kmax=kmax, c=c, placed=pp,
                rounds=rounds, stats=pst, kernel_ms_per_round=sum(stages.values()) / (reps * rounds),
                stage_ms_per_round={k: v / (reps * rounds) for k, v in stages.items()},
                setup_ms=setup,
                wall_ms_per_round=wall_ms, plain_ms_per_round=plain_ms / rounds,
                topk_ms=topk_ms, merge_topk_ms=merge_topk_ms, merge_k=m_cand,
                shape=shape_fields(K.schedule_wave_rounds_kernel),
                bound_ms=bound, bound_by=by, bytes=b, f32_ops=ops,
                collectives=coll, staged_bytes=mesh.staged_bytes // reps,
                host_reads=K.schedule_wave_rounds_kernel.host_reads // reps,
                max_abs_err=err_of(kj, pj))


def tail_verdicts(mesh) -> dict:
    """The sharded tail's epochs by branch and its sandwich rejections, as
    both K11 and its plain version count them (`NodeMesh.tail_branches`)."""
    return {k: v for k, v in mesh.tail_branches.items()
            if k in ("head", "select", "sandwich", "rejected")}


def mesh_tail_case(mesh, label: str, nodes, pods, services, pick) -> dict:
    """K11 against its plain sharded-tail version on the card (bit for bit:
    counts, placed, AFFINITY_STATS, and the same branches) and against the
    unsharded K5, on one affinity segment of the cluster from the seed
    carry, on this rank of `mesh` at the default epoch limit; then K11 timed
    per stage by CUDA events and per call by the host clock, with its stages'
    cluster shape, and beside it torch.topk of the block's flat first-epoch
    scores at k = c and of the first select's R * c gathered keys at k =
    K_EP (its merge)."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=list(services)))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    _, _, m, g, cap1, ss_live = pick(sim._segments(bt, len(pods)))[:6]
    N = int(tb.alloc.shape[0])
    block = K.wave_block_for(m, sim.na.N)
    kw = dict(ss_live=bool(ss_live), block=block, n_zones=bt.n_zones if ss_live else 2)
    tbl, seedl, _ = block_of_staged(tb, seed, mesh)
    kernel = lambda: K.schedule_affinity_wave_rounds_kernel(  # noqa: E731
        tbl, seedl, g, m, cap1, mesh=mesh, **kw)
    plain = lambda: K.schedule_affinity_wave_plain(  # noqa: E731
        tbl, seedl, g, m, cap1, mesh=mesh, **kw)
    mesh.reset_counts()
    with gathered_rows() as gr:
        (kj, kp, kst), _ = timed(kernel)
    branches = tail_verdicts(mesh)
    plain()  # warm-up: the rank's first calls of some PyTorch ops load their kernels
    mesh.reset_counts()
    (pj, pp, pst), plain_ms = timed(plain)
    plain_branches = tail_verdicts(mesh)
    uj, up, ust = K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1, **kw)
    if not torch.equal(kj, pj) or int(kp) != pp or kst.tolist() != [pst[k] for k in K.AFFINITY_STATS]:
        fail(f"mesh {label}: K11 differs from its plain version ({int((kj != pj).sum())} nodes, "
             f"placed {int(kp)} vs {pp}, {kst.tolist()} vs {pst})")
    if branches != plain_branches:
        fail(f"mesh {label}: K11's branches {branches} differ from the plain version's "
             f"{plain_branches}")
    if not torch.equal(kj, uj) or int(kp) != int(up) or kst.tolist() != ust.tolist():
        fail(f"mesh {label}: K11 differs from the unsharded K5")
    epochs = int(kst[0])
    reps = 3
    mesh.reset_counts()
    K.schedule_affinity_wave_rounds_kernel.host_reads = 0
    events = K.SHARDED_STAGE_EVENTS = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kernel()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (reps * epochs)
    K.SHARDED_STAGE_EVENTS = None
    stages = stage_ms(events)
    setup = setup_ms(events) / reps
    NL = N // mesh.shards
    c = min(N * block, K.K_EP_MAX, NL * block)
    # the library's yardstick: the k = c largest of the block's flat scores
    feas, _ = K.feasibility(tb, seed, g, -1, True)
    st = K._wave_statics(tb, seed, g)
    table = K._wave_score_table(tb, seed, st, K._wave_norms(st, feas), g,
                                torch.zeros(N, dtype=torch.int32, device=tb.alloc.device),
                                block=block)
    flat = table[mesh.rank * NL:(mesh.rank + 1) * NL, :block].reshape(-1).contiguous()
    topk_ms = cuda_ms(lambda: torch.topk(flat, c), 10)
    # and the merge's: the first select's R * c gathered keys at k = K_EP
    merge_topk_ms, k_ep = (merge_yardstick(gr.rows[0], mesh.shards, c, K.K_EP_MAX) if gr.rows
                           else (None, 0))
    b, ops = k11_cost(tb, seed, g, block, pst, mesh.shards, c)
    bound, by = bound_of(b, ops)
    coll = {k: {"calls": v["calls"] // reps, "bytes": v["bytes"] // reps}
            for k, v in mesh.counts.items()}
    return dict(label=label, nodes=N, pods=m, domains=int(seed.counter.shape[1]),
                ss_live=bool(ss_live), block=block, c=c, placed=pp, epochs=epochs, stats=pst,
                branches=branches, kernel_ms_per_epoch=sum(stages.values()) / (reps * epochs),
                stage_ms_per_epoch={k: v / (reps * epochs) for k, v in stages.items()},
                setup_ms=setup,
                wall_ms_per_epoch=wall_ms, plain_ms_per_epoch=plain_ms / epochs, topk_ms=topk_ms,
                merge_topk_ms=merge_topk_ms, merge_k=k_ep,
                shape=shape_fields(K.schedule_affinity_wave_rounds_kernel), bound_ms=bound, bound_by=by, bytes=b, f32_ops=ops, collectives=coll,
                staged_bytes=mesh.staged_bytes // reps,
                host_reads=K.schedule_affinity_wave_rounds_kernel.host_reads // reps,
                max_abs_err=err_of(kj, pj))


def mesh_kernel_case(mesh, label: str, kind: str, nodes, pods, services, scs, pick) -> dict:
    """K8 or K9 (`kind` "wave" or "affinity") against its plain sharded
    version on the card and the unsharded K3 / K5, on one segment of the
    cluster from the seed carry, on this rank of `mesh`; then K8 / K9 timed
    per stage by CUDA events and per call by the host clock."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=list(services),
                                               storage_classes=list(scs)))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    seg = pick(sim._segments(bt, len(pods)))
    _, _, m, g, cap1, flag = seg[:6]
    block = K.wave_block_for(m, sim.na.N)
    tbl, seedl, _ = block_of_staged(tb, seed, mesh)
    if kind == "wave":
        kw = dict(block=block, kmax=K.wave_kmax(m, sim.na.N, block), gpu_live=bool(flag))
        kernel = lambda: K.schedule_wave_sharded_kernel(  # noqa: E731
            tbl, seedl, g, m, cap1, mesh=mesh, **kw)
        plain = lambda: K.schedule_wave_plain(tbl, seedl, g, m, cap1, mesh=mesh, **kw)  # noqa: E731
        single = lambda: K.schedule_wave_kernel(tb, seed, g, m, cap1, **kw)  # noqa: E731
        names = K.WAVE_STATS
    else:
        kw = dict(ss_live=bool(flag), block=block, n_zones=bt.n_zones if flag else 2)
        kernel = lambda: K.schedule_affinity_wave_sharded_kernel(  # noqa: E731
            tbl, seedl, g, m, cap1, mesh=mesh, **kw)
        plain = lambda: K.schedule_affinity_wave_plain(  # noqa: E731
            tbl, seedl, g, m, cap1, mesh=mesh, **kw)
        single = lambda: K.schedule_affinity_wave_kernel(tb, seed, g, m, cap1, **kw)  # noqa: E731
        names = K.AFFINITY_STATS
    (kj, kp, kst), _ = timed(kernel)
    plain()  # warm-up: the rank's first calls of some PyTorch ops load their kernels
    (pj, pp, pst), plain_ms = timed(plain)
    uj, up, ust = single()
    if not torch.equal(kj, pj) or int(kp) != pp or kst.tolist() != [pst[k] for k in names]:
        fail(f"mesh {label}: the sharded kernel differs from its plain version "
             f"({int((kj != pj).sum())} nodes, placed {int(kp)} vs {pp}, {kst.tolist()} vs {pst})")
    if not torch.equal(kj, uj) or int(kp) != int(up) or kst.tolist() != ust.tolist():
        fail(f"mesh {label}: the sharded kernel differs from the unsharded one")
    epochs = int(kst[0])
    reps = 3
    mesh.reset_counts()
    events = K.SHARDED_STAGE_EVENTS = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kernel()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (reps * epochs)
    K.SHARDED_STAGE_EVENTS = None
    stages = stage_ms(events)
    ms = sum(stages.values()) / (reps * epochs)
    per_epoch = {k: v / (reps * epochs) for k, v in stages.items()}
    setup = setup_ms(events) / reps
    b, ops = (k8_cost(tb, seed, g, block, mesh.shards) if kind == "wave"
              else k9_cost(tb, seed, g, block, pst, mesh.shards))
    bound, by = bound_of(b, ops)
    coll = {k: {"calls": v["calls"] // reps, "bytes": v["bytes"] // reps}
            for k, v in mesh.counts.items()}
    # the cluster shapes: C of K8's / K9's block stages and of its tail
    wrapper = (K.schedule_wave_sharded_kernel if kind == "wave"
               else K.schedule_affinity_wave_sharded_kernel)
    shape = {k: v.C for k, v in wrapper.last_shape.items()}
    return dict(label=label, nodes=int(tb.alloc.shape[0]), pods=m, block=block, placed=pp,
                cluster_C=shape,
                epochs=epochs, stats=pst, kernel_ms_per_epoch=ms, stage_ms_per_epoch=per_epoch,
                setup_ms=setup, wall_ms_per_epoch=wall_ms, plain_ms_per_epoch=plain_ms / epochs,
                bound_ms=bound, bound_by=by, bytes=b, f32_ops=ops, collectives=coll,
                staged_bytes=mesh.staged_bytes // reps, max_abs_err=err_of(kj, pj))


def k13_cost(tbl, seedl, g: int, m: int) -> tuple:
    """(bytes, f32 operations) K13 must spend on one rank's block for m pods
    of group g: K4's counts over the block's NL nodes (k4_cost); the
    collective rows (tens of bytes a pod) left out."""
    return one_lane(k4_cost(tbl, seedl, g, m))


def k14_cost(tbl, seedl, gpu_live: bool, copies: int, out_of_place: bool = True) -> tuple:
    """(bytes, f32 operations) of K14 on one rank's block: K3c's counts over
    the block (its rows, counts and domain maps, the replicated counters in
    and out; k3c_cost; out of place, as K14 writes a new carry, also the
    fields it copies) and, with gpu_live, the block's device ledger (the
    totals read; in place also the ledger read and written, which out of
    place k3c_cost holds) and 8 operations per copy and device."""
    b, ops = one_lane(k3c_cost(tbl, seedl, out_of_place=out_of_place))
    if gpu_live:
        b += (1 if out_of_place else 3) * nbytes(tbl.dev_total)
        ops += copies * int(tbl.dev_total.shape[1]) * 8
    return b, ops


def mesh_group_serial_case(mesh, nodes, pods, services) -> dict:
    """K13 against its plain version on the card (the block's counts and
    placed, bit for bit, on this rank of `mesh`) and against the unsharded
    K4, on spread's first three segments from the seed carry (ScheduleAnyway,
    SelectorSpread, DoNotSchedule only), with K13's collectives asserted
    (two all_gather_rows a pod, a pmax a ScheduleAnyway pod); K13 timed per
    stage by CUDA events. Returns {segment label: record}."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=list(services)))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    tbl, seedl, sl = block_of_staged(tb, seed, mesh)
    segs = [s for s in sim._segments(bt, len(pods)) if s[0] == "spread"][:3]
    if {(s[5], s[6]) for s in segs} != {(False, True), (True, False), (False, False)}:
        fail(f"mesh spread: the first segments' flags {[(s[5], s[6]) for s in segs]}")
    out = {}
    for _, _, m, g, cap1, ss, sa in segs:
        label = "sa_live" if sa else "ss_live" if ss else "dns"
        vd = torch.ones(m, dtype=torch.bool)
        kw = dict(ss_live=bool(ss), sa_live=bool(sa), n_zones=bt.n_zones if ss else 2)
        mesh.reset_counts()
        events = K.SHARDED_STAGE_EVENTS = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kj, kp = K.schedule_group_serial_sharded_kernel(tbl, seedl, g, vd, cap1, mesh, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        K.SHARDED_STAGE_EVENTS = None
        calls = {k: v["calls"] for k, v in mesh.counts.items()}
        want = {"pmax": m if sa else 0, "all_gather_tiled": 0, "all_gather_rows": 2 * m}
        if calls != want:
            fail(f"mesh spread {label}: K13 made {calls} collective calls, not {want}")
        staged = mesh.staged_bytes
        (pj, pp), plain_ms = timed(lambda: K.schedule_group_serial_sharded_plain(
            tbl, seedl, g, vd, cap1, mesh, **kw))
        uj, up = K.schedule_group_serial_kernel(tb, seed, g, vd.cuda(), cap1, **kw)
        if not torch.equal(kj, pj) or int(kp) != pp:
            fail(f"mesh spread {label}: K13 differs from its plain version "
                 f"({int((kj != pj).sum())} nodes, placed {int(kp)} vs {pp})")
        if not torch.equal(kj, uj[sl]) or int(kp) != int(up):
            fail(f"mesh spread {label}: K13 differs from the unsharded K4")
        stages = stage_ms(events)
        b, ops = k13_cost(tbl, seedl, g, m)
        bound, by = bound_of(b, ops)
        out[label] = dict(nodes=int(tb.alloc.shape[0]), block_nodes=int(tbl.alloc.shape[0]),
                          cluster_C=K.schedule_group_serial_sharded_kernel.last_shape.C,
                          pods=m, placed=pp, ss_live=bool(ss), sa_live=bool(sa),
                          ms_per_pod=sum(stages.values()) / m,
                          stage_ms_per_pod={k: v / m for k, v in stages.items()},
                          setup_ms=setup_ms(events), wall_ms_per_pod=wall_ms / m,
                          plain_ms_per_pod=plain_ms / m, bound_ms_per_pod=bound / m,
                          bound_by=by, bytes=b, f32_ops=ops,
                          collectives_per_pod={k: v / m for k, v in calls.items()},
                          staged_bytes=staged, max_abs_err=err_of(kj, pj))
    return out


def mesh_commit_case(mesh, label: str, nodes, pods, services, scs, pick) -> dict:
    """K14 against its plain version on the card (the block's carry, bit for
    bit, on this rank of `mesh`) and against the unsharded K3c of the same
    counts, on one wave segment of the cluster from the seed carry (K3's
    counts), with its one all_gather_rows asserted and the input block carry
    unchanged (K14 writes a new one); K14 timed per stage by CUDA events over
    ten calls."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(services=list(services),
                                               storage_classes=list(scs)))
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    tbl, seedl, sl = block_of_staged(tb, seed, mesh)
    _, _, m, g, cap1, flag = pick(sim._segments(bt, len(pods)))[:6]
    gpu_live = bool(flag)
    block = K.wave_block_for(m, sim.na.N)
    j = K.schedule_wave_kernel(tb, seed, g, m, cap1, block=block,
                               kmax=K.wave_kmax(m, sim.na.N, block), gpu_live=gpu_live)[0]
    jl = j[sl].contiguous()
    before = K.Carry(*(t.clone() for t in seedl))
    mesh.reset_counts()
    kc = K.aggregate_commit_sharded_kernel(tbl, seedl, g, jl, gpu_live, mesh)
    if not all(torch.equal(a, b) for a, b in zip(seedl, before)):
        fail(f"mesh commit {label}: K14 wrote its input carry")
    calls = {k: v["calls"] for k, v in mesh.counts.items()}
    if calls != {"pmax": 0, "all_gather_tiled": 0, "all_gather_rows": 1}:
        fail(f"mesh commit {label}: K14 made {calls} collective calls")
    pc, plain_ms = timed(lambda: K.aggregate_commit_sharded_plain(tbl, seedl, g, jl, gpu_live,
                                                                  mesh))
    uc = K.aggregate_commit_kernel(tb, seed, g, j, gpu_live)
    ucb = block_of_staged(tb, uc, mesh)[1]
    for f in K.Carry._fields:
        if not torch.equal(getattr(kc, f), getattr(pc, f)):
            fail(f"mesh commit {label}: K14's carry.{f} differs from its plain version")
        if not torch.equal(getattr(kc, f), getattr(ucb, f)):
            fail(f"mesh commit {label}: K14's carry.{f} differs from the unsharded K3c")
    err = max(err_of(getattr(kc, f), getattr(pc, f)) for f in K.Carry._fields)
    reps = 10
    events = K.SHARDED_STAGE_EVENTS = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        K.aggregate_commit_sharded_kernel(tbl, seedl, g, jl, gpu_live, mesh)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    K.SHARDED_STAGE_EVENTS = None
    if not all(torch.equal(a, b) for a, b in zip(seedl, before)):
        fail(f"mesh commit {label}: K14's timed calls wrote their input carry")
    stages = {k: v / reps for k, v in stage_ms(events).items()}
    b, ops = k14_cost(tbl, seedl, gpu_live, int(jl.sum()))
    bound, by = bound_of(b, ops)
    # the in-place commit's bound (K14's one-block form, before it wrote a
    # new carry) beside the out-of-place one
    bound_in_place = bound_of(*k14_cost(tbl, seedl, gpu_live, int(jl.sum()), False))[0]
    return dict(label=label, nodes=int(tb.alloc.shape[0]), block_nodes=int(tbl.alloc.shape[0]),
                cluster_C=K.aggregate_commit_sharded_kernel.last_shape.C,
                pods=m, copies=int(jl.sum()), gpu_live=gpu_live, ms=sum(stages.values()),
                stage_ms=stages, wall_ms=wall_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_ms_in_place=bound_in_place, bound_by=by, bytes=b, f32_ops=ops,
                max_abs_err=err)


def tap_engine(sim, mesh) -> dict:
    """Counters a partitioned engine run fills as it goes (each hook calls
    the engine's own method): the node-axis table and carry bytes this rank
    stages against the whole tables' (`_to_device`), the serial and
    group-serial pods and the pods of those whose groups have ScheduleAnyway
    terms, the counted segments (`_dispatch`), the fetches of block counts
    (`_fetch_results`) and the failure diagnoses (`_explain_reasons`)."""
    from open_simulator_torch.parallel.mesh import _CARRY_NODE_AXIS, _TABLE_NODE_AXIS

    taps = dict(held=0, full=0, scanned=0, sa_pods=0, counted=0, fetches=0, explains=0)
    to_device, dispatch = sim._to_device, sim._dispatch
    fetch, explain = sim._fetch_results, sim._explain_reasons

    def tapped_to_device(bt):
        tables, carry = to_device(bt)
        taps["held"] += (nbytes(*(getattr(tables, f) for f in _TABLE_NODE_AXIS))
                         + nbytes(*(getattr(carry, f) for f in _CARRY_NODE_AXIS)))
        taps["full"] += (sum(getattr(bt, f).nbytes for f in _TABLE_NODE_AXIS)
                         + sum(getattr(bt, "seed_" + f).nbytes for f in _CARRY_NODE_AXIS))
        return tables, carry

    def tapped_dispatch(seg, bt, tables, carry, flags):
        kind, start, length = seg[:3]
        if kind == "serial":
            taps["scanned"] += length
            sa = (bt.sa_t >= 0).any(axis=1)
            taps["sa_pods"] += int(sa[bt.pod_group[start:start + length]].sum())
        elif kind == "spread":
            taps["scanned"] += length
            taps["sa_pods"] += length if seg[6] else 0
        taps["counted"] += kind != "serial"
        return dispatch(seg, bt, tables, carry, flags)

    def tapped_fetch(outs):
        taps["fetches"] += any(seg[0] != "serial" for seg, _, _ in outs)
        return fetch(outs)

    def tapped_explain(*args):
        taps["explains"] += 1
        return explain(*args)

    sim._to_device, sim._dispatch = tapped_to_device, tapped_dispatch
    sim._fetch_results, sim._explain_reasons = tapped_fetch, tapped_explain
    return taps


def expected_calls(path: str, taps: dict, stats: dict, aff: dict, branches: dict) -> dict:
    """The collective calls of a partitioned default-route run: each route's
    (the epoch path: a pmax and an all_gather_tiled per wave iteration and
    affinity epoch; above the limit: two pmax and two all_gather_rows per
    wave round, and per affinity epoch two to four by branch), two
    all_gather_rows per serial and group-serial pod and a pmax per such pod
    with ScheduleAnyway terms, one all_gather_rows per counted segment's
    commit, one all_gather_tiled per fetch of block counts and one per
    failure diagnosis."""
    want = {"pmax": taps["sa_pods"], "all_gather_tiled": taps["fetches"] + taps["explains"],
            "all_gather_rows": 2 * taps["scanned"] + taps["counted"]}
    if path == "epoch":
        epochs = stats["iterations"] + aff["epochs"]
        want["pmax"] += epochs
        want["all_gather_tiled"] += epochs
    else:
        rounds, head, sel, sand = (stats["iterations"], branches.get("head", 0),
                                   branches.get("select", 0), branches.get("sandwich", 0))
        if head + sel + sand != aff["epochs"]:
            fail(f"the tail's branches {branches} do not count its {aff['epochs']} epochs")
        want["pmax"] += 2 * rounds + sand
        want["all_gather_rows"] += 2 * rounds + 2 * head + 3 * (sel + sand)
    return want


# the unsharded kernels that a partitioned default-route run must not launch
UNSHARDED_NAMES = ("schedule_batch", "schedule_wave", "schedule_group_serial",
                   "schedule_affinity_wave", "aggregate_commit")


def mesh_rank(mesh, card: str, want_unsharded: dict) -> dict:
    """One rank of the mesh phase: each MESH_RUNS cluster through
    `Simulator(use_mesh=True).schedule_pods` on the partitioned default
    route against its golden, or for spread_prefix and mesh8_1m (one chunk,
    as bench.py cuts it) against the unsharded run `want_unsharded[label]`
    (every launch count and collective counter set to 0 just before it, the
    sharded kernels' stages timed by CUDA events, the collectives checked
    against `expected_calls`, this rank's share of the node-axis bytes held
    between 45% and 55%), then K8 - K11, K13 and K14 against their plain
    versions on segments of it."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    out = {"rank": mesh.rank, "backend": mesh.backend, "transport": mesh.transport,
           "runs": {}, "cases": {}, "launches": Counter()}
    for label, kind, limit, path in MESH_RUNS:
        os.environ.pop(EPOCH_LIMIT, None)
        if limit is not None:
            os.environ[EPOCH_LIMIT] = str(limit)
        with stream_pods(STREAM_PODS_1M if kind == "mesh8_1m" else None):
            nodes, pods, services, scs = mesh_cluster(kind)
            sim = Simulator(nodes, device="cuda", use_mesh=True)
        sim.register_cluster_objects(ResourceTypes(services=list(services),
                                                   storage_classes=list(scs)))
        if sim._resolve_mesh().shards != mesh.shards:
            fail(f"mesh {label}: the simulator's mesh has {sim._mesh.shards} shards")
        sim._mesh = mesh  # this rank's mesh, whose collective counters are read below
        taps = tap_engine(sim, mesh)
        K.reset_launch_counts()
        mesh.reset_counts()
        events = K.SHARDED_STAGE_EVENTS = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        failed = sim.schedule_pods(pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        K.SHARDED_STAGE_EVENTS = None
        counts = K.launch_counts()
        stats, aff = K.wave_stats(), K.affinity_stats()
        got = summarize(sim, pods, failed)
        if label in UNSHARDED_RUNS:
            ref = want_unsharded[label]
            got["reasons"] = [u.reason for u in failed]
            for k in ref:
                if got[k] != ref[k]:
                    fail(f"mesh {label}: {k} differs from the unsharded run's")
        else:
            check_golden(kind, got)
        calls = {k: v["calls"] for k, v in mesh.counts.items()}
        branches = dict(mesh.tail_branches)
        want = expected_calls(path, taps, stats, aff, branches)
        if calls != want:
            fail(f"mesh {label}: {calls} collective calls, expected {want} (stats {stats}, "
                 f"{aff}, branches {branches}, {taps})")
        share = taps["held"] / taps["full"]
        if abs(share - 1.0 / mesh.shards) > 0.05:
            fail(f"mesh {label}: this rank holds {share:.3f} of the node-axis bytes")
        if any(counts[k] for k in UNSHARDED_NAMES):
            fail(f"mesh {label}: an unsharded kernel ran: "
                 f"{ {k: counts[k] for k in UNSHARDED_NAMES} }")
        if taps["counted"] and counts["aggregate_commit_sharded"] != 2 * taps["counted"]:
            fail(f"mesh {label}: K14 launched {counts['aggregate_commit_sharded']} times for "
                 f"{taps['counted']} commits")
        census = sim.segment_census
        for seg_kind, name in (("serial", "schedule_batch_sharded"),
                               ("spread", "schedule_group_serial_sharded")):
            if (seg_kind in census) != (counts[name] > 0):
                fail(f"mesh {label}: {name} launched {counts[name]} times for the "
                     f"{seg_kind} segments {census.get(seg_kind)}")
        if failed and counts["feasibility"] <= 0:
            fail(f"mesh {label}: K1 never ran on the block for {len(failed)} failures")
        if path == "rounds":
            if (counts["schedule_wave_rounds"] > 0) != (stats["iterations"] > 0):
                fail(f"mesh {label}: K10 launched {counts['schedule_wave_rounds']} times")
            if (counts["schedule_affinity_wave_rounds"] > 0) != (aff["epochs"] > 0):
                fail(f"mesh {label}: K11 launched {counts['schedule_affinity_wave_rounds']} "
                     f"times")
        out["launches"].update(counts)
        stages = stage_ms(events)
        out["runs"][label] = dict(
            nodes=len(nodes), pods=len(pods),
            padded=int(sim._last_carry.requested.shape[0]) * mesh.shards,
            epoch_limit=limit or 2048, path=path, chunk=sim._stream_chunk, placed=got["placed"],
            unscheduled=got["unscheduled"], choices_sha256=got["choices_sha256"], seconds=wall,
            pods_per_s=len(pods) / wall, wave_stats=stats, affinity_stats=aff,
            rounds=stats["iterations"] if path == "rounds" else 0, tail_branches=branches,
            collectives=copy.deepcopy(mesh.counts), expected_calls=want,
            staged_bytes=mesh.staged_bytes, held_share=share, held_bytes=taps["held"],
            unsharded_bytes=taps["full"], serial_and_spread_pods=taps["scanned"],
            sa_pods=taps["sa_pods"], commits=taps["counted"], diagnoses=taps["explains"],
            host_reads=(K.schedule_wave_sharded_kernel.host_reads
                        + K.schedule_affinity_wave_sharded_kernel.host_reads
                        + K.schedule_wave_rounds_kernel.host_reads
                        + K.schedule_affinity_wave_rounds_kernel.host_reads),
            stage_ms=stages, kernel_ms=sum(stages.values()), setup_ms=setup_ms(events),
            launches={k: counts[k] for k in (
                "schedule_wave_sharded", "schedule_affinity_wave_sharded",
                "schedule_wave_sharded/gpu_live", "schedule_wave_rounds",
                "schedule_affinity_wave_rounds", "schedule_batch_sharded",
                "schedule_group_serial_sharded", "aggregate_commit_sharded",
                "aggregate_commit_sharded/gpu_live", "feasibility",
                "schedule_batch_sharded/gpu_storage")},
            census={k: list(v) for k, v in sorted(census.items())})
        del sim, nodes, pods, failed
        # the kernels against their plain versions on segments (of a fresh
        # copy of the cluster: the run bound the pods)
        if kind == "mesh8_1m":
            continue
        nodes, pods, services, scs = mesh_cluster(kind)
        if label == "extended":
            out["cases"]["schedule_wave_sharded/gpu_live"] = mesh_kernel_case(
                mesh, "extended_1gpu", "wave", nodes, pods, services, scs,
                lambda segs: next(s for s in segs if s[0] == "wave" and s[5]))
            out["cases"]["aggregate_commit_sharded/gpu_live"] = mesh_commit_case(
                mesh, "extended_1gpu", nodes, pods, services, scs,
                lambda segs: next(s for s in segs if s[0] == "wave" and s[5]))
        elif label == "affinity":
            out["cases"]["schedule_affinity_wave_sharded"] = mesh_kernel_case(
                mesh, "affinity_hostname_spread", "affinity", nodes, pods, services, scs,
                lambda segs: segs[1])
        elif label == "affinity_tail":
            # the cluster's hostname spread (the second block of each cycle)
            # and its zone spread (the fourth), at the default limit
            out["cases"]["schedule_affinity_wave_rounds"] = mesh_tail_case(
                mesh, "affinity_hostname_spread", nodes, pods, services, lambda segs: segs[1])
            out["cases"]["schedule_affinity_wave_rounds/zone_spread"] = mesh_tail_case(
                mesh, "affinity_zone_spread", nodes, pods, services, lambda segs: segs[3])
        elif label == "spread_prefix":
            for seg_label, case in mesh_group_serial_case(mesh, nodes, pods, services).items():
                name = "schedule_group_serial_sharded"
                out["cases"][name if seg_label == "sa_live" else f"{name}/{seg_label}"] = case
        elif label == "northstar":
            out["cases"]["schedule_wave_rounds"] = mesh_rounds_case(mesh, nodes, pods)
            out["cases"]["aggregate_commit_sharded"] = mesh_commit_case(
                mesh, "northstar", nodes, pods, services, scs,
                lambda segs: next(s for s in segs if s[0] == "wave"))
            os.environ[EPOCH_LIMIT] = str(K8_NORTHSTAR_LIMIT)
            out["cases"]["schedule_wave_sharded"] = mesh_kernel_case(
                mesh, "northstar", "wave", nodes, pods, services, scs,
                lambda segs: next(s for s in segs if s[0] == "wave"))
    os.environ.pop(EPOCH_LIMIT, None)
    return out


class stream_pods:
    """OPEN_SIMULATOR_STREAM_PODS set to `value` (None: unset) inside the
    block, for the Simulators built there; restored after it."""

    def __init__(self, value) -> None:
        self.value = value

    def __enter__(self):
        self.prev = os.environ.pop("OPEN_SIMULATOR_STREAM_PODS", None)
        if self.value is not None:
            os.environ["OPEN_SIMULATOR_STREAM_PODS"] = self.value

    def __exit__(self, *exc) -> None:
        os.environ.pop("OPEN_SIMULATOR_STREAM_PODS", None)
        if self.prev is not None:
            os.environ["OPEN_SIMULATOR_STREAM_PODS"] = self.prev


def unsharded_runs(card: str) -> dict:
    """The port's unsharded runs of the UNSHARDED_RUNS clusters on the card
    (one process, no mesh; mesh8_1m in one chunk as bench.py cuts it): emits
    their walls and returns {label: the digest, per-node counts, placed,
    unscheduled, reason census and (spread_prefix) the reasons in order}."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    out = {}
    for label in UNSHARDED_RUNS:
        nodes, pods, services, _ = mesh_cluster(label)
        K.reset_launch_counts()
        with stream_pods(STREAM_PODS_1M if label == "mesh8_1m" else None):
            sim = Simulator(nodes, device="cuda", use_mesh=False)
        sim.register_cluster_objects(ResourceTypes(services=list(services)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        failed = sim.schedule_pods(pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = summarize(sim, pods, failed)
        if label == "spread_prefix":
            got["reasons"] = [u.reason for u in failed]
        emit(f"{label}_unsharded", nodes=len(nodes), pods=len(pods), chunk=sim._stream_chunk,
             placed=got["placed"], unscheduled=got["unscheduled"],
             choices_sha256=got["choices_sha256"], seconds=wall,
             pods_per_s=len(pods) / wall, wave_stats=K.wave_stats(),
             census={k: list(v) for k, v in sorted(sim.segment_census.items())}, card=card)
        out[label] = got
        del sim, nodes, pods, failed
    return out


# the kernels-line rows of the mesh phase's cases: (source, JAX file:line,
# the case's per-call time key)
MESH_ROWS = {
    "schedule_wave_sharded": ("wave_sharded.cu", JAX_KERNELS + ":1204", "epoch"),
    "schedule_wave_sharded/gpu_live": ("wave_sharded.cu", JAX_KERNELS + ":1204", "epoch"),
    "schedule_affinity_wave_sharded": ("affinity_sharded.cu", JAX_KERNELS + ":1977", "epoch"),
    "schedule_wave_rounds": ("wave_rounds.cu", JAX_KERNELS + ":1273", "round"),
    "schedule_affinity_wave_rounds": ("affinity_rounds.cu", JAX_KERNELS + ":2095", "epoch"),
    "schedule_group_serial_sharded": ("group_serial_sharded.cu", JAX_KERNELS + ":2104", "pod"),
    "aggregate_commit_sharded": ("commit_sharded.cu", JAX_KERNELS + ":976", "call"),
    "aggregate_commit_sharded/gpu_live": ("commit_sharded.cu", JAX_KERNELS + ":1007", "call"),
}


def mesh_phase(card: str) -> tuple:
    """The mesh phase: MESH_SHARDS ranks spawned after the build, sharing
    cuda:0 over gloo (NCCL refuses two ranks on one card; the collectives
    stage CUDA tensors through pinned host memory), every run on the
    partitioned default route. Every rank's placements must equal the
    goldens (or the unsharded runs) and each other's. Returns (kernels-line
    rows, rank 0's launch counts of the main path)."""
    import tempfile

    import torch

    from open_simulator_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    want = unsharded_runs(card)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, before two more contexts
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as rdzv:
        try:
            ranks = run_ranks(mesh_rank, MESH_SHARDS, rdzv, args=(card, want), device="cuda",
                              backend="gloo", timeout_s=900)
        except RuntimeError as e:
            fail(f"mesh: {e}")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks[1:]:
        for label in r0["runs"]:
            if r["runs"][label]["choices_sha256"] != r0["runs"][label]["choices_sha256"]:
                fail(f"mesh {label}: rank {r['rank']} placed differently from rank 0")
    for label, run in r0["runs"].items():
        emit("mesh", label=label, shards=MESH_SHARDS, backend=r0["backend"],
             transport=r0["transport"], **run,
             reference="unsharded run" if label in UNSHARDED_RUNS else "golden",
             walls_per_rank=[r["runs"][label]["seconds"] for r in ranks],
             held_share_per_rank=[r["runs"][label]["held_share"] for r in ranks],
             kernel_ms_per_rank=[r["runs"][label]["kernel_ms"] for r in ranks], card=card)
    rows = {}
    for name, case in r0["cases"].items():
        emit("mesh_kernel", name=name, shards=MESH_SHARDS, transport=r0["transport"], **case,
             card=card)
        if name not in MESH_ROWS:  # the kernels line reports one case per kernel
            continue
        source, replaces, per = MESH_ROWS[name]
        if per == "pod":
            ms, plain, bound = (case["ms_per_pod"], case["plain_ms_per_pod"],
                                case["bound_ms_per_pod"])
        elif per == "call":
            ms, plain, bound = case["ms"], case["plain_ms"], case["bound_ms"]
        else:
            ms, plain = case[f"kernel_ms_per_{per}"], case[f"plain_ms_per_{per}"]
            bound = case["bound_ms"]
        rows[name] = dict(source=SRC + source, replaces=replaces,
                          max_abs_err=case["max_abs_err"], ms=ms, plain_ms=plain,
                          bound_ms=bound, bound_by=case["bound_by"],
                          library_ms=case.get("topk_ms"))
    emit("mesh_done", seconds=wall, card=card)
    return rows, r0["launches"]


SCENARIO_RANKS = 2
JAX_MESH = "open_simulator_tpu/parallel/mesh.py"
# each fan-out's CUDA source and the JAX sharded executable it runs as on a
# scenario mesh (ShardedKernels)
SCENARIO_ROWS = {"probe_serial_fanout": ("schedule.cu", ":586"),
                 "probe_wave_fanout": ("wave.cu", ":562"),
                 "probe_group_serial_fanout": ("group_serial.cu", ":578"),
                 "probe_affinity_wave_fanout": ("affinity_wave.cu", ":570"),
                 "serve_whatif_fanout": ("schedule.cu", ":594"),
                 "serve_wave_fanout": ("wave.cu", ":602"),
                 "sweep_wave_fanout": ("wave.cu", ":610"),
                 "sweep_whatif_fanout": ("schedule.cu", ":618")}


class plain_on_card:
    """The fan-outs' plain versions on CUDA tensors for a block: each
    fan-out picks its plain lanes where `kernels._on_cpu` says yes."""

    def __enter__(self):
        from open_simulator_torch.ops import kernels as K

        self.prev = K._on_cpu
        K._on_cpu = lambda t: True

    def __exit__(self, *exc):
        from open_simulator_torch.ops import kernels as K

        K._on_cpu = self.prev


def block_cost(name: str, tb, seed, args, kw, lanes: range, stats: dict) -> tuple:
    """(bytes, f32 operations) of one fan-out call on a block of lanes, from
    the cost triples above: the tables once, each lane's carry, outputs and
    [N] active row; the wave-like fan-outs' iterations (K3) or epochs (K5)
    as the call's loop statistics (`stats`, summed over the block) count
    them, and one K3c over lanes per segment."""
    import torch

    N = int(tb.alloc.shape[0])
    if name in ("probe_serial_fanout", "serve_whatif_fanout", "sweep_whatif_fanout"):
        pg, vd = torch.as_tensor(args[0]), torch.as_tensor(args[2])
        P = int(pg.shape[-1])
        costs = [k2_cost(tb, seed, int((vd[s] if vd.dim() == 2 else vd).sum()), P)
                 for s in lanes]
        return costs[0][0] + sum(c[1] + N for c in costs), sum(c[2] for c in costs)
    if name in ("probe_wave_fanout", "probe_group_serial_fanout", "probe_affinity_wave_fanout"):
        groups = [[int(args[0])] for _ in lanes]
    else:
        g = torch.as_tensor(args[0]).cpu()
        groups = [(g[s].tolist() if g.dim() == 2 else [int(g[s])]) for s in lanes]
    shared = sum(group_row_bytes(tb, seed, g)[0] for g in {g for gs in groups for g in gs})
    lane = sum(group_row_bytes(tb, seed, g)[1] + 5 * N for gs in groups for g in gs)
    if name == "probe_group_serial_fanout":
        ops = len(lanes) * k4_cost(tb, seed, int(args[0]), int(args[1].sum()))[2]
    elif name == "probe_affinity_wave_fanout":
        _, aff_lane, ops = k5_cost(tb, seed, int(args[0]), kw["block"], stats)
        lane += len(lanes) * (aff_lane - group_row_bytes(tb, seed, int(args[0]))[1] - 4 * N)
    else:
        ops = stats["iterations"] * N * ((kw["block"] + 1) * K3_OPS_PER_ENTRY + K3_OPS_PER_NODE)
    c_shared, c_lane, c_ops = k3c_cost(tb, seed)
    segs = len(groups[0])
    return (shared + lane + segs * (c_shared + len(lanes) * c_lane),
            ops + segs * len(lanes) * c_ops)


def scenario_block_case(mesh, name: str, tb, seed, cry, act, args, per_lane, kw) -> dict:
    """One fan-out on this rank's block of S lanes (its carry, active rows
    and per-lane inputs) against one launch over all S on the same rank:
    the block's outputs and carry leaves equal lanes [r*S/k, (r+1)*S/k) of
    the full launch bit for bit, and gathered over the ranks they equal all
    of it; the plain version on the block equals the kernel too. Times the
    block's call (CUDA events; the other rank shares the card) and its plain
    version, and bounds the block's work."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel import gather_lanes

    fn = getattr(K, name)
    full = fn(tb, cry, act, *args, **kw)
    full = list(full[0]) + [full[1]]
    S = int(act.shape[0])
    blk = mesh.lane_block(S)
    bargs = [a[blk].contiguous() if i in per_lane else a for i, a in enumerate(args)]
    bcry = K.Carry(*(t[blk].contiguous() for t in cry))
    bact = act[blk].contiguous()

    def run():
        c, o = fn(tb, bcry, bact, *bargs, **kw)
        return list(c) + [o]

    K.schedule_wave.stats = K.schedule_affinity_wave.stats = None
    got = run()
    stats = K.affinity_stats() if name == "probe_affinity_wave_fanout" else K.wave_stats()
    if any(not torch.equal(a, b[blk]) for a, b in zip(got, full)):
        fail(f"scenario_mesh {name}: rank {mesh.rank}'s block differs from the full launch")
    if any(not torch.equal(gather_lanes(a, mesh), b) for a, b in zip(got, full)):
        fail(f"scenario_mesh {name}: the gathered blocks differ from the full launch")
    ms = cuda_ms(run, 3)
    with plain_on_card():
        plain, plain_ms = timed(run)
    if any(not torch.equal(a, b) for a, b in zip(plain, got)):
        fail(f"scenario_mesh {name}: the plain block differs from the kernel's")
    b, ops = block_cost(name, tb, seed, args, kw, range(blk.start, blk.stop), stats)
    bound, by = bound_of(b, ops)
    return dict(lanes=blk.stop - blk.start, S=S, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, bytes=b, f32_ops=ops, max_abs_err=0.0)


def serve_lane_calls(img, sessions) -> list:
    """The serve and sweep fan-outs' inputs at S = 8 on the serve image, for
    the block cases: [(name, carry, active, args, per-lane argument
    positions, kwargs)] of eight uniform-replica sessions (per-lane g, m,
    cap1; two chained segments per lane for the sweep wave) and eight mixed
    ones (a valid row per lane of their union; a pod stream per lane)."""
    import numpy as np
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.encode import bucket_capped

    def lanes(batch):
        """(carry, active) of every lane: each lane's own seed copy, or the
        base seeds broadcast (never the image's cached block)."""
        S, active, carry_np = img._lane_arrays(batch)
        if carry_np is None:
            carry_np = [np.broadcast_to(v, (S,) + v.shape) for v in img._seeds]
        return (K.Carry(*(torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in carry_np)),
                torch.from_numpy(active).cuda())

    def on_card(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)

    wave, mixed = sessions[:8], sessions[48:56]
    img.ensure_staged()
    cry, act = lanes(wave)
    g_s, m_s, c_s = (np.asarray(v) for v in zip(*(img._wave_route(x) for x in wave)))
    g_s, m_s, c_s = g_s.astype(np.int32), m_s.astype(np.int32), c_s.astype(bool)
    N = img._sim.na.N
    block = K.wave_block_for(int(m_s.max()), N)
    kw = dict(block=block, kmax=K.wave_kmax(int(m_s.max()), N, block))
    calls = [("serve_wave_fanout", cry, act, on_card(g_s, m_s, c_s), (0, 1, 2), kw),
             ("sweep_wave_fanout", cry, act,
              on_card(*(np.stack([a, a[::-1]], 1) for a in (g_s, m_s, c_s))), (0, 1, 2), kw)]
    cry, act = lanes(mixed)
    S = int(act.shape[0])
    union, spans = [], []
    for x in mixed:
        spans.append((len(union), len(x.batch)))
        union += x.batch
    P = bucket_capped(len(union), 2048)
    pg, fn = np.zeros(P, np.int32), np.full(P, -1, np.int32)
    pg[:len(union)], fn[:len(union)] = np.asarray(union, np.int32).T
    valid = np.zeros((S, P), bool)
    for li, (a, n) in enumerate(spans):
        valid[li, a:a + n] = True
    kw = dict(n_zones=img._bt.n_zones, enable_gpu=False, enable_storage=False)
    calls.append(("serve_whatif_fanout", cry, act, on_card(pg, fn, valid), (2,), kw))
    P = bucket_capped(max(len(x.batch) for x in mixed), 2048)
    pg_s, fn_s, vd_s = np.zeros((S, P), np.int32), np.full((S, P), -1, np.int32), \
        np.zeros((S, P), bool)
    for li, x in enumerate(mixed):
        n = len(x.batch)
        pg_s[li, :n], fn_s[li, :n] = np.asarray(x.batch, np.int32).T
        vd_s[li, :n] = True
    calls.append(("sweep_whatif_fanout", cry, act, on_card(pg_s, fn_s, vd_s), (0, 1, 2), kw))
    return calls


def rank_cli_sweep(mesh, name: str, extra=()) -> dict:
    """The sweep CLI (`--parity off --device cuda`) on this rank of the
    process group: rank 0 writes --out, held against the JAX golden (byte
    for byte where the golden ran with parity off, else all but its parity
    block); any other rank writes and prints nothing."""
    import contextlib
    import io

    from open_simulator_torch.cli.main import main as cli
    from open_simulator_torch.sweep import report_json

    spec = BENCH_SPEC if name == "bench" else f"examples/sweeps/{name}.yaml"
    out = os.path.join(REPO, "build", "chip_smoke", f"mesh_sweep_{name}.{mesh.rank}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    stdout, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(stdout):
        rc = cli(["sweep", os.path.join(REPO, spec), "--out", out, "--parity", "off",
                  "--device", "cuda", *extra])
    if rc != 0:
        fail(f"scenario_mesh sweep {name}: rank {mesh.rank} exit {rc}: {err.getvalue()[-2000:]}")
    if mesh.rank:
        if os.path.exists(out) or stdout.getvalue():
            fail(f"scenario_mesh sweep {name}: rank {mesh.rank} wrote or printed")
        return {}
    with open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(REPO, "tests", "golden", f"torch_port_sweep_{name}.json"), "rb") as f:
        want = f.read()
    report, golden = json.loads(got), json.loads(want)
    if golden["parity"]["mode"] == "off":
        if got != want:
            fail(f"scenario_mesh sweep {name}: the report differs from the JAX golden")
    else:
        report.pop("parity")
        golden.pop("parity")
        if report_json(report) != report_json(golden):
            fail(f"scenario_mesh sweep {name}: the report differs from the JAX golden")
    return dict(scenarios=len(report["scenarios"]), lanes=report["lanes"],
                dispatches=report["dispatches"], golden="match")


def scenario_rank(node_mesh, card: str, serve_want: list) -> dict:
    """One rank of the scenario_mesh phase. The sessions', images' and
    CLI's own scenario mesh is this rank's (whose counters are read). Each
    main-path run with every launch count and mesh counter set to 0 just
    before it: `capacity_lanes` against its golden, the 64 what-if sessions
    at bench.py's serve shape against the single-rank dispatch's responses
    (`serve_want`), bench.py's sweep and monte-carlo-mix through the CLI
    against the JAX goldens. Then each fan-out's block against a full
    launch (scenario_block_case)."""
    import torch

    import open_simulator_torch.parallel.mesh as PM
    from open_simulator_torch.ops import kernels as K

    mesh = PM.make_scenario_mesh(device="cuda")
    PM.auto_scenario_mesh = lambda device=None: mesh
    out = {"rank": mesh.rank, "backend": mesh.backend, "transport": mesh.transport,
           "runs": {}, "cases": {}, "launches": Counter()}
    held = {}

    def main_run(label, fn):
        K.reset_launch_counts()
        mesh.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        out["launches"].update(counts)
        if not mesh.fetched or any(S != b * mesh.scenarios for b, S in mesh.fetched):
            fail(f"scenario_mesh {label}: fetches {dict(mesh.fetched)} on {mesh.scenarios} groups")
        out["runs"][label] = dict(seconds=wall, launches={k: v for k, v in counts.items() if v},
                                  fetches=sum(mesh.fetched.values()), blocks=sorted(mesh.blocks),
                                  gathered=dict(mesh.counts["gather_lanes"]),
                                  staged_bytes=mesh.staged_bytes, **res)

    def capacity():
        counts, wall, ses = capacity_search("capacity_lanes", card, report=False)
        held["session"] = ses
        return dict(search_s=wall, golden="match")

    def serve():
        img, _, applied, batches, build_s, ingest_s = serve_image()
        requests = serve_requests(img)
        sessions = [img.session(pods, drains=d) for pods, d in requests]
        t0 = time.perf_counter()
        responses = img.dispatch_sessions(sessions)
        dispatch_s = time.perf_counter() - t0
        for i, (r, want) in enumerate(zip(responses, serve_want)):
            if {k: r[k] for k in RESPONSE_KEYS} != want:
                fail(f"scenario_mesh serve: response {i} differs from the single-rank dispatch")
        held["image"], held["sessions"] = img, sessions
        return dict(events=applied, batches=batches, build_s=build_s, ingest_s=ingest_s,
                    dispatch_s=dispatch_s, sessions=len(sessions), single_rank="match")

    main_run("capacity_lanes", capacity)
    main_run("serve", serve)
    main_run("bench", lambda: rank_cli_sweep(mesh, "bench", ("--fanout", "32")))
    main_run("monte-carlo-mix", lambda: rank_cli_sweep(mesh, "monte-carlo-mix"))

    # each fan-out's block against a full launch, outside the main-path runs
    ses = held["session"]
    cands = next(r["candidates"] for r in load_golden("capacity_lanes")["rounds"]
                 if len(r["candidates"]) == 8)
    active = torch.zeros((8, ses._n_pad), dtype=torch.bool)
    for i, n in enumerate(cands):
        active[i, :ses.n_base + n] = True
    active, cry = active.cuda(), K.carry_lanes(ses._seed, 8)
    seen = set()
    for seg in ses._segs:
        name, args, kw = ses.fanout_call(seg)
        if name in seen:
            continue
        seen.add(name)
        args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)
        out["cases"][name] = scenario_block_case(mesh, name, ses._tables, ses._seed, cry, active,
                                                 args, (), kw)
    img = held["image"]
    seed = K.carry_from_numpy(dict(zip(K.Carry._fields, img._seeds)), "cuda")
    for name, cry, act, args, per_lane, kw in serve_lane_calls(img, held["sessions"]):
        out["cases"][name] = scenario_block_case(mesh, name, img._tables, seed, cry, act, args,
                                                 per_lane, kw)
    return out


def scenario_mesh_phase(card: str, serve_want: list) -> tuple:
    """The scenario_mesh phase: SCENARIO_RANKS ranks spawned after the build,
    sharing cuda:0 over gloo (CUDA tensors staged through pinned host
    memory), each a scenario group of one rank running its block of every
    fan-out's lanes. Returns (kernels-line rows, rank 0's launch counts of
    the main-path runs under "<fan-out>/mesh")."""
    import tempfile

    import torch

    from open_simulator_torch.parallel.launch import run_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as rdzv:
        try:
            ranks = run_ranks(scenario_rank, SCENARIO_RANKS, rdzv, args=(card, serve_want),
                              device="cuda", backend="gloo", timeout_s=900)
        except RuntimeError as e:
            fail(f"scenario_mesh: {e}")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for label, run in r0["runs"].items():
        emit("scenario_mesh", run=label, ranks=SCENARIO_RANKS, backend=r0["backend"],
             transport=r0["transport"], **run,
             walls_per_rank=[r["runs"][label]["seconds"] for r in ranks],
             launches_per_rank=[r["runs"][label]["launches"] for r in ranks],
             gathered_per_rank=[r["runs"][label]["gathered"] for r in ranks],
             staged_bytes_per_rank=[r["runs"][label]["staged_bytes"] for r in ranks], card=card)
    rows, launches = {}, Counter()
    for name, (src, line) in SCENARIO_ROWS.items():
        cases = [r["cases"][name] for r in ranks]
        emit("scenario_block", name=name, ranks=SCENARIO_RANKS, **cases[0],
             ms_per_rank=[c["ms"] for c in cases], card=card)
        rows[f"{name}/mesh"] = dict(source=SRC + src, replaces=JAX_MESH + line, max_abs_err=0.0,
                                    ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
                                    bound_ms=cases[0]["bound_ms"], bound_by=cases[0]["bound_by"])
        launches[f"{name}/mesh"] = r0["launches"][name]
    emit("scenario_mesh_done", seconds=wall, card=card)
    return rows, launches


# ---- the partitioned layout: each rank holds its block of the node axis and
# the serial route runs on it (K12)

PART_SHARDS = 2
PART_ENGINE_PODS = 2500  # the engine run's prefix of hard's pods
PART_KERNEL_PODS = 256   # K12 against its plain version on this prefix


def partitioned_cluster(label: str, n_pods: int) -> tuple:
    """(nodes, the first n_pods pods, storage classes) of a partitioned-phase
    cluster: hard's synth_cluster shape, or the extended cluster."""
    from open_simulator_torch.utils.synth import synth_cluster, synth_extended_cluster

    if label == "extended":
        nodes, pods, _, scs = synth_extended_cluster(2000, 20000)
        return nodes, pods[:n_pods], scs
    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    return nodes, pods[:n_pods], []


def serial_run(nodes, pods, scs, mesh=None) -> tuple:
    """The serial route (`use_waves = False`) of Simulator.schedule_pods on
    the card, on `mesh`'s partitioned layout (None: unsharded), every launch
    count set to 0 just before it: (summary with the reasons per failed pod,
    launch counts, wall seconds, simulator)."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(nodes, device="cuda", use_mesh=mesh is not None)
    sim.use_waves = False
    sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
    if mesh is not None:
        if sim._resolve_mesh().shards != mesh.shards:
            fail(f"partitioned: the simulator's mesh has {sim._mesh.shards} shards")
        sim._mesh = mesh  # this rank's mesh, whose collective counters are read
        mesh.reset_counts()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    failed = sim.schedule_pods(pods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = summarize(sim, pods, failed)
    got["reasons"] = [u.reason for u in failed]
    at = {id(p): i for i, p in enumerate(pods)}
    got["failed_at"] = [at[id(u.pod)] for u in failed]
    return got, K.launch_counts(), wall, sim


def sa_pods_of(nodes, pods, scs) -> int:
    """How many of `pods` belong to a group with ScheduleAnyway terms in
    their batch's encoding (each such pod costs the scan on the block one
    pmax)."""
    import numpy as np

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.engine import Simulator

    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
    bt = sim.encode_batch(pods)
    sa = (bt.sa_t >= 0).any(axis=1)
    return int(sa[bt.pod_group[bt.valid]].sum())


def partitioned_unsharded(card: str) -> dict:
    """The port's unsharded serial run of the partitioned phase's cluster
    (hard's first PART_ENGINE_PODS pods) on the card, in this process:
    {label: (pods, summary, ScheduleAnyway pods)}. The serial scan on the
    block's other runs are the mesh phase's: extended's serial segments
    (K12 with the GPU-share and Open-Local branches, K1 on the block for its
    failures) and overflow_waves' failures (K1 on the block)."""
    runs = {}
    for label in ("hard",):
        nodes, pods, scs = partitioned_cluster(label, PART_ENGINE_PODS)
        runs[label] = (len(pods), *serial_run(nodes, pods, scs)[::2], sa_pods_of(nodes, pods, scs))
    for label, (n, got, wall, sa) in runs.items():
        emit("partitioned_unsharded", label=label, pods=n, placed=got["placed"],
             unscheduled=got["unscheduled"], choices_sha256=got["choices_sha256"], sa_pods=sa,
             seconds=wall, ms_per_pod=wall * 1e3 / n, card=card)
    return {label: (n, got, sa) for label, (n, got, _, sa) in runs.items()}


def k12_cost(tbl, seedl, P: int, pad: int, ext: bool) -> tuple:
    """(bytes, f32 operations) K12 must spend on one rank's block for a scan
    of P valid pods: K2's counts over the block's NL nodes (its tables and
    pod arrays read once, its carry in and out, P steps of NL nodes) and,
    with the GPU-share / Open-Local branches, their block tables and
    ledgers; the collective rows (a few hundred bytes a pod) left out."""
    b, ops = one_lane(k2_cost(tbl, seedl, P, pad))
    if ext:
        b += gpu_storage_bytes(tbl, seedl) + nbytes(seedl.dev_used, seedl.vg_req,
                                                    seedl.sdev_alloc)
    return b, ops


def check_scan_collectives(what: str, counts: dict, pods: int, sa_pods: int,
                           tiled: int = 0) -> None:
    """Fail unless the scan on the block made exactly two all_gather_rows
    per pod and one pmax per pod whose group has ScheduleAnyway terms, and
    `tiled` all_gather_tiled (the reasons' gathers) besides."""
    got = {k: v["calls"] for k, v in counts.items()}
    want = {"pmax": sa_pods, "all_gather_tiled": tiled, "all_gather_rows": 2 * pods}
    if got != want:
        fail(f"{what}: collectives {got}, expected {want}")


def partitioned_kernel_case(mesh, label: str) -> dict:
    """K12 against its plain version (on the card, on this rank) and the
    unsharded K2 on the cluster's first PART_KERNEL_PODS pods from the seed
    carry, bit for bit (choices; the carry, gathered for K2), then K12's
    explain mode against K7 on the end carry for every group; K12 timed per
    stage by CUDA events, its plain version and K2 beside it."""
    import torch

    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.parallel.collectives import all_gather_tiled
    from open_simulator_torch.parallel.mesh import gather_carry, to_device_sharded
    from open_simulator_torch.simulator.encode import pad_batch_tables, plugin_flags
    from open_simulator_torch.simulator.engine import Simulator

    nodes, pods, scs = partitioned_cluster(label, PART_KERNEL_PODS)
    sim = Simulator(nodes, device="cuda", use_mesh=False)
    sim.register_cluster_objects(ResourceTypes(storage_classes=list(scs)))
    bt = pad_batch_tables(sim.encode_batch(pods), mesh.shards)
    gpu, storage = plugin_flags(bt)
    flags = dict(enable_gpu=gpu, enable_storage=storage)
    pg, fn, vd = (torch.from_numpy(a) for a in (bt.pod_group, bt.forced_node, bt.valid))
    tb, seed = sim._to_device(bt)
    tbl, seedl, _ = to_device_sharded(bt, mesh)
    P, pad = int(vd.sum()), int(vd.shape[0])
    kernel = lambda: K.schedule_batch_sharded_kernel(tbl, seedl, pg, fn, vd, bt.n_zones,  # noqa: E731
                                                     mesh, **flags)
    kernel()  # warm-up: the rank's first launches and collectives
    mesh.reset_counts()
    events = K.SHARDED_STAGE_EVENTS = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kc, kch = kernel()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    K.SHARDED_STAGE_EVENTS = None
    coll = copy.deepcopy(mesh.counts)
    staged = mesh.staged_bytes
    sa_pods = int(sum(K._has_sa(tb, int(g)) for g in bt.pod_group[:P]))
    check_scan_collectives(f"partitioned {label}", coll, P, sa_pods)
    stages = {k: v / P for k, v in stage_ms(events).items()}
    (pc, pch), plain_ms = timed(lambda: K.schedule_batch_sharded_plain(
        tbl, seedl, pg, fn, vd, bt.n_zones, mesh, **flags))
    (uc, uch), k2_ms = timed(lambda: K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones,
                                                             **flags))
    if not torch.equal(kch, pch) or not all(torch.equal(a, b) for a, b in zip(kc, pc)):
        fail(f"partitioned {label}: K12 differs from its plain version "
             f"({int((kch != pch).sum())} choices)")
    full = gather_carry(kc, mesh)
    if not torch.equal(kch, uch) or not all(torch.equal(a, b) for a, b in zip(full, uc)):
        fail(f"partitioned {label}: K12 differs from the unsharded K2 "
             f"({int((kch != uch).sum())} choices)")
    err = max(err_of(a, b) for a, b in zip(kc, pc))
    groups = sorted({int(g) for g in bt.pod_group[:P]})
    for g in groups:
        ek = all_gather_tiled(K.explain_sharded_kernel(tbl, kc, g, -1, True, bt.n_zones, **flags,
                                                       mesh=mesh), mesh, axis=1)
        eu = K.explain_kernel(tb, uc, g, -1, True, bt.n_zones, **flags)
        if not torch.equal(ek.view(torch.int32), eu.view(torch.int32)):
            fail(f"partitioned {label}: K12's explain mode differs from K7 (group {g})")
    b, ops = k12_cost(tbl, seedl, P, pad, gpu or storage)
    bound, by = bound_of(b, ops)
    return dict(label=label, nodes=int(tb.alloc.shape[0]), block_nodes=int(tbl.alloc.shape[0]),
                pods=P, placed=int((kch >= 0).sum()), sa_pods=sa_pods,
                cluster_C=K.schedule_batch_sharded_kernel.last_shape.C,
                ms_per_pod=sum(stages.values()), stage_ms_per_pod=stages,
                wall_ms_per_pod=wall_ms / P, plain_ms_per_pod=plain_ms / P,
                k2_ms_per_pod=k2_ms / P, bound_ms_per_pod=bound / P, bound_by=by, bytes=b,
                f32_ops=ops, collectives_per_pod={k: v["calls"] / P for k, v in coll.items()},
                gathered_bytes={k: v["bytes"] for k, v in coll.items()}, staged_bytes=staged,
                explain_groups=len(groups), max_abs_err=err,
                table_bytes=nbytes(*tbl), carry_bytes=nbytes(*seedl),
                unsharded_table_bytes=nbytes(*tb), unsharded_carry_bytes=nbytes(*seed))


def demo1_partitioned(mesh) -> tuple:
    """demo_1 as simulate() runs it (the cluster's workloads expanded, the
    cluster synced, then each app), on this rank's partitioned layout with
    `use_waves = False`: (match_rate, launch counts, wall seconds)."""
    import torch

    from open_simulator_torch.models.workloads import (expand_workloads_excluding_daemonsets,
                                                       pods_from_daemonset)
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator

    cluster, apps = demo1_inputs()
    cluster = cluster.copy()
    pods = expand_workloads_excluding_daemonsets(cluster)
    for ds in cluster.daemon_sets:
        pods.extend(pods_from_daemonset(ds, cluster.nodes))
    cluster.pods = pods
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = Simulator(cluster.nodes, device="cuda", use_mesh=True)
    sim.use_waves = False
    sim._mesh = mesh
    result = sim.run_cluster(cluster)
    failed = list(result.unscheduled_pods)
    for app in apps:
        result = sim.schedule_app(app)
        failed.extend(result.unscheduled_pods)
    result.unscheduled_pods = failed
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return demo1_rate(result, "partitioned demo_1"), K.launch_counts(), wall


def partitioned_rank(mesh, card: str, want: dict) -> dict:
    """One rank of the partitioned phase: K12 against its plain version on
    hard's and extended's clusters, then the engine's partitioned serial
    route (`use_waves = False`) on hard's prefix against the unsharded run
    `want` (choices digest, census, reasons), with collectives per pod, the
    stage times and the bytes held, and demo_1 against its golden."""
    import torch

    from open_simulator_torch.ops import kernels as K

    out = {"rank": mesh.rank, "backend": mesh.backend, "transport": mesh.transport,
           "cases": {}, "runs": {}, "launches": Counter()}
    for label in ("hard", "extended"):
        out["cases"][label] = partitioned_kernel_case(mesh, label)
    for label, (n, ref, sa_pods) in want.items():
        nodes, pods, scs = partitioned_cluster(label, n)
        events = K.SHARDED_STAGE_EVENTS = {}
        got, counts, wall, sim = serial_run(nodes, pods, scs, mesh)
        K.SHARDED_STAGE_EVENTS = None
        for k in ("choices_sha256", "per_node_counts", "placed", "unscheduled", "reason_census",
                  "reasons", "failed_at"):
            if got[k] != ref[k]:
                fail(f"partitioned {label}: {k} differs from the unsharded run's")
        if counts["schedule_batch_sharded"] <= 0 or counts["schedule_batch"]:
            fail(f"partitioned {label}: K12 launched {counts['schedule_batch_sharded']} times, "
                 f"K2 {counts['schedule_batch']}")
        # the scan's collectives, and one tiled gather per K1 launch on the block
        check_scan_collectives(f"partitioned {label}", mesh.counts, n, sa_pods,
                               tiled=counts["feasibility"])
        calls = {k: v["calls"] for k, v in mesh.counts.items()}
        out["launches"].update(counts)
        stages = stage_ms(events)
        out["runs"][label] = dict(
            nodes=len(nodes), pods=n, placed=got["placed"], unscheduled=got["unscheduled"],
            choices_sha256=got["choices_sha256"], seconds=wall, ms_per_pod=wall * 1e3 / n,
            collectives=calls, collectives_per_pod={k: v / n for k, v in calls.items()},
            gathered_bytes={k: v["bytes"] for k, v in mesh.counts.items()},
            staged_bytes=mesh.staged_bytes, stage_ms=stages,
            kernel_ms_per_pod=sum(v for k, v in stages.items() if "batch_sharded" in k) / n,
            launches={k: counts[k] for k in ("schedule_batch_sharded", "feasibility",
                                             "schedule_batch_sharded/gpu_storage")},
            block_rows=int(sim._last_carry.requested.shape[0]))
        del sim
    rate, counts, wall = demo1_partitioned(mesh)
    out["launches"].update(counts)
    out["runs"]["demo_1"] = dict(match_rate=rate, seconds=wall,
                                 launches={"schedule_batch_sharded":
                                           counts["schedule_batch_sharded"]})
    return out


def partitioned_phase(card: str) -> tuple:
    """The partitioned phase: the unsharded serial runs in this process,
    then PART_SHARDS ranks spawned after the build share cuda:0 over gloo,
    each staging only its block of the node axis, and run
    `partitioned_rank`. Every rank's runs must equal the unsharded ones and
    each other's. Returns (the K12 kernels-line row, rank 0's launch counts
    of the main path)."""
    import tempfile

    import torch

    from open_simulator_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    want = partitioned_unsharded(card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as rdzv:
        try:
            ranks = run_ranks(partitioned_rank, PART_SHARDS, rdzv, args=(card, want),
                              device="cuda", backend="gloo", timeout_s=600)
        except RuntimeError as e:
            fail(f"partitioned: {e}")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks[1:]:
        for label, run in r0["runs"].items():
            if run.get("choices_sha256") != r["runs"][label].get("choices_sha256"):
                fail(f"partitioned {label}: rank {r['rank']} placed differently from rank 0")
    for label, case in r0["cases"].items():
        emit("partitioned_kernel", shards=PART_SHARDS, transport=r0["transport"], **case,
             per_rank_ms_per_pod=[r["cases"][label]["ms_per_pod"] for r in ranks],
             per_rank_table_bytes=[r["cases"][label]["table_bytes"] for r in ranks],
             per_rank_carry_bytes=[r["cases"][label]["carry_bytes"] for r in ranks], card=card)
    for label, run in r0["runs"].items():
        emit("partitioned", label=label, shards=PART_SHARDS, backend=r0["backend"],
             transport=r0["transport"], **run,
             reference="golden" if label == "demo_1" else "unsharded run",
             walls_per_rank=[r["runs"][label]["seconds"] for r in ranks], card=card)
    case = r0["cases"]["hard"]
    row = dict(source=SRC + "batch_sharded.cu", replaces=JAX_MESH + ":413",
               max_abs_err=case["max_abs_err"], ms=case["ms_per_pod"],
               plain_ms=case["plain_ms_per_pod"], bound_ms=case["bound_ms_per_pod"],
               bound_by=case["bound_by"], library_ms=None)
    emit("partitioned_done", seconds=wall, card=card)
    return {"schedule_batch_sharded": row}, r0["launches"]


def schedule_batch_10240(card: str) -> None:
    """K2 at northstar's node count (10,000 nodes, N 10,240) on 2,500 pods
    of the hard shape: its time, shape and rounds a pod over all of them,
    and, on their first 500, choices and every carry field against its
    plain version (the plain scan of all 2,500 would add ~16 s)."""
    import torch

    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster

    nodes, pods = synth_cluster(10000, 2500, hard_predicates=True)
    sim = Simulator(nodes, device="cuda")
    bt = sim.encode_batch(pods)
    tb, seed = sim._to_device(bt)
    args = [torch.from_numpy(a).cuda() for a in (bt.pod_group, bt.forced_node, bt.valid)]
    head = [a[:500] for a in args]
    end_k, ch_k = K.schedule_batch_kernel(tb, seed, *head, bt.n_zones)
    (end_p, ch_p), plain_ms = timed(lambda: K.schedule_batch_plain(tb, seed, *head, bt.n_zones))
    if not torch.equal(ch_k, ch_p):
        fail(f"schedule_batch N 10,240: choices differ at {int((ch_k != ch_p).sum())} pods")
    for f in K.Carry._fields:
        if not torch.equal(getattr(end_k, f), getattr(end_p, f)):
            fail(f"schedule_batch N 10,240: carry.{f} differs")
    ms = cuda_ms(lambda: K.schedule_batch_kernel(tb, seed, *args, bt.n_zones), 3)
    b, ops = one_lane(k2_cost(tb, seed, len(pods), int(bt.pod_group.shape[0])))
    bound, _ = bound_of(b, ops)
    emit("schedule_batch_10240", nodes=int(tb.alloc.shape[0]), pods=len(pods),
         kernel_ms=ms, bound_ms=bound, checked_pods=500, plain_ms_500=plain_ms,
         placed_500=int((ch_k >= 0).sum()), max_abs_err=0.0,
         **cluster_fields(K.schedule_batch, ms), card=card)


def main() -> int:
    import numpy as np
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

    cluster_round_case(card)

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
         bound_ms=k2_bound, bytes=k2_b, f32_ops=k2_ops, max_abs_err=err_k2,
         **cluster_fields(K.schedule_batch, k2_ms), card=card)
    schedule_batch_10240(card)
    rows["schedule_batch"] = dict(source=SRC + "schedule.cu", replaces=JAX_KERNELS + ":2267",
                                  max_abs_err=err_k2, ms=k2_ms, plain_ms=plain_ms_k2,
                                  bound_ms=k2_bound, bound_by=k2_by)

    # ---- feasibility: K1 against its plain version (the packed buffer, the
    # mask and every stage), every group, seed and end carry, forced and
    # not, with and without the DoNotSchedule filter
    checked = k1_checks("hard", {"encoded": tb}, {"seed": seed, "end": end_k}, kinds, {})
    g0 = kinds[0]
    k1_ms = cuda_ms(lambda: K.feasibility_kernel(tb, end_k, g0, -1, True), 200)
    k1_plain_ms = cuda_ms(lambda: K.feasibility(tb, end_k, g0, -1, True), 50)
    k1_b = k1_bytes(tb, end_k, g0)
    k1_bound = k1_b / HBM_BYTES_PER_S * 1e3
    emit("feasibility", cases=checked, groups=len(kinds), kernel_ms=k1_ms,
         plain_ms=k1_plain_ms, bound_ms=k1_bound, bytes=k1_b, max_abs_err=0.0, **k1_shape(),
         card=card)
    # K1 on the spread cluster's hostname DoNotSchedule group (D+1 = N + 1:
    # the prologue's shares cut the hostnames), from the seed carry and after
    # K2 placed the first 1,250 pods, with the encoded eligible sets and with
    # none at all (every minimum 0)
    sp_nodes, sp_pods, sp_services = synth_spread_cluster(5000, 20000)
    sp_sim = Simulator(sp_nodes, device="cuda")
    sp_sim.register_cluster_objects(ResourceTypes(services=sp_services))
    sp_bt = sp_sim.encode_batch(sp_pods[:2000])
    sp_tb, sp_seed = sp_sim._to_device(sp_bt)
    sp_N = int(sp_tb.alloc.shape[0])
    host = [g for g in sorted({int(x) for x in sp_bt.pod_group[:2000]})
            if int(sp_tb.dns_edom[g].sum(dim=1).max()) > sp_N // 2]
    if not host:
        fail("spread: no group with a hostname DoNotSchedule term in the first 2,000 pods")
    g_h = host[0]
    sp_pg, sp_fn = (torch.from_numpy(a).cuda() for a in (sp_bt.pod_group, sp_bt.forced_node))
    sp_vd = torch.from_numpy(sp_bt.valid & (np.arange(sp_bt.valid.shape[0]) < 1250)).cuda()
    sp_end, _ = K.schedule_batch_kernel(sp_tb, sp_seed, sp_pg, sp_fn, sp_vd, sp_bt.n_zones)
    no_eligible = sp_tb._replace(dns_edom=torch.zeros_like(sp_tb.dns_edom))
    checked_h = k1_checks("hostname", {"encoded": sp_tb, "no_eligible": no_eligible},
                          {"seed": sp_seed, "end": sp_end}, [g_h], {})
    h_ms = cuda_ms(lambda: K.feasibility_kernel(sp_tb, sp_end, g_h, -1, True), 200)
    h_plain_ms = cuda_ms(lambda: K.feasibility(sp_tb, sp_end, g_h, -1, True), 50)
    h_b = k1_bytes(sp_tb, sp_end, g_h)
    emit("feasibility_hostname", cases=checked_h, group=g_h, nodes=sp_N,
         domains=int(sp_end.counter.shape[1]), kernel_ms=h_ms, plain_ms=h_plain_ms,
         bound_ms=h_b / HBM_BYTES_PER_S * 1e3, bytes=h_b, max_abs_err=0.0, **k1_shape(),
         card=card)
    del sp_sim, sp_bt, sp_tb, sp_seed, sp_end, no_eligible
    rows["feasibility"] = dict(source=SRC + "feasibility.cu", replaces=JAX_KERNELS + ":743",
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
        # K3c writes a new carry: every field read and written once
        # (k3c_cost); the in-place one-block form's bound beside it
        cb, cops = one_lane(k3c_cost(tb, seed))
        cb_in_place = one_lane(k3c_cost(tb, seed, out_of_place=False))[0]
        if gpu_live:
            # K3: dev_total and dev_used read once, the units 6 per device and
            # 2 per node; K3c: dev_total read (dev_used read and written: in
            # k3c_cost out of place, added in place), 8 operations per copy
            # and device
            M = int(tb.dev_total.shape[1])
            b += nbytes(tb.dev_total, seed.dev_used)
            ops += int(tb.alloc.shape[0]) * (6 * M + 2)
            cb += nbytes(tb.dev_total)
            cb_in_place += 3 * nbytes(tb.dev_total)
            cops += int(kj.sum()) * M * 8
        bound, by = bound_of(b, ops)
        c_bound, c_by = bound_of(cb, cops)
        emit("schedule_wave", case=label, nodes=int(tb.alloc.shape[0]), pods=m, cap1=bool(cap1),
             gpu_live=bool(gpu_live), block=block, kmax=kmax, placed=pp, **pst, kernel_ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bytes=b, f32_ops=ops,
             max_abs_err=err_of(kj, pj), **wave_cluster_fields(K.schedule_wave, ms, "iteration"),
             card=card)
        emit("aggregate_commit", case=label, gpu_live=bool(gpu_live), copies=int(kj.sum()),
             kernel_ms=c_ms, plain_ms=c_plain_ms, bound_ms=c_bound,
             bound_ms_in_place=bound_of(cb_in_place, cops)[0], bytes=cb,
             bytes_in_place=cb_in_place, f32_ops=cops, max_abs_err=c_err,
             **shape_fields(K.aggregate_commit), card=card)
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
    rows["aggregate_commit"] = dict(source=SRC + "aggregate_commit.cu",
                                    replaces=JAX_KERNELS + ":976", **c_row)

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
             bytes=b, f32_ops=ops, max_abs_err=err_of(kj, pj),
             **cluster_fields(K.schedule_group_serial, ms), card=card)
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
             bytes=b, f32_ops=ops, max_abs_err=err_of(kj, pj), us_per_pod=ms * 1e3 / max(pp, 1),
             **wave_cluster_fields(K.schedule_affinity_wave, ms, "epoch"), card=card)
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
    # svc-web: the Service-backed Deployment in a zoned cluster, live zoned
    # SelectorSpread, one pod an epoch by design (JAX kernels.py:1708)
    k5_ss = affinity_case("service_zoned", sim, pods,
                          lambda segs: next(s for s in segs if s[0] == "affinity" and s[5]))
    rows["schedule_affinity_wave"] = dict(source=SRC + "affinity_wave.cu",
                                          replaces=JAX_KERNELS + ":1311", **k5)
    rows["schedule_affinity_wave/ss_live"] = dict(source=SRC + "affinity_wave.cu",
                                                  replaces=JAX_KERNELS + ":1708", **k5_ss)
    scratch_cases(card)

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
         bytes=b, f32_ops=ops, max_abs_err=err, **cluster_fields(K.schedule_batch, ms),
         card=card)
    rows["schedule_batch/gpu_storage"] = dict(
        source=SRC + "schedule.cu", replaces=JAX_KERNELS + ":2265", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    kinds = sorted({int(g) for g in bt.pod_group[:P]})
    checked = k1_checks("gpu, storage", {"encoded": tb}, {"seed": seed, "end": end_k}, kinds,
                        flags, forced_too=False)
    # time K1 on a group with LVM and device volumes, against the end carry
    g_st = next(g for g in kinds if bool((tb.grp_lvm_size[g] > 0).any()))
    ms = cuda_ms(lambda: K.feasibility_kernel(tb, end_k, g_st, -1, True, **flags), 200)
    plain_ms = cuda_ms(lambda: K.feasibility(tb, end_k, g_st, -1, True, **flags), 20)
    b = k1_bytes(tb, end_k, g_st) + gpu_storage_bytes(tb, end_k)
    bound, by = bound_of(b, N * gpu_storage_ops(tb, g_st))
    emit("feasibility_gpu_storage", cases=checked, groups=len(kinds), kernel_ms=ms,
         plain_ms=plain_ms, bound_ms=bound, bytes=b, max_abs_err=0.0, **k1_shape(), card=card)
    rows["feasibility/gpu_storage"] = dict(
        source=SRC + "feasibility.cu", replaces=JAX_KERNELS + ":743", max_abs_err=0.0, ms=ms,
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
            rows["aggregate_commit/gpu_live"] = dict(source=SRC + "aggregate_commit.cu",
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

    def main_path(kind, nodes, pods, services=(), serial=False, storage_classes=(),
                  sched_config=None):
        K.reset_launch_counts()
        sim = Simulator(nodes, device="cuda", sched_config=sched_config)
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
             affinity_stats=aff_stats, census=census, golden="match",
             **({"score_weights": sim.score_w._asdict(),
                 "filter_flags": sim.filter_flags._asdict(),
                 "encoder_filters_disabled": sorted(sim.encoder.filter_disabled)}
                if sched_config is not None else {}), card=card)
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
    # preemption: the PostFilter's fits through K1 at full width, then
    # hard_waves under a KubeSchedulerConfiguration (custom score weights, a
    # kernel filter and an encoder filter disabled) on the default route
    launches.update(preempt_phase(card))
    from open_simulator_torch.api.schedconfig import parse_scheduler_config

    sched = parse_scheduler_config(SCHED_CONFIG)
    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    launches.update(main_path("sched_hard_waves", nodes, pods, sched_config=sched))
    sched_kernel_cases(sched, card)
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
    # scenario sweeps through the CLI entry point (parity on the card: every
    # lane of the examples, a 64-lane sample of bench's 256) against the JAX
    # reports, then the resident image at full width
    for spec in SWEEP_EXAMPLES:
        launches.update(run_cli_sweep(spec, card))
    launches.update(run_cli_sweep("bench", card, ("--fanout", "32")))
    serve_counts, serve_responses = serve_full_width(card)
    launches.update(serve_counts)
    # the node mesh: two ranks sharing the card, the sharded epoch paths K8, K9
    mesh_rows, mesh_launches = mesh_phase(card)
    rows.update(mesh_rows)
    launches.update(mesh_launches)
    # the scenario mesh: two ranks sharing the card, each its block of lanes
    mesh_rows, mesh_launches = scenario_mesh_phase(card, serve_responses)
    rows.update(mesh_rows)
    launches.update(mesh_launches)
    # the partitioned layout: two ranks sharing the card, each holding its
    # block of the node axis, the serial route on it (K12)
    mesh_rows, mesh_launches = partitioned_phase(card)
    rows.update(mesh_rows)
    launches.update(mesh_launches)
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
