"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of open_simulator_torch/ops/csrc from this checkout,
holds each kernel against its plain PyTorch version on the card (exact
equality: every output is a bool, an i32 or an f32 count), then drives the
port's main path, `Simulator.schedule_pods` on a 5,000-node / 50,000-pod
hard-predicate cluster and on a 100-node cluster that overflows, and holds the
results against the goldens the JAX package computed
(tests/golden/torch_port_*.json). Every phase prints one JSON line; any
mismatch or error exits non-zero. The last line is the device record.
Without a CUDA device it exits 2 and prints no result. Imports no JAX and
nothing of open_simulator_tpu.
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from open_simulator_torch.ops import build
    from open_simulator_torch.ops import kernels as K
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = smi()
    emit("device", name=name, count=torch.cuda.device_count(), smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build
    t0 = time.perf_counter()
    lib_path = build.compile_library()
    build.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc_seconds=build.build_seconds,
         library=os.path.relpath(lib_path, REPO),
         ptxas=[ln for ln in build.ptxas_log.splitlines() if "registers" in ln or "spill" in ln])

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
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    end_p, ch_p = K.schedule_batch_plain(tb, seed, pg, fn, vd, bt.n_zones)
    t1.record()
    torch.cuda.synchronize()
    plain_ms_k2 = t0.elapsed_time(t1)
    err_k2 = 0.0
    if not torch.equal(ch_k, ch_p):
        fail(f"schedule_batch choices differ at {int((ch_k != ch_p).sum())} pods")
    for f in ("requested", "nonzero", "port_used", "counter", "carrier"):
        a, b = getattr(end_k, f), getattr(end_p, f)
        if not torch.equal(a, b):
            fail(f"schedule_batch carry.{f} differs")
        err_k2 = max(err_k2, float((a.float() - b.float()).abs().max()) if a.numel() else 0.0)
    k2_ms = cuda_ms(lambda: K.schedule_batch_kernel(tb, seed, pg, fn, vd, bt.n_zones), 3)
    k2_b, k2_ops = k2_cost(tb, seed, P, pad)
    k2_bound = max(k2_b / HBM_BYTES_PER_S, k2_ops / F32_OPS_PER_S) * 1e3
    emit("schedule_batch", nodes=int(tb.alloc.shape[0]), pods=P, padded=pad, groups=len(kinds),
         placed=int((ch_k >= 0).sum()), kernel_ms=k2_ms, plain_ms=plain_ms_k2,
         bound_ms=k2_bound, bytes=k2_b, f32_ops=k2_ops, max_abs_err=err_k2, card=card)

    # ---- feasibility: K1 against its plain version, every group, seed and end carry
    checked = 0
    for label, cry in (("seed", seed), ("end", end_k)):
        for g in kinds:
            for forced in (-1, g % int(tb.alloc.shape[0])):
                f_k, s_k = K.feasibility_kernel(tb, cry, g, forced, True)
                f_p, s_p = K.feasibility(tb, cry, g, forced, True)
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

    # ---- the main path: simulate_hard, then overflow_reasons, counts from 0
    K.reset_launch_counts()
    nodes, pods = synth_cluster(5000, 50000, hard_predicates=True)
    hard = Simulator(nodes, device="cuda")
    torch.cuda.synchronize()
    t0h = time.perf_counter()
    failed = hard.schedule_pods(pods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0h
    s, e = K.schedule_batch.last_events
    hard_k2_ms = s.elapsed_time(e)
    got = summarize(hard, pods, failed)
    if got["placed"] + got["unscheduled"] != len(pods):
        fail("simulate_hard: a pod was neither placed nor reported")
    check_golden("hard", got)
    hard_counts = K.launch_counts()
    emit("simulate_hard", pods=len(pods), nodes=len(nodes), placed=got["placed"],
         unscheduled=got["unscheduled"], choices_sha256=got["choices_sha256"],
         seconds=wall, pods_per_s=len(pods) / wall, schedule_batch_kernel_ms=hard_k2_ms,
         launches=hard_counts, golden="match", card=card)

    nodes, pods = synth_cluster(100, 30000, hard_predicates=True)
    over = Simulator(nodes, device="cuda")
    t0o = time.perf_counter()
    failed = over.schedule_pods(pods)
    torch.cuda.synchronize()
    wall_o = time.perf_counter() - t0o
    got = summarize(over, pods, failed)
    check_golden("overflow", got)
    counts = K.launch_counts()
    if counts["feasibility"] - hard_counts["feasibility"] <= 0:
        fail("overflow_reasons: the feasibility kernel never launched")
    emit("overflow_reasons", pods=len(pods), nodes=len(nodes), placed=got["placed"],
         unscheduled=got["unscheduled"], reasons=len(got["reason_census"]),
         choices_sha256=got["choices_sha256"], seconds=wall_o,
         launches={k: counts[k] - hard_counts[k] for k in counts}, golden="match", card=card)
    for k, n in counts.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")

    src = "open_simulator_torch/ops/csrc/schedule.cu"
    print(json.dumps({"kernels": [
        {"name": "schedule_batch", "route": "cuda", "source": src,
         "replaces": "open_simulator_tpu/ops/kernels.py:2267", "launches": counts["schedule_batch"],
         "max_abs_err": err_k2, "ms": k2_ms, "plain_ms": plain_ms_k2, "bound_ms": k2_bound,
         "bound_by": "operations" if k2_ops / F32_OPS_PER_S > k2_b / HBM_BYTES_PER_S else "bytes",
         "library_ms": None},
        {"name": "feasibility", "route": "cuda", "source": src,
         "replaces": "open_simulator_tpu/ops/kernels.py:743", "launches": counts["feasibility"],
         "max_abs_err": 0.0, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None},
    ]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
