"""The metric catalog: every counter/gauge/histogram the port emits.

A copy of the families of `open_simulator_tpu/obs/instruments.py` that the
port's engine and flight recorder write, with the JAX package's names, help
strings and labels, so that `metrics --diff` lines up a dump of either
package with a dump of the other. Host-side only; nothing here imports
torch.

kube-scheduler parity (PARITY.md "Metrics parity" for the full table):
`simon_scheduling_attempts_total{result}` ↔ `schedule_attempts_total`,
`simon_e2e_scheduling_duration_seconds` ↔ `e2e_scheduling_duration_seconds`,
`simon_filter_rejections_total{reason}` ↔ the per-extension-point failure
accounting behind `PodUnschedulable` events.

Where the port reads a family differently from the JAX package:
- `simon_compile_cache_{hits,misses}_total` (`record_dispatch`): the CUDA
  kernels build once per process, not per shape, so a miss marks the first
  dispatch of a (kernel, static-shape) signature in the process, keyed as
  the JAX package keys its compile cache;
- `simon_reshard_bytes_total`: counted on the partitioned layout's
  dispatches (the serial route on a node mesh): the bytes of carry leaves
  whose shape or device left the rank's block, which no collective moves
  back (there is no ICI); 0 by construction, as in JAX;
- `simon_stream_chunks_total`: the port schedules the chunks one after the
  other, with no prefetch thread for the next chunk's signatures;
- `simon_filter_rejections_total` (`record_filter_reasons`): the engine
  adds the reasons of the failed pods of one (group, forced, segment) key
  in one update per label, not one per pod: the same totals, without
  updates that grow with failed pods times nodes (a GPU-share failure has
  one label per failing node).

Left out, with the writers they wait for (ROADMAP A9 unless named):
- `install_jax_monitoring` and the XLA compile families
  (`simon_xla_backend_compiles_total`, `..._compile_seconds_total`): JAX only;
- `simon_segment_wall_seconds_total` (OPEN_SIMULATOR_SEGMENT_TIMING);
- the probe-session, serve, serve-HA, sync, sweep and capacity-search
  families: the port's ProbeSession, ResidentImage, SweepRunner and
  CapacityPlanner record xray probe counts only (serve HA and sync: A10);
- the resilience and guard families (`simon_retries_total`,
  `simon_deadline_exceeded_total`, `simon_breaker_state`,
  `simon_faults_injected_total`, `simon_http_errors_total`,
  `simon_guard_*`, `simon_journal_*`);
- the scope (`simon_scope_*`) and pulse (`simon_pulse_*`) families, and the
  pulse hook of `record_dispatch`.
"""

from __future__ import annotations

import threading
from typing import Dict, Set, Tuple

from .metrics import PODS_BUCKETS, SECONDS_BUCKETS, counter, histogram

# ------------------------------------------------------------------ engine ----

SCHED_ATTEMPTS = counter(
    "simon_scheduling_attempts_total",
    "Pod scheduling attempts by outcome (kube-scheduler "
    "schedule_attempts_total). bound = pre-bound direct commit; homeless = "
    "bound to an unknown node (dropped from reports, reference parity).",
    ("result",))  # scheduled | unschedulable | bound | homeless
E2E_SECONDS = histogram(
    "simon_e2e_scheduling_duration_seconds",
    "Wall seconds per schedule_pods call, end to end "
    "(kube-scheduler e2e_scheduling_duration_seconds).",
    buckets=SECONDS_BUCKETS)
ENCODE_SECONDS = histogram(
    "simon_encode_seconds",
    "Host-side batch encode time (pods -> device tables) per scheduling run.",
    buckets=SECONDS_BUCKETS)
HOST_COMMIT_SECONDS = histogram(
    "simon_host_commit_seconds",
    "Host-side commit time per scheduling run: placements applied to the "
    "placed census / per-node registry / pod state after the device fetch "
    "(the encode/commit/device decomposition of "
    "simon_e2e_scheduling_duration_seconds — ROADMAP item 2's 60%-of-wall "
    "slice, now measured on every run).",
    buckets=SECONDS_BUCKETS)
ENCODE_BYTES = counter(
    "simon_encode_bytes_total",
    "Host bytes of encoded batch tables + carry seeds produced per "
    "scheduling/probe run (batch_tables_nbytes at encode time; the "
    "device-transfer counter tracks the same bytes at staging).")
STREAM_CHUNKS = counter(
    "simon_stream_chunks_total",
    "Scheduling runs dispatched as streaming chunks "
    "(OPEN_SIMULATOR_STREAM_PODS): host encode of chunk k+1 overlaps the "
    "device dispatch of chunk k.")
BATCH_PODS = histogram(
    "simon_batch_pods",
    "Pods per contiguous unbound scheduling run handed to the device.",
    buckets=PODS_BUCKETS)
SEGMENTS = counter(
    "simon_segments_total",
    "Device dispatch segments by kind (wave / affinity / spread / serial).",
    ("kind",))
SEGMENT_PODS = counter(
    "simon_segment_pods_total",
    "Pods carried by device dispatch segments, by segment kind.",
    ("kind",))
TRANSFER_BYTES = counter(
    "simon_device_transfer_bytes_total",
    "Host->device bytes staged for scheduling/probe table uploads.")
RESHARD_BYTES = counter(
    "simon_reshard_bytes_total",
    "Bytes of carry state whose post-dispatch sharding layout diverged from "
    "the declared carry shardings — what a chained dispatch would have to "
    "move across ICI to reconcile. The sharded executables pin out_shardings "
    "to in_shardings, so this stays 0; nonzero means a mesh dispatch path "
    "dropped its explicit shardings (parallel/mesh.py carry_reshard_bytes).")
COMMITS = counter(
    "simon_commits_total",
    "Pods committed onto nodes (placements materialized on cluster state). "
    "Monotonic reconciliation: commits - simon_commit_rollbacks_total - "
    "simon_preemption_victims_total = placements currently live.")
COMMIT_ROLLBACKS = counter(
    "simon_commit_rollbacks_total",
    "Commits undone by preemption rewinds (the replay then re-commits and "
    "re-counts them; see simon_commits_total for the reconciliation).")
FILTER_REJECTIONS = counter(
    "simon_filter_rejections_total",
    "Per-node filter-stage rejections behind failed pods, keyed by the "
    "FitError reason label (_reasons_from_stages) — the per-extension-point "
    "failure accounting of kube-scheduler's framework metrics.",
    ("reason",))

# -------------------------------------------------------------- preemption ----

PREEMPT_ATTEMPTS = counter(
    "simon_preemption_attempts_total",
    "PostFilter runs for failed pods, by outcome (kube-scheduler "
    "preemption_attempts_total).",
    ("outcome",))  # nominated | no_candidates | capped
PREEMPT_VICTIMS = counter(
    "simon_preemption_victims_total",
    "Pods evicted by preemption (kube-scheduler preemption_victims).")
PREEMPT_REPLAY_PODS = counter(
    "simon_preemption_replay_pods_total",
    "Pods re-scheduled by rewind/replay passes — the simulator-specific "
    "cost of exact mid-batch preemption (PARITY.md cost envelope).")

# compile-cache accounting: a dispatch whose static shape signature was seen
# before in this process is a hit; a fresh signature is a miss.
COMPILE_HITS = counter(
    "simon_compile_cache_hits_total",
    "Kernel dispatches whose static shape bucket was already compiled.",
    ("kernel",))
COMPILE_MISSES = counter(
    "simon_compile_cache_misses_total",
    "Kernel dispatches that triggered a fresh compile, with the shape "
    "bucket that triggered it.",
    ("kernel", "shape"))

# ------------------------------------------------------------------- xray -----
# simonxray (obs/xray.py): both counters are LABELED on purpose — an
# untouched labeled family renders no samples, so a recording-off run's
# --metrics-out output stays byte-identical to a run without the recorder.

XRAY_RECORDS = counter(
    "simon_xray_records_total",
    "Flight-recorder records committed, by kind (batch / pod / set / "
    "preempt / probe). Zero unless --xray / OPEN_SIMULATOR_XRAY=1.",
    ("kind",))
XRAY_DROPPED = counter(
    "simon_xray_dropped_total",
    "Flight-recorder records dropped by the bounded-memory caps, by kind "
    "(set: OPEN_SIMULATOR_XRAY_MAX_SETS; pod_index: the in-memory explain "
    "index, the JSONL trace keeps everything). Never silent: the first "
    "drop logs a warning.",
    ("kind",))

# ------------------------------------------------- dispatch shape tracking ----

_SEEN_SHAPES: Set[Tuple] = set()
_SEEN_LOCK = threading.Lock()


def record_dispatch(kernel: str, **dims) -> bool:
    """Count one kernel dispatch against the shape-signature cache: the
    first time a (kernel, static-shape) signature is seen in this process
    it is a miss, afterwards a hit. `dims` holds exactly the dispatch's
    static/shape-defining parts. Returns True on a miss."""
    key = (kernel,) + tuple(sorted(dims.items()))
    with _SEEN_LOCK:
        miss = key not in _SEEN_SHAPES
        if miss:
            _SEEN_SHAPES.add(key)
    if miss:
        shape = ",".join(f"{k}={v}" for k, v in sorted(dims.items()))
        COMPILE_MISSES.labels(kernel=kernel, shape=shape).inc()
    else:
        COMPILE_HITS.labels(kernel=kernel).inc()
    return miss


def record_filter_reasons(reasons: Dict[str, int], pods: int = 1) -> None:
    """Fold the FitError reason counts (label -> node count) of `pods`
    failed pods that share them into the rejection counters (the counts are
    whole numbers, so one update per label equals one per pod)."""
    for label, n in reasons.items():
        FILTER_REJECTIONS.labels(reason=label).inc(n * pods)
