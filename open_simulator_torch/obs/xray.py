"""simonxray: the per-pod scheduling flight recorder.

A copy of `open_simulator_tpu/obs/xray.py` (host code, numpy and the
standard library only), kept so that the port imports nothing of the JAX
package; the traces the two packages write are the same format.

The reference's most-consumed output is not placements but *explanations*:
kube-scheduler's `FailedScheduling` event strings ("0/N nodes are available:
X Insufficient cpu, ...") and the unschedulable-pod report. The batched
wave/affinity kernels made the hot path fast but opaque — aggregate
`simon_filter_rejections_total{reason}` counters cannot answer "why THIS
pod, on THIS node, in THIS wave". simonxray records, per pod, a compact
decision record:

- **segment attribution**: which dispatch batch / segment (kind, group,
  epoch/round/head-fallback stats for affinity waves) placed or failed it;
- **per-plugin filter bitmask over nodes**: the named per-stage feasibility
  masks (ops/kernels.explain_jit: K7 on the card), fetched ONCE per
  committed (group, segment) — never per pod, never inside the dispatch
  loop;
- **per-plugin score vector**: weighted component scores
  (kernels.score_components) for the top-k candidate nodes with margins,
  plus the full [N] total/component arrays in the npz sidecar;
- **kube-parity reason strings** for unschedulable pods (the engine's
  FitError text, whose per-reason node counts sum to N).

Recording is OPT-IN (`apply --xray`, `OPEN_SIMULATOR_XRAY=1`) and zero-cost
when off: the engine takes one `xray.begin_run()` None-check per
schedule/probe call and dispatches nothing extra. When on, the trace spills
to a columnar JSONL file (one line per batch, pods as parallel arrays) plus
an `.npz` sidecar for the full-width mask/score arrays, and is queryable as
`explain POD` and through the decision annotations carried by each
schedule_run span in the `--trace-out` Chrome trace.

Records stage per engine call and only commit after the call succeeds: a
call that raised never leaves records, and committed records carry the
simulator's backend_path (`["cuda"]` or `["cpu"]`).

Record kinds (first JSONL line is the header):

    {"kind": "header", "version": 1, ...}
    {"kind": "nodes", "id": H, "names": [...]}          # deduped node lists
    {"kind": "set",   "id": S, ...}                     # per (group, segment)
    {"kind": "batch", "id": B, "pods": [...], ...}      # columnar pod rows
    {"kind": "preempt", "pod": ..., "victims": [...]}   # (no writer in the port yet)
    {"kind": "probe", "scheduled": X, "total": Y, ...}

Everything here is host-side and numpy/stdlib-only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import instruments as obs

# Stage names in the engine's diagnosis order (engine._STAGE_ORDER plus the
# root static mask); each packs one [N] feasibility-mask row per set.
STAGE_NAMES = (
    "static", "unsched", "taint", "affinity", "extra", "ports", "fit",
    "spread", "pod_affinity", "pod_anti", "gpu", "storage",
)

# Per-plugin score component names, mirroring ops/kernels.COMPONENT_ORDER.
# Duplicated HERE (tests/test_torch_xray.py asserts equality) so the offline
# query path — `explain` over a saved trace — never imports torch.
COMPONENT_NAMES = (
    "least", "balanced", "openlocal", "simon", "nodeaff", "taint",
    "interpod", "selector_spread", "topology_spread", "avoid", "image",
    "extra",
)

# Result codes for the columnar pod rows (compact ints, stable on disk).
SCHEDULED, UNSCHEDULABLE, BOUND, HOMELESS, PREEMPTED = 0, 1, 2, 3, 4
RESULT_NAMES = {
    SCHEDULED: "scheduled",
    UNSCHEDULABLE: "unschedulable",
    BOUND: "bound",           # pre-bound spec.nodeName direct commit
    HOMELESS: "homeless",     # bound to an unknown node (dropped from reports)
    PREEMPTED: "preempted",   # evicted by a higher-priority preemptor
}

VERSION = 1


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:  # tuning knob: fall back, don't crash
        return default


def pod_key(pod: dict) -> str:
    """The index key for a pod: 'namespace/name' (kube event addressing)."""
    md = pod.get("metadata") or {}
    return f"{md.get('namespace') or 'default'}/{md.get('name') or ''}"


# ------------------------------------------------------------------ staging ----


class XrayBatch:
    """Columnar staging for one dispatch batch (one `_dispatch_and_commit` /
    direct-commit stretch): parallel pod-row arrays plus batch metadata."""

    __slots__ = ("nodes_names", "cfg", "segments", "call", "pods", "result",
                 "node", "seg", "set_ids", "reasons", "groups")

    def __init__(self, nodes_names: List[str], cfg: str,
                 segments: List[dict], call: str) -> None:
        self.nodes_names = nodes_names
        self.cfg = cfg
        self.segments = segments  # [{kind,start,len,group,...,stats?}]
        self.call = call
        self.pods: List[str] = []
        self.result: List[int] = []
        self.node: List[int] = []
        self.seg: List[int] = []
        self.set_ids: List[int] = []
        self.groups: List[int] = []
        self.reasons: Dict[int, str] = {}  # row -> FitError reason string

    def add_pod(self, key: str, result: int, node_i: int, seg: int,
                set_id: int, group: int = -1,
                reason: Optional[str] = None) -> None:
        if reason is not None:
            self.reasons[len(self.pods)] = reason
        self.pods.append(key)
        self.result.append(result)
        self.node.append(node_i)
        self.seg.append(seg)
        self.set_ids.append(set_id)
        self.groups.append(group)


class XraySet:
    """One decision set: the per-stage masks and per-plugin scores for a
    (group, forced, segment) key, computed once and shared by every pod of
    that key. Arrays are full-width [N]; the JSONL record carries counts and
    the top-k table, the arrays go to the npz sidecar / in-memory store."""

    __slots__ = ("group", "forced", "seg", "n_feasible", "stage_reject",
                 "mask_bits", "feas_bits", "total", "comp", "topk", "reasons")

    def __init__(self, group: int, forced: int, seg: int,
                 stages: Dict[str, np.ndarray], total: np.ndarray,
                 comp: Dict[str, np.ndarray], feasible: np.ndarray,
                 node_names: List[str], topk: int = 8) -> None:
        self.group, self.forced, self.seg = group, forced, seg
        N = int(total.shape[0])
        self.n_feasible = int(feasible.sum())
        mask_rows = np.stack([np.asarray(stages[s], bool)
                              for s in STAGE_NAMES])          # [stages, N]
        self.stage_reject = {
            s: int(N - mask_rows[i].sum()) for i, s in enumerate(STAGE_NAMES)
            if int(N - mask_rows[i].sum())
        }
        self.mask_bits = np.packbits(mask_rows, axis=1)       # [stages, ⌈N/8⌉]
        self.feas_bits = np.packbits(np.asarray(feasible, bool))  # [⌈N/8⌉]
        self.total = np.asarray(total, np.float32)
        self.comp = np.stack([np.asarray(comp[c], np.float32)
                              for c in COMPONENT_NAMES])      # [C, N]
        self.reasons: Optional[Dict[str, int]] = None  # failed sets only
        # top-k candidates under serial's exact tie-break (score desc, node
        # index asc) — the chosen node of the segment's first pick is topk[0]
        idx = np.nonzero(np.asarray(feasible, bool))[0]
        self.topk = []
        if idx.size:
            order = idx[np.lexsort((idx, -self.total[idx]))][:topk]
            best = float(self.total[order[0]])
            for i in order:
                self.topk.append({
                    "node": node_names[int(i)],
                    "total": round(float(self.total[i]), 4),
                    "margin": round(best - float(self.total[i]), 4),
                    "components": {
                        c: round(float(self.comp[ci, i]), 4)
                        for ci, c in enumerate(COMPONENT_NAMES)
                    },
                })

    def record(self, sid: int, batch: int) -> dict:
        rec = {
            "kind": "set", "id": sid, "batch": batch, "group": self.group,
            "forced": self.forced, "seg": self.seg,
            "n_feasible": self.n_feasible,
            "stage_reject": self.stage_reject, "topk": self.topk,
        }
        if self.reasons is not None:
            rec["reasons"] = self.reasons
        return rec


class XrayRun:
    """Per-attempt staging for one schedule/probe call. Thrown away when the
    attempt fails (the transaction rolled the placements back too); committed
    to the recorder — with the final backend_path — on success."""

    def __init__(self, recorder: "XrayRecorder", call: str) -> None:
        self.recorder = recorder
        self.call = call
        self.batches: List[XrayBatch] = []
        self.sets: List[XraySet] = []
        self.preempts: List[dict] = []
        self.probes: List[dict] = []

    def new_batch(self, nodes_names: List[str], cfg: str,
                  segments: List[dict]) -> XrayBatch:
        b = XrayBatch(nodes_names, cfg, segments, self.call)
        self.batches.append(b)
        return b

    def add_set(self, s: XraySet) -> int:
        """Stage a decision set; returns its run-local id (remapped to a
        recorder-global id at commit). The set belongs to the batch being
        processed — always the latest staged one (the engine builds sets
        inside that batch's commit loop)."""
        self.sets.append((len(self.batches) - 1, s))
        return len(self.sets) - 1

    def add_preempt(self, preemptor: str, node: str, victims: List[str],
                    reason: str, reasons: Dict[str, int],
                    nominated: bool) -> None:
        self.preempts.append({
            "kind": "preempt", "pod": preemptor, "node": node,
            "victims": victims, "reason": reason, "reasons": reasons,
            "nominated": nominated,
        })

    def add_probe(self, scheduled: int, total: int,
                  candidate: Optional[int] = None) -> None:
        rec = {"kind": "probe", "scheduled": scheduled, "total": total}
        if candidate is not None:
            rec["candidate_nodes"] = candidate
        self.probes.append(rec)


# ----------------------------------------------------------------- recorder ----


class XrayRecorder:
    """The process-wide flight recorder: commits staged runs to the columnar
    JSONL trace (plus npz sidecar at close) and keeps a bounded in-memory
    index for `GET /explain/<pod>` / `/debug/vars`."""

    def __init__(self, path: Optional[str] = None,
                 max_sets: Optional[int] = None,
                 max_pods_mem: Optional[int] = None) -> None:
        self.path = path  # prefix: writes <path>.jsonl + <path>.npz
        self.max_sets = (max_sets if max_sets is not None
                         else _env_int("OPEN_SIMULATOR_XRAY_MAX_SETS", 4096))
        self.max_pods_mem = (
            max_pods_mem if max_pods_mem is not None
            else _env_int("OPEN_SIMULATOR_XRAY_MAX_PODS", 500_000))
        self._lock = threading.Lock()
        self._f = None
        self._next_set = 0
        self._next_batch = 0
        self._sets: Dict[int, dict] = {}          # sid -> set record
        self._arrays: Dict[str, np.ndarray] = {}  # npz payload (bounded)
        self._nodes: Dict[int, List[str]] = {}    # nodes-list id -> names
        self._node_ids: Dict[int, int] = {}       # content hash -> nodes id
        self._index: Dict[str, dict] = {}         # pod key -> resolved row
        self._unscheduled: Dict[str, str] = {}    # pod key -> reason string
        # LAZY indexing: building one row dict per pod costs ~2-3us x pods,
        # which on a 100k-pod run is most of the recording overhead — so
        # commit() only queues the (already-serialized) batch/preempt
        # records and the query paths index on demand. _PENDING_FLUSH bounds
        # the queue for long-lived unqueried servers.
        self._pending: List[Tuple[str, dict]] = []
        self._pod_rows = 0          # committed pod rows (exact, cheap)
        self._unscheduled_rows = 0  # result==UNSCHEDULABLE rows (pre-index)
        self._dropped_sets = 0
        self._warned_cap = False
        self.closed = False

    _PENDING_FLUSH = 512  # index inline once this many records queue up

    # ------------------------------------------------------------- writing --

    def _file_locked(self):
        if self.path and self._f is None:
            self._f = open(self.path + ".jsonl", "w", encoding="utf-8")
            self._write_locked(self._header())
        return self._f

    def _header(self) -> dict:
        return {
            "kind": "header", "xray": VERSION, "version": VERSION,
            "pid": os.getpid(), "created_unix": round(time.time(), 3),
            "stage_names": list(STAGE_NAMES),
            "component_names": list(_component_order()),
        }

    def _write_locked(self, rec: dict) -> None:
        f = self._f
        if f is not None:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def _nodes_id(self, names: List[str]) -> int:
        # content-keyed dedupe (NOT id(): a freed list's id can be reused):
        # capacity searches re-simulate over near-identical clusters, so one
        # nodes record serves every batch that shares the name list
        key = hash(tuple(names))
        nid = self._node_ids.get(key)
        if nid is None:
            nid = len(self._nodes)
            self._node_ids[key] = nid
            self._nodes[nid] = list(names)
            self._write_locked({"kind": "nodes", "id": nid, "names": self._nodes[nid]})
        return nid

    def commit(self, run: XrayRun, backend_path: List[str],
               cfg_digest: str = "") -> None:
        """Fold one successful call's staging into the trace + index."""
        with self._lock:
            if self.closed:
                return
            self._file_locked()
            sid_of: Dict[int, int] = {}
            dropped = 0
            first_bid = self._next_batch  # run-local batch k -> first_bid + k
            for local, (batch_local, s) in enumerate(run.sets):
                if len(self._sets) >= self.max_sets:
                    dropped += 1
                    sid_of[local] = -1
                    continue
                sid = self._next_set
                self._next_set += 1
                sid_of[local] = sid
                rec = s.record(sid, first_bid + max(batch_local, 0))
                self._sets[sid] = rec
                self._arrays[f"s{sid}_total"] = s.total
                self._arrays[f"s{sid}_comp"] = s.comp
                self._arrays[f"s{sid}_mask"] = s.mask_bits
                self._arrays[f"s{sid}_feas"] = s.feas_bits
                self._write_locked(rec)
                obs.XRAY_RECORDS.labels(kind="set").inc()
            if dropped:
                # counted on EVERY commit that drops (not only the first):
                # the never-silent contract is a running total in /metrics
                self._dropped_sets += dropped
                obs.XRAY_DROPPED.labels(kind="set").inc(dropped)
                if not self._warned_cap:
                    self._warned_cap = True
                    import logging

                    logging.getLogger("open_simulator_torch").warning(
                        "xray: decision-set cap reached (%d); later sets are "
                        "dropped (pods keep their rows with set=-1; raise "
                        "OPEN_SIMULATOR_XRAY_MAX_SETS to keep them)",
                        self.max_sets)
            # last-writer-wins pod ownership: preemption rewind/replay stages
            # a pod's row more than once within one call; only the final row
            # describes the committed outcome
            owner: Dict[str, Tuple[int, int]] = {}
            for bi, b in enumerate(run.batches):
                for ri, key in enumerate(b.pods):
                    owner[key] = (bi, ri)
            for bi, b in enumerate(run.batches):
                keep = [ri for ri, key in enumerate(b.pods)
                        if owner.get(key) == (bi, ri)]
                bid = self._next_batch
                self._next_batch += 1
                rec = {
                    "kind": "batch", "id": bid, "call": b.call,
                    "cfg": b.cfg or cfg_digest,
                    "backend_path": list(backend_path),
                    "nodes": self._nodes_id(b.nodes_names),
                    "n_nodes": len(b.nodes_names),
                    "segments": b.segments,
                    "pods": [b.pods[ri] for ri in keep],
                    "result": [b.result[ri] for ri in keep],
                    "node": [b.node[ri] for ri in keep],
                    "seg": [b.seg[ri] for ri in keep],
                    "set": [sid_of.get(b.set_ids[ri], -1) if b.set_ids[ri] >= 0
                            else -1 for ri in keep],
                    "group": [b.groups[ri] for ri in keep],
                    "reasons": {str(new_ri): b.reasons[ri]
                                for new_ri, ri in enumerate(keep)
                                if ri in b.reasons},
                }
                self._write_locked(rec)
                obs.XRAY_RECORDS.labels(kind="batch").inc()
                obs.XRAY_RECORDS.labels(kind="pod").inc(len(keep))
                self._pod_rows += len(keep)
                self._unscheduled_rows += rec["result"].count(UNSCHEDULABLE)
                self._pending.append(("batch", rec))
            for p in run.preempts:
                p = dict(p, backend_path=list(backend_path))
                self._write_locked(p)
                obs.XRAY_RECORDS.labels(kind="preempt").inc()
                self._pending.append(("preempt", p))
            for p in run.probes:
                p = dict(p, backend_path=list(backend_path))
                self._write_locked(p)
                obs.XRAY_RECORDS.labels(kind="probe").inc()
            if len(self._pending) >= self._PENDING_FLUSH:
                self._reindex_locked()
            f = self._f
            if f is not None:
                f.flush()

    def _reindex_locked(self) -> None:
        """Fold queued batch/preempt records into the explain index (caller
        holds the lock). Replayed in commit order so preempt overrides land
        after the rows they amend."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for kind, rec in pending:
            if kind == "batch":
                _index_batch_into(self._index, self._unscheduled, rec)
            else:
                _apply_preempt(self._index, self._unscheduled, rec)
        # bound the in-memory index (the JSONL keeps everything)
        over = len(self._index) - self.max_pods_mem
        if over > 0:
            for key in list(self._index)[:over]:
                self._index.pop(key, None)
                self._unscheduled.pop(key, None)
            obs.XRAY_DROPPED.labels(kind="pod_index").inc(over)

    # ------------------------------------------------------------- queries --

    def explain(self, pod: str) -> Optional[dict]:
        """Resolved decision record for a pod key ('ns/name', or bare name
        matched across namespaces), or None."""
        with self._lock:
            self._reindex_locked()
            return _resolve(self._index, self._sets, self._nodes,
                            self._arrays, pod)

    def unscheduled_summary(self, limit: int = 256) -> List[dict]:
        with self._lock:
            self._reindex_locked()
            items = list(self._unscheduled.items())[-limit:]
        return [{"pod": k, "reason": r} for k, r in items]

    def counts(self) -> dict:
        # cheap by design (no reindex): _pod_rows/_unscheduled_rows track raw
        # committed rows; the indexed views refine them on first query
        with self._lock:
            return {
                "pods": self._pod_rows,
                "unscheduled": self._unscheduled_rows,
                "sets": len(self._sets),
                "dropped_sets": self._dropped_sets,
                "batches": self._next_batch,
                "path": self.path,
            }

    def close(self) -> None:
        """Flush + close the JSONL and write the npz sidecar."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            if self._f is not None:
                self._f.close()
                self._f = None
            if self.path and self._arrays:
                np.savez_compressed(self.path + ".npz", **self._arrays)


# ------------------------------------------------------------- shared resolve --


def _component_order() -> Tuple[str, ...]:
    return COMPONENT_NAMES


def _index_batch_into(index: Dict[str, dict], unscheduled: Dict[str, str],
                      rec: dict) -> None:
    segments = rec.get("segments") or []
    for ri, key in enumerate(rec.get("pods") or []):
        seg_i = rec["seg"][ri]
        seg = segments[seg_i] if 0 <= seg_i < len(segments) else None
        result = rec["result"][ri]
        row = {
            "pod": key, "result": result, "batch": rec["id"],
            "call": rec.get("call", "schedule"),
            "node": rec["node"][ri], "seg": seg_i, "segment": seg,
            "set": rec["set"][ri], "group": rec["group"][ri],
            "nodes": rec.get("nodes", -1),
            "n_nodes": rec.get("n_nodes", 0),
            "backend_path": rec.get("backend_path") or [],
            "reason": (rec.get("reasons") or {}).get(str(ri)),
        }
        index[key] = row
        if result == UNSCHEDULABLE and row["reason"]:
            unscheduled[key] = row["reason"]
        else:
            unscheduled.pop(key, None)


def _apply_preempt(index: Dict[str, dict], unscheduled: Dict[str, str],
                   rec: dict) -> None:
    key = rec["pod"]
    row = index.get(key)
    if row is None:
        row = index[key] = {"pod": key, "result": UNSCHEDULABLE, "node": -1,
                            "set": -1, "seg": -1, "segment": None,
                            "group": -1, "batch": -1, "nodes": -1,
                            "n_nodes": 0, "call": "schedule",
                            "backend_path": rec.get("backend_path") or []}
    row["result"] = UNSCHEDULABLE
    row["reason"] = rec.get("reason")
    row["reasons"] = rec.get("reasons")
    if rec.get("nominated"):
        row["nominated_node"] = rec.get("node")
    row["victims"] = rec.get("victims") or []
    if row["reason"]:
        unscheduled[key] = row["reason"]
    for v in rec.get("victims") or []:
        vrow = index.get(v)
        if vrow is not None:
            vrow["result"] = PREEMPTED
            vrow["preempted_by"] = key
            unscheduled.pop(v, None)


def _resolve(index: Dict[str, dict], sets: Dict[int, dict],
             nodes: Dict[int, List[str]], arrays: Dict[str, np.ndarray],
             pod: str) -> Optional[dict]:
    row = index.get(pod)
    if row is None and "/" not in pod:
        # bare name: match across namespaces, unique hit only
        hits = [r for k, r in index.items() if k.split("/", 1)[-1] == pod]
        if len(hits) == 1:
            row = hits[0]
    if row is None:
        return None
    out = dict(row)
    out["result_name"] = RESULT_NAMES.get(row["result"], str(row["result"]))
    names = nodes.get(row.get("nodes", -1)) or []
    ni = row.get("node", -1)
    out["node_name"] = names[ni] if 0 <= ni < len(names) else None
    sid = row.get("set", -1)
    srec = sets.get(sid)
    if srec is not None:
        out["set_record"] = srec
        total = arrays.get(f"s{sid}_total")
        comp = arrays.get(f"s{sid}_comp")
        feas = arrays.get(f"s{sid}_feas")
        if total is not None and 0 <= ni < total.shape[0]:
            # margin vs the best FEASIBLE node: infeasible nodes can carry
            # high raw totals (the chooser masks them to -inf, the stored
            # per-plugin vectors do not), so the chosen node's margin must
            # be measured inside the feasible set it actually won
            if feas is not None:
                fmask = np.unpackbits(feas)[:total.shape[0]].astype(bool)
            else:
                fmask = np.ones(total.shape[0], bool)
            best = float(total[fmask].max()) if fmask.any() else float(total[ni])
            out["node_scores"] = {
                "total": round(float(total[ni]), 4),
                "margin": round(best - float(total[ni]), 4),
                "components": {
                    c: round(float(comp[ci, ni]), 4)
                    for ci, c in enumerate(_component_order())
                } if comp is not None else {},
            }
    return out


# --------------------------------------------------------------- trace files ---


class XrayTrace:
    """A trace loaded back from `<prefix>.jsonl` (+ optional `.npz`): the
    offline query surface behind `simon explain`."""

    def __init__(self) -> None:
        self.header: dict = {}
        self.index: Dict[str, dict] = {}
        self.unscheduled: Dict[str, str] = {}
        self.sets: Dict[int, dict] = {}
        self.nodes: Dict[int, List[str]] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        self.probes: List[dict] = []

    @classmethod
    def load(cls, prefix: str) -> "XrayTrace":
        """Load a trace by prefix (accepts the .jsonl path too)."""
        if prefix.endswith(".jsonl"):
            prefix = prefix[:-len(".jsonl")]
        tr = cls()
        with open(prefix + ".jsonl", encoding="utf-8") as f:
            first = True
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.get("kind")
                if first:
                    if kind != "header" or rec.get("xray") != VERSION:
                        raise ValueError(
                            f"{prefix}.jsonl is not a simonxray v{VERSION} "
                            "trace")
                    tr.header = rec
                    first = False
                    continue
                if kind == "nodes":
                    tr.nodes[rec["id"]] = rec["names"]
                elif kind == "set":
                    tr.sets[rec["id"]] = rec
                elif kind == "batch":
                    _index_batch_into(tr.index, tr.unscheduled, rec)
                elif kind == "preempt":
                    _apply_preempt(tr.index, tr.unscheduled, rec)
                elif kind == "probe":
                    tr.probes.append(rec)
            if first:
                raise ValueError(f"{prefix}.jsonl is empty")
        npz = prefix + ".npz"
        if os.path.exists(npz):
            with np.load(npz) as z:
                tr.arrays = {k: z[k] for k in z.files}
        return tr

    def explain(self, pod: str) -> Optional[dict]:
        return _resolve(self.index, self.sets, self.nodes, self.arrays, pod)

    def unscheduled_summary(self) -> List[dict]:
        return [{"pod": k, "reason": r} for k, r in self.unscheduled.items()]


# ---------------------------------------------------------------- rendering ----


def render_explanation(exp: dict) -> str:
    """Human rendering of a resolved decision record, leading with the
    kube-scheduler-parity event line (PARITY.md "Event parity")."""
    lines = [f"pod: {exp['pod']}"]
    seg = exp.get("segment") or {}
    attrib = []
    if exp.get("batch", -1) >= 0:
        attrib.append(f"batch {exp['batch']}")
    if seg:
        s = f"segment {exp.get('seg')} [{seg.get('kind')}]"
        st = seg.get("stats")
        if st:
            s += (f" epochs={st.get('epochs')} rounds={st.get('rounds')}"
                  f" head_fallbacks={st.get('head_fallbacks')}")
        attrib.append(s)
    if exp.get("group", -1) >= 0:
        attrib.append(f"group {exp['group']}")
    bp = exp.get("backend_path") or []
    if bp:
        attrib.append("backend_path=" + "->".join(bp))
    result = exp.get("result_name", "?")
    lines.append(f"result: {result}"
                 + (f" ({', '.join(attrib)})" if attrib else ""))
    if result == "scheduled":
        # kube event: reason=Scheduled, message as emitted by the binder
        lines.append(f"event: Scheduled: Successfully assigned "
                     f"{exp['pod']} to {exp.get('node_name')}")
    elif result == "preempted":
        lines.append(f"event: Preempted: pod evicted by "
                     f"{exp.get('preempted_by')} (preemption victim)")
    elif result == "bound":
        lines.append(f"event: Scheduled: pod was pre-bound to "
                     f"{exp.get('node_name')} (no scheduling cycle)")
    elif result == "homeless":
        lines.append("event: pod bound to a node this cluster does not know "
                     "(dropped from reports, reference parity)")
    else:
        reason = exp.get("reason") or ""
        # the engine reason string is "failed to schedule pod (ns/name):
        # Unschedulable: 0/N nodes are available: ..."; the event form is the
        # kube FailedScheduling message after the status reason
        msg = reason.split(": ", 2)[-1] if reason else "no record"
        lines.append(f"event: FailedScheduling: {msg}")
        if exp.get("nominated_node"):
            lines.append(f"nominated node: {exp['nominated_node']} "
                         f"(victims evicted; pod recorded unschedulable with "
                         f"status.nominatedNodeName, reference parity)")
        if exp.get("victims"):
            lines.append("preemption victims: " + ", ".join(exp["victims"]))
    ns = exp.get("node_scores")
    if ns:
        comps = " ".join(f"{k}={v:g}" for k, v in ns["components"].items()
                         if v)
        lines.append(f"node score ({exp.get('node_name')}): "
                     f"total={ns['total']:g} margin_to_best={ns['margin']:g}"
                     + (f"  [{comps}]" if comps else ""))
    srec = exp.get("set_record")
    if srec:
        rej = srec.get("stage_reject") or {}
        lines.append(f"filter masks (segment start): "
                     f"{srec.get('n_feasible')} feasible node(s)"
                     + ("; per-stage rejections: "
                        + ", ".join(f"{k}={v}" for k, v in rej.items())
                        if rej else ""))
        top = srec.get("topk") or []
        if top:
            lines.append("top candidates (score desc, node asc):")
            for t in top:
                comps = " ".join(f"{k}={v:g}" for k, v in
                                 (t.get("components") or {}).items() if v)
                lines.append(f"  {t['node']}: total={t['total']:g} "
                             f"margin={t['margin']:g}"
                             + (f"  [{comps}]" if comps else ""))
    return "\n".join(lines)


# ------------------------------------------------------------- module gate -----

_RECORDER: Optional[XrayRecorder] = None
_ENV_CHECKED = False
_LOCK = threading.Lock()


def enable(path: Optional[str] = None, **kw) -> XrayRecorder:
    """Activate the process recorder (idempotent when already active)."""
    global _RECORDER, _ENV_CHECKED
    with _LOCK:
        _ENV_CHECKED = True
        if _RECORDER is None or _RECORDER.closed:
            _RECORDER = XrayRecorder(path, **kw)
        return _RECORDER


def disable() -> None:
    """Close and detach the process recorder (tests / end of CLI run)."""
    global _RECORDER, _ENV_CHECKED
    with _LOCK:
        rec = _RECORDER
        _RECORDER = None
        _ENV_CHECKED = False
    if rec is not None:
        rec.close()


def active() -> Optional[XrayRecorder]:
    """The live recorder, auto-created from OPEN_SIMULATOR_XRAY=1 /
    OPEN_SIMULATOR_XRAY_OUT on first use. None when recording is off — the
    engine's whole obligation when off is this one None-check."""
    global _RECORDER, _ENV_CHECKED
    if _RECORDER is not None:
        return _RECORDER
    # double-checked init: _ENV_CHECKED is set under _LOCK before any
    # recorder publish, and a stale False only routes this reader through
    # the locked slow path once more
    if _ENV_CHECKED:
        return None
    with _LOCK:
        if not _ENV_CHECKED:
            _ENV_CHECKED = True
            if os.environ.get("OPEN_SIMULATOR_XRAY", "") not in (
                    "", "0", "false", "no"):
                _RECORDER = XrayRecorder(
                    os.environ.get("OPEN_SIMULATOR_XRAY_OUT") or None)
    # reference read is GIL-atomic; _RECORDER is published exactly once
    # under _LOCK and never reassigned
    return _RECORDER


def begin_run(call: str) -> Optional[XrayRun]:
    """Fresh staging for one schedule/probe attempt, or None when off."""
    rec = active()
    return XrayRun(rec, call) if rec is not None else None


def commit_run(run: Optional[XrayRun], backend_path: List[str],
               cfg_digest: str = "") -> None:
    if run is not None:
        run.recorder.commit(run, backend_path, cfg_digest)
