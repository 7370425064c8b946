"""DefaultPreemption (PostFilter): victim selection for unschedulable pods.

The port's own copy of `open_simulator_tpu/simulator/preemption.py`. It
re-implements the semantics of the reference's default PostFilter plugin
(vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/defaultpreemption/
default_preemption.go, registered by algorithmprovider/registry.go:106-110)
in the batched engine:

- When a pod fails scheduling, nodes whose failure is resolvable by removing
  pods (status Unschedulable, not UnschedulableAndUnresolvable) become
  preemption candidates (nodesWherePreemptionMightHelp, :259-271). The v1.20
  unresolvable set: NodeUnschedulable, NodeName, NodeAffinity, TaintToleration,
  required pod AFFINITY (interpodaffinity/filtering.go:389), and spread
  constraints whose topology label the node lacks (podtopologyspread/
  filtering.go:298). Resources, ports, anti-affinity, skew violations, and the
  out-of-tree Simon-family filters are resolvable.
- selectVictimsOnNode (:578-673): remove all strictly-lower-priority pods,
  check the preemptor fits; then reprieve victims most-important-first (PDB
  violators first), keeping each that still lets the preemptor fit.
- pickOneNodeForPreemption (:443-561): fewest PDB violations → lowest highest
  victim priority → lowest priority sum → fewest victims → latest earliest
  start time → first. Start times are proxied by commit order (the simulator
  sets every placed pod Running with no timestamp), and the final "sort of
  randomly" tie-break is the lowest node index — the same deterministic
  divergence the engine's selectHost uses.
- The dry-run's fit checks rebuild the engine's own seed tables from a
  hypothetical `placed` dict with the victims decremented and run the
  failure-reason diagnostic, `kernels.feasibility_packed` (K1 on the card,
  the plain version on CPU tensors; on a partitioned node mesh K1 on each
  rank's block and one tiled gather), reading the one node's byte. The
  removal semantics can never drift from the real seeding logic.
  GPU-share / Open-Local ledgers are intentionally NOT released in the dry
  run: the reference's dry run only adjusts default-plugin PreFilter state
  (RunPreFilterExtensionRemovePod), so its gpushare/open-local Filters also
  still see the victims' allocations.

Divergences from the reference, both deterministic by design:
- FindCandidates dry-runs ALL potential nodes from index 0 (the reference
  starts at a random offset, default_preemption.go:182-184) with the same
  candidate cap (10% of nodes, min 100) and early stop.
- What the reference observably does after a successful preemption in the
  simulator is: victims are DELETED from the fake cluster (PrepareCandidate →
  util.DeletePod) and the preemptor is still recorded unschedulable with its
  FitError and a nominated node (scheduler.go records the failure after
  PostFilter; Simon then deletes the pod, simulator.go:333-342). This module
  reproduces exactly that: victims leave their nodes (freed capacity is
  visible to every later pod), the preemptor lands in UnscheduledPods with
  status.nominatedNodeName set, and the evictions are logged on
  Simulator.preempted.

Engine integration (engine.schedule_pods): preemption needs the cluster state
AT THE FAILING POD'S SERIAL POSITION, which the batched run has already moved
past. Failures are rare, so the engine rewinds: snapshot → re-run the prefix
(placements are serial-order-deterministic, so the replay is exact) → run the
PostFilter at that state → evict → continue with the suffix.

Left out, with the ROADMAP item each waits for: the bulk-store branch of
`restore` (A14: the port commits no PodStore batches), and the watchdog
around the fit checks and the `preempt_evict` fault site (A9a).
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import constants as C
from ..core.types import UnscheduledPod
from ..obs import instruments as obs
from ..utils.objutil import labels_of, match_label_selector, name_of, namespace_of
from .encode import (
    SIG_MEMO_KEY,
    PlacedGroup,
    build_batch_tables,
    pad_encoder_axes,
    plugin_flags,
    scheduling_signature,
)

# First-failing-stage classification, in the engine's stage order
# (engine._STAGE_ORDER). UnschedulableAndUnresolvable stages can never be
# fixed by removing pods; see the module docstring for the per-plugin
# citations.
_STAGES = ("unsched", "taint", "affinity", "extra", "ports", "fit",
           "spread", "pod_affinity", "pod_anti", "gpu", "storage")
_UNRESOLVABLE = {"unsched", "taint", "affinity", "pod_affinity"}

# DefaultPreemptionArgs defaults (apis/config/v1beta1/defaults.go):
MIN_CANDIDATE_NODES_PERCENTAGE = 10
MIN_CANDIDATE_NODES_ABSOLUTE = 100


def pod_priority(pod: dict) -> int:
    """corev1helpers.PodPriority: spec.priority or 0."""
    try:
        return int((pod.get("spec") or {}).get("priority") or 0)
    except (TypeError, ValueError):
        return 0


def _preempt_policy_never(pod: dict) -> bool:
    """PodEligibleToPreemptOthers' only reachable gate in the simulator: the
    terminating-victims check is inert (evictions are instant deletes and the
    preemptor is never retried, simulator.go:333-342)."""
    return (pod.get("spec") or {}).get("preemptionPolicy") == "Never"


# ------------------------------------------------------------------ snapshots -----


def snapshot(sim) -> dict:
    """Copy of everything schedule runs mutate, for the rewind-and-replay."""
    return {
        "placed": {sig: dict(pg.node_counts) for sig, pg in sim.placed.items()},
        # only the non-empty per-node lists (the pod dicts by reference)
        "pods_on_node": {i: list(lst) for i, lst in enumerate(sim.pods_on_node) if lst},
        "homeless": len(sim.homeless),
        "log": len(sim._commit_log),
        "nominate": len(sim._nominate_log),
        "prio": len(sim._commits_prio),
        "preempted": len(sim.preempted),
        "gpu": sim.gpu_host.snapshot() if sim.gpu_host.enabled else None,
        "local": sim.local_host.snapshot() if sim.local_host.enabled else None,
    }


def restore(sim, snap: dict) -> None:
    # undo pod-dict mutations from commits after the snapshot (replayed
    # prefixes re-commit the same pods identically); pre-bound pods get their
    # original nodeName/status objects back
    gpu_enabled = sim.gpu_host.enabled  # commit only logs annotations then
    for pod, prev_idx, prev_assume, prev_nn, prev_status in sim._commit_log[snap["log"]:]:
        spec = pod.get("spec")
        if spec is not None:
            if prev_nn is None:
                spec.pop("nodeName", None)
            else:
                spec["nodeName"] = prev_nn
        if prev_status is None:
            pod.pop("status", None)
        else:
            pod["status"] = prev_status
        if gpu_enabled:
            anns = (pod.get("metadata") or {}).get("annotations")
            if anns is not None:
                if prev_idx is None:
                    anns.pop(C.AnnoGpuIndex, None)
                else:
                    anns[C.AnnoGpuIndex] = prev_idx
                if prev_assume is None:
                    anns.pop(C.AnnoGpuAssumeTime, None)
                else:
                    anns[C.AnnoGpuAssumeTime] = prev_assume
        sim._sig_of.pop(id(pod), None)
    # undo nominatedNodeName writes on failed preemptors (the normal loop
    # re-snapshots after each nomination, so only a rollback reaches them)
    for pod, had_status, prev_value, had_key in reversed(
            sim._nominate_log[snap["nominate"]:]):
        if not had_status:
            pod.pop("status", None)
        else:
            st = pod.get("status")
            if st is not None:
                if had_key:
                    st["nominatedNodeName"] = prev_value
                else:
                    st.pop("nominatedNodeName", None)
    del sim._nominate_log[snap["nominate"]:]
    rolled = len(sim._commits_prio) - snap["prio"]
    if rolled > 0:
        obs.COMMIT_ROLLBACKS.inc(rolled)
    unevicted = len(sim.preempted) - snap["preempted"]
    if unevicted > 0:
        # Only a rollback un-evicts (the preemption loop always re-snapshots
        # after evict): the restored victims re-enter the census, so count
        # them as commits — simon_commits_total − rollbacks − victims stays
        # equal to the placements live.
        obs.COMMITS.inc(unevicted)
    del sim._commit_log[snap["log"]:]
    del sim._commits_prio[snap["prio"]:]
    del sim.preempted[snap["preempted"]:]
    for sig in list(sim.placed):
        nc = snap["placed"].get(sig)
        if nc is None:
            del sim.placed[sig]
        else:
            sim.placed[sig].node_counts = dict(nc)
    saved = snap["pods_on_node"]
    for i, lst in enumerate(sim.pods_on_node):
        if lst or i in saved:
            lst[:] = saved.get(i, ())
    del sim.homeless[snap["homeless"]:]
    if snap["gpu"] is not None:
        sim.gpu_host.restore(snap["gpu"])
    if snap["local"] is not None:
        sim.local_host.restore(snap["local"])
    sim._last_carry = sim._last_mesh = None


# ------------------------------------------------------------------- fit check ----


def _placed_minus(sim, removed: List[dict], node_i: int) -> Dict[object, PlacedGroup]:
    """Hypothetical placed dict with `removed` pods taken off node_i."""
    rm: Dict[object, int] = {}
    for p in removed:
        sig = sim._sig_rec(p)[0]
        rm[sig] = rm.get(sig, 0) + 1
    placed2 = dict(sim.placed)
    for sig, k in rm.items():
        pg = sim.placed[sig]
        nc = dict(pg.node_counts)
        left = nc.get(node_i, 0) - k
        if left > 0:
            nc[node_i] = left
        else:
            nc.pop(node_i, None)
        placed2[sig] = replace(pg, node_counts=nc)
    return placed2


def _fit_tables(sim, g: int, placed2):
    """The one-pod batch tables of group g against a hypothetical placed
    state, the node axis padded as `Simulator.encode_batch` pads a batch."""
    bt = build_batch_tables(sim.encoder, [(g, -1)], placed2, sim.match_cache, pad_to=1)
    return sim._pad_nodes(pad_encoder_axes(bt))


def _fit_byte(rows, node_i: int) -> bool:
    """The feasible byte of one node in K1's packed rows (one device-to-host
    copy of one element)."""
    return bool(rows[0, node_i].item())


def _fits(sim, g: int, node_i: int, placed2) -> bool:
    """PodPassesFiltersOnNode for the preemptor against a hypothetical placed
    state: rebuild seeds through the engine's own build_batch_tables, run the
    failure-reason diagnostic (K1 on the card), fetch the one node's
    feasible byte."""
    bt = _fit_tables(sim, g, placed2)
    tables, carry = sim._to_device(bt)
    rows = sim._feasibility_packed(g, -1, tables, carry, plugin_flags(bt))
    return _fit_byte(rows, node_i)


# --------------------------------------------------------------------- PDBs -------


def _pdb_split(sim, victims: List[dict]) -> Tuple[List[dict], List[dict]]:
    """filterPodsWithPDBViolation (:736-781): stable split of the sorted victim
    list into (violating, non_violating), decrementing each matching PDB's
    status.disruptionsAllowed across the sequence."""
    pdbs = sim.model.pdbs
    allowed = []
    for pdb in pdbs:
        st = pdb.get("status") or {}
        try:
            allowed.append(int(st.get("disruptionsAllowed") or 0))
        except (TypeError, ValueError):
            allowed.append(0)
    violating: List[dict] = []
    non_violating: List[dict] = []
    for pod in victims:
        violated = False
        lbls = labels_of(pod)
        if lbls:
            for i, pdb in enumerate(pdbs):
                if namespace_of(pdb) != namespace_of(pod):
                    continue
                sel = (pdb.get("spec") or {}).get("selector")
                if not sel or not match_label_selector(sel, lbls):
                    continue
                disrupted = (pdb.get("status") or {}).get("disruptedPods") or {}
                if name_of(pod) in disrupted:
                    continue
                allowed[i] -= 1
                if allowed[i] < 0:
                    violated = True
        (violating if violated else non_violating).append(pod)
    return violating, non_violating


# ---------------------------------------------------------------- the PostFilter --


def _commit_seq(sim, pod: dict) -> int:
    """Commit-order proxy for pod start time (MoreImportantPod's second key)."""
    rec = sim._sig_rec(pod)
    return rec[2] if rec is not None else -1


def try_preempt(sim, pod: dict) -> Tuple[int, List[dict], Dict[str, int]]:
    """The preempt() pipeline at the CURRENT simulator state (the caller has
    rewound to the pod's serial position). Returns (node_i, victims, reasons):
    node_i = -1 when preemption cannot help; reasons = the per-stage FitError
    counts for the failure record either way. The diagnostic's packed rows
    come back in one device-to-host copy."""
    bt = sim.encode_batch([pod])
    pod.pop(SIG_MEMO_KEY, None)  # keep the (possibly recorded) pod dict clean
    tables, carry = sim._to_device(bt)
    g, forced = int(bt.pod_group[0]), int(bt.forced_node[0])
    stages = sim._feasibility_stages(g, forced, tables, carry, plugin_flags(bt))
    N = sim.na.N
    reasons = sim._reasons_from_stages(pod, forced, stages)
    if _preempt_policy_never(pod):
        return -1, [], reasons

    # nodesWherePreemptionMightHelp: the first failing stage must be resolvable
    remaining = np.ones(N, bool)
    if forced >= 0:
        only = np.zeros(N, bool)
        only[forced] = True
        remaining &= only
    potential = np.zeros(N, bool)
    spread_label_missing = _spread_label_missing(sim, g)
    for stage in _STAGES:
        fail_here = remaining & ~stages[stage]
        if stage not in _UNRESOLVABLE:
            ok = fail_here
            if stage == "spread" and spread_label_missing is not None:
                ok = fail_here & ~spread_label_missing
            potential |= ok
        remaining &= stages[stage]
    idxs = np.nonzero(potential)[0]
    if len(idxs) == 0:
        return -1, [], reasons

    num_candidates = (len(idxs) * MIN_CANDIDATE_NODES_PERCENTAGE) // 100
    if num_candidates < MIN_CANDIDATE_NODES_ABSOLUTE:
        num_candidates = MIN_CANDIDATE_NODES_ABSOLUTE
    num_candidates = min(num_candidates, len(idxs))

    prio = pod_priority(pod)
    non_violating: List[dict] = []
    violating: List[dict] = []
    for n in idxs.tolist():
        cand = _select_victims_on_node(sim, g, n, prio)
        if cand is None:
            continue
        (non_violating if cand["pdb_violations"] == 0 else violating).append(cand)
        if non_violating and len(non_violating) + len(violating) >= num_candidates:
            break
    candidates = non_violating + violating
    if not candidates:
        return -1, [], reasons
    best = _pick_one_node(sim, candidates)
    return best["node"], best["victims"], reasons


def _spread_label_missing(sim, g: int) -> Optional[np.ndarray]:
    """[N] mask of nodes lacking the topology label of any of group g's hard
    spread terms — those spread failures are UnschedulableAndUnresolvable
    (podtopologyspread/filtering.go:298)."""
    grp = sim.encoder.group_list[g]
    if not grp.spread_dns:
        return None
    missing = np.zeros(sim.na.N, bool)
    for cid, _, _ in grp.spread_dns:
        dom = sim.na.domain_of(sim.encoder.counter_list[cid].topo_key)
        missing |= dom < 0
    return missing


def _select_victims_on_node(sim, g: int, node_i: int, prio: int) -> Optional[dict]:
    """selectVictimsOnNode (:578-673). Returns {node, victims, pdb_violations}
    with victims ordered by decreasing importance, or None when the node is
    not a candidate."""
    potential = [p for p in sim.pods_on_node[node_i] if pod_priority(p) < prio]
    if not potential:
        return None
    # remove ALL lower-priority pods; if the preemptor still doesn't fit, the
    # node is not a candidate (:618-635)
    if not _fits(sim, g, node_i, _placed_minus(sim, potential, node_i)):
        return None
    # MoreImportantPod order: higher priority first, then earlier start
    # (commit order proxies start time — every placed pod becomes Running
    # with no timestamp in the simulator)
    potential.sort(key=lambda p: (-pod_priority(p), _commit_seq(sim, p)))
    violating, non_violating = _pdb_split(sim, potential)
    removed = list(potential)
    victims: List[dict] = []
    pdb_violations = 0
    for batch, is_violating in ((violating, True), (non_violating, False)):
        for p in batch:
            # reprieve: add p back; keep it iff the preemptor still fits
            removed.remove(p)
            if not _fits(sim, g, node_i, _placed_minus(sim, removed, node_i)):
                removed.append(p)
                victims.append(p)
                if is_violating:
                    pdb_violations += 1
    return {"node": node_i, "victims": victims, "pdb_violations": pdb_violations}


def _pick_one_node(sim, candidates: List[dict]) -> dict:
    """pickOneNodeForPreemption (:443-561), deterministic final tie-break."""
    def min_by(cands, key):
        best = min(key(c) for c in cands)
        return [c for c in cands if key(c) == best]

    cands = min_by(candidates, lambda c: c["pdb_violations"])
    if len(cands) > 1:  # lowest highest-priority victim (victims sorted desc)
        cands = min_by(cands, lambda c: pod_priority(c["victims"][0]))
    if len(cands) > 1:  # lowest priority sum (offset like the reference)
        cands = min_by(cands, lambda c: sum(
            pod_priority(p) + (1 << 31) for p in c["victims"]))
    if len(cands) > 1:  # fewest victims
        cands = min_by(cands, lambda c: len(c["victims"]))
    if len(cands) > 1:
        # latest earliest-start among each node's highest-priority victims.
        # victims list PDB-violating pods FIRST, so victims[0] is not
        # necessarily the highest-priority one (GetEarliestPodStartTime
        # tracks the true max priority across all victims).
        def earliest(c):
            hi = max(pod_priority(p) for p in c["victims"])
            return min(_commit_seq(sim, p) for p in c["victims"]
                       if pod_priority(p) == hi)
        latest = max(earliest(c) for c in cands)
        cands = [c for c in cands if earliest(c) == latest]
    return min(cands, key=lambda c: c["node"])  # deterministic "first"


def evict(sim, victims: List[dict], node_i: int, preemptor: dict) -> None:
    """PrepareCandidate's observable effect in the simulator: victims are
    deleted from the fake cluster (util.DeletePod), freeing their capacity
    for every later pod. Ledger releases keep the gpushare/open-local node
    annotations consistent (the engine treats pods_on_node as truth)."""
    lst = sim.pods_on_node[node_i]
    for p in victims:
        sig = sim._sig_rec(p)[0]
        pg = sim.placed[sig]
        c = pg.node_counts.get(node_i, 0)
        if c <= 1:
            pg.node_counts.pop(node_i, None)
        else:
            pg.node_counts[node_i] = c - 1
        for k, q in enumerate(lst):
            if q is p:
                del lst[k]
                break
        if sim.gpu_host.enabled:
            sim.gpu_host.release(p, node_i)
        if sim.local_host.enabled:
            sim.local_host.release(p, node_i)
        sim.preempted.append({
            "pod": p, "node": sim.na.names[node_i], "by": name_of(preemptor),
        })
    obs.PREEMPT_VICTIMS.inc(len(victims))
    if sim.gpu_host.enabled:
        sim.gpu_host.flush()


# ------------------------------------------------------------- the outer loop -----


def _max_replays() -> int:
    """Bound on rewind/replay passes per schedule_pods call. Default is
    generous — real workloads rarely exceed a handful of distinct failing
    specs — but finite, so the O(failures × batch) corner cannot run away."""
    try:
        return max(0, int(os.environ.get(
            "OPEN_SIMULATOR_MAX_PREEMPTION_REPLAYS", "512")))
    except ValueError:  # tuning knob: fall back, don't crash
        return 512


def schedule_with_preemption(sim, pods: List[dict]) -> List[UnscheduledPod]:
    """schedule_pods with the PostFilter armed (mixed priorities present).

    The batched run goes first; each failure that might preempt gets the exact
    treatment: rewind to the call's start state, replay the prefix (serial-
    order determinism makes the replay exact), run the PostFilter there, evict,
    and re-run the suffix. Failures that can't preempt (no lower-priority pod
    placed anywhere, policy Never, or an identical pod already failed against
    an unchanged victim pool) never trigger a replay."""
    snap = snapshot(sim)
    failed = sim._schedule_pods_inner(pods)
    if not failed:
        return failed
    recorded: List[UnscheduledPod] = []
    remaining = list(pods)
    # (signature, priority) → len(_commits_prio) at the failed attempt. The
    # priority is part of the key because scheduling_signature excludes
    # spec.priority: a later same-spec pod with HIGHER priority sees a larger
    # victim pool and must get its own attempt.
    attempted: Dict[object, int] = {}
    # Replay-cost cap: each loop iteration is one rewind + prefix replay +
    # suffix re-run — worst case O(failures × batch) pod reschedules. Beyond
    # the cap the remaining failures are recorded WITHOUT preemption attempts
    # (pods that could have preempted stay failed) and the skips are visible
    # as preemption_attempts{outcome="capped"}.
    replays = 0
    cap = _max_replays()
    while True:
        target = _select_target(sim, remaining, failed, attempted)
        if target is None:
            return recorded + failed
        if replays >= cap:
            obs.PREEMPT_ATTEMPTS.labels(outcome="capped").inc(len(failed))
            return recorded + failed
        replays += 1
        restore(sim, snap)
        obs.PREEMPT_REPLAY_PODS.inc(target)
        prefix_failed = sim._schedule_pods_inner(remaining[:target])
        pod = remaining[target]
        node_i, victims, reasons = try_preempt(sim, pod)
        obs.PREEMPT_ATTEMPTS.labels(
            outcome="nominated" if node_i >= 0 else "no_candidates").inc()
        # the preemptor's authoritative reason and victim chain come from
        # this PostFilter pass, not from the batched attempts the rewind
        # rolled back: record them (victims flip to 'preempted')
        sim._xray_preempt(pod, node_i, victims if node_i >= 0 else [], reasons)
        if node_i >= 0:
            evict(sim, victims, node_i, pod)
            # evictions change the victim pool WITHOUT appending to
            # _commits_prio, so the suffix-min gate can't see them —
            # invalidate every dedup entry instead of silently skipping a
            # same-signature pod that could now preempt.
            attempted.clear()
            # recordSchedulingFailure sets status.nominatedNodeName before
            # Simon deletes the pod; keep it visible on the record (logged
            # for a rollback — not a commit)
            st = pod.get("status")
            sim._nominate_log.append((
                pod, st is not None,
                st.get("nominatedNodeName") if st is not None else None,
                st is not None and "nominatedNodeName" in st))
            pod.setdefault("status", {})["nominatedNodeName"] = sim.na.names[node_i]
        else:
            attempted[(scheduling_signature(pod), pod_priority(pod))] = len(
                sim._commits_prio)
        recorded.extend(prefix_failed)
        recorded.append(UnscheduledPod(
            pod, sim._format_reason(pod, reasons, sim.na.N)))
        remaining = remaining[target + 1:]
        snap = snapshot(sim)
        obs.PREEMPT_REPLAY_PODS.inc(len(remaining))
        failed = sim._schedule_pods_inner(remaining)
        if not failed:
            return recorded


def _select_target(sim, remaining: List[dict], failed: List[UnscheduledPod],
                   attempted: Dict[object, int]) -> Optional[int]:
    """First failed pod worth a preemption attempt, by serial position."""
    fail_ids = {id(u.pod) for u in failed}
    prios = sim._commits_prio
    if not prios:
        return None
    global_min = min(prios)
    n = len(prios)
    # suffix minima so "did any lower-priority pod commit since the last
    # attempt against this signature" is O(1) per query
    suffix_min: Optional[List[int]] = None
    for i, p in enumerate(remaining):
        if id(p) not in fail_ids:
            continue
        prio = pod_priority(p)
        if global_min >= prio or _preempt_policy_never(p):
            continue
        at = attempted.get((scheduling_signature(p), prio))
        if at is not None:
            if at >= n:
                continue  # state rewound past the attempt point: no new info
            if suffix_min is None:
                suffix_min = list(prios)
                for k in range(n - 2, -1, -1):
                    suffix_min[k] = min(suffix_min[k], suffix_min[k + 1])
            if suffix_min[at] >= prio:
                continue  # no lower-priority commits since the failed attempt
        return i
    return None
