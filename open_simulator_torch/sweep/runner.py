"""simonsweep: the batched scenario-sweep runner, on one device.

Port of `open_simulator_tpu/sweep/runner.py`. N independent cluster futures
are evaluated as lanes of a few fan-out dispatches against ONE shared
device-resident cluster image (serve/image.py):

- **Stage once, overlay per lane.** The base cluster (plus the union
  nodepool, built drained) encodes and moves to the device once; every
  scenario becomes a copy-on-write overlay: an active-mask row (drains off,
  pool activations on) and, only when drains evict committed pods, a private
  seed copy (ResidentImage.lane_overlay).
- **Route like the engine.** A scenario whose batch is entirely contiguous
  runs of wave-eligible groups (the engine's own _wave_eligibility) rides
  `kernels.sweep_wave_fanout`: each lane is a chain of schedule_wave
  segments (K3 then K3c over lanes per segment on the card). Anything else
  batched rides `kernels.sweep_whatif_fanout` (per-lane serial scans, K2
  over lanes). Census-dependent workloads (topology spread, live
  SelectorSpread, gpu/storage, pre-bound pods) and clusters the image
  declines run the fresh single-scenario path.
- **Standing parity fuzzer.** Every batched lane (or a seeded sample) is
  re-run on a fresh Simulator over that scenario's cluster, and the
  per-(node, scheduling signature) placement censuses must match EXACTLY;
  pods of one group are interchangeable, so census equality is placement
  identity. A mismatch raises SweepParityError.

Lanes are shape-bucketed into chunks of at most `fanout` (the JAX runner's
rule), so the report's dispatch counts are the JAX package's. On a scenario
mesh (`mesh`, or the image's own when the process group has more than one
rank) each rank runs its block of every chunk's lanes and the fetch gathers
them, so every rank builds the same results and report.

With the flight recorder on (obs/xray.py), a run commits one probe record
per scenario (counts only).

Not ported: the failover of a failed chunk to fresh runs, scope spans and
metrics (ROADMAP A9: a failure propagates).
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..ops import kernels
from ..simulator.encode import bucket_capped, scheduling_signature
from ..utils.objutil import name_of
from .families import (
    TIER_LABEL,
    Scenario,
    build_base,
    compile_families,
)
from .spec import SweepSpec

PARITY_MODES = ("full", "sample", "off")

# census: {(node_name | "" for unscheduled, scheduling_signature): count}
Census = Dict[Tuple[str, str], int]


class SweepParityError(AssertionError):
    """A batched lane's placement census diverged from the fresh serial
    oracle — the invariant the sweep exists to fuzz. Never swallowed."""


class ScenarioResult(NamedTuple):
    scenario: Scenario
    route: str                   # wave | scan | fresh
    scheduled: int
    total: int
    census: Census
    tiers: Dict[str, int]        # tier -> scheduled count
    utilization: Dict[str, float]
    nodes_live: int
    gate: str = ""               # fresh-route reason, "" on batched routes


class _WaveSeg(NamedTuple):
    g: int
    m: int
    cap1: bool
    start: int                   # offset into scenario.pods
    sig: str
    tier: str


class SweepRunner:
    """One sweep execution: compile -> stage -> route -> batch-dispatch ->
    parity -> report. Build once, run() once."""

    def __init__(self, spec: SweepSpec, seed: Optional[int] = None,
                 parity: str = "full", parity_sample: int = 8,
                 fanout: int = 64, mesh=None, device=None) -> None:
        """`device`: "cuda" (the default, None) or "cpu", for the image,
        the fresh route and the parity oracle alike. `mesh`: the image's
        scenario mesh (parallel/mesh.py; None lets the image take its own)."""
        from ..simulator.engine import resolve_device

        if parity not in PARITY_MODES:
            raise ValueError(f"parity must be one of {PARITY_MODES}")
        self.device = resolve_device(device)
        self._mesh = mesh
        self.spec = spec
        self.seed = spec.seed if seed is None else int(seed)
        self.parity = parity
        self.parity_sample = max(1, int(parity_sample))
        self.fanout = max(1, int(fanout))
        self.image = None
        self.scenarios: List[Scenario] = []
        self.results: Dict[int, ScenarioResult] = {}
        self.dispatches: Dict[str, int] = {}
        self.parity_checked = 0
        self.seconds: Dict[str, float] = {}
        self._base_nodes: List[dict] = []
        self._bound: List[dict] = []
        self._pool_nodes: List[dict] = []

    # --------------------------------------------------------------- run -----

    def run(self) -> Dict[int, ScenarioResult]:
        """Evaluate every scenario; returns {sid: ScenarioResult} (also kept
        on self.results). Raises SweepParityError on any census mismatch."""
        t0 = time.perf_counter()
        self._base_nodes, self._bound = build_base(self.spec)
        compiled = compile_families(self.spec, self.seed, self._base_nodes)
        self.scenarios = compiled.scenarios
        self._pool_nodes = compiled.pool_nodes
        self._build_image()
        wave: List[Tuple[Scenario, object, List[_WaveSeg]]] = []
        scan: List[Tuple[Scenario, object]] = []
        fresh: List[Tuple[Scenario, str]] = []
        for sc in self.scenarios:
            route = self._route(sc)
            if route[0] == "wave":
                wave.append((sc, route[1], route[2]))
            elif route[0] == "scan":
                scan.append((sc, route[1]))
            else:
                fresh.append((sc, route[1]))
        # Shape-bucketed chunking: lanes sharing one dispatch share its
        # shapes (K, block, kmax / P_pad), so one storm-sized lane in a
        # chunk would inflate every lane's score table and top-k width;
        # bucketing by shape keeps the common chunks at their own sizes.
        for _, chunk_lanes in sorted(_grouped(wave, self._wave_shape_key)):
            for chunk in _chunks(chunk_lanes, self.fanout):
                self._run_chunk(chunk, self._dispatch_wave_chunk)
        for _, chunk_lanes in sorted(_grouped(
                scan, lambda item: bucket_capped(
                    max(1, len(item[1].batch)), 2048))):
            for chunk in _chunks(chunk_lanes, self.fanout):
                self._run_chunk(chunk, self._dispatch_scan_chunk)
        for sc, gate in fresh:
            self._finish(self.serial_result(sc, route="fresh", gate=gate))
        t_parity = time.perf_counter()
        self._check_parity()
        # walls for the CLI's stderr line, never in the report
        self.seconds = {"batched": t_parity - t0, "parity": time.perf_counter() - t_parity}
        self._xray_results()
        return self.results

    def _xray_results(self) -> None:
        """simonxray ride-along: one probe record per swept scenario."""
        from ..obs import xray

        run = xray.begin_run("sweep")
        if run is None:
            return
        for sid in sorted(self.results):
            r = self.results[sid]
            run.add_probe(r.scheduled, r.total, candidate=sid)
        xray.commit_run(run, [self.device.type])

    def _build_image(self) -> None:
        from ..serve.image import ResidentImage

        self.image = ResidentImage.try_build(
            self._base_nodes + self._pool_nodes, pods=self._bound,
            mesh=self._mesh, device=self.device)
        if self.image is not None and self._pool_nodes:
            # the union nodepool stages INTO the image but starts drained:
            # each nodepool_mix lane re-activates its k pool columns (zero
            # seed bytes — a fresh pool node holds no pods)
            self.image.apply_events([
                {"type": "node_drain", "name": name_of(n)}
                for n in self._pool_nodes])

    # ----------------------------------------------------------- routing -----

    def _route(self, sc: Scenario):
        """('wave', session, segs) | ('scan', session) | ('fresh', gate)."""
        if self.image is None:
            return ("fresh", "image declined (cluster gate)")
        session = self.image.session(sc.pods, drains=sc.drains)
        gate = self.image.eligible(session.batch, sc.pods)
        if gate is not None:
            return ("fresh", gate)
        segs = self._wave_segments(sc, session.batch)
        if segs is not None:
            return ("wave", session, segs)
        return ("scan", session)

    def _wave_segments(self, sc: Scenario,
                       batch) -> Optional[List[_WaveSeg]]:
        """The scenario's batch as a chain of wave segments — one per
        contiguous (group, unpinned) run, every run wave-eligible by the
        engine's OWN routing — or None (the scan lane is the exact
        fallback, mirroring the engine's serial segments)."""
        sim = self.image._sim
        segs: List[_WaveSeg] = []
        start = 0
        while start < len(batch):
            g, f = batch[start]
            end = start
            while end < len(batch) and batch[end] == (g, f):
                end += 1
            if f >= 0:
                return None
            route = sim._wave_eligibility(g)
            if route.kind != "wave" or route.gpu_live:
                return None
            pod = sc.pods[start]
            segs.append(_WaveSeg(
                g=g, m=end - start, cap1=bool(route.cap1), start=start,
                sig=scheduling_signature(pod),
                tier=pod["metadata"]["labels"].get(TIER_LABEL, "baseline")))
            start = end
        return segs

    def _wave_shape_key(self, item) -> tuple:
        """The dispatch shape of a wave lane: (K, block, kmax). Lanes
        grouped by this key share one dispatch without any lane paying for
        another's outlier segment sizes."""
        segs = item[2]
        K = 1
        while K < max(1, len(segs)):
            K *= 2
        max_m = max((s.m for s in segs), default=1)
        n_real = self.image._sim.na.N
        block = kernels.wave_block_for(max(max_m, 1), n_real)
        return (K, block, kernels.wave_kmax(max(max_m, 1), n_real, block))

    # ------------------------------------------------------ lane assembly ----

    def _lane_arrays(self, lanes: List[Tuple[Scenario, object]]):
        """(S, active_s, carry_np): the image's shared lane assembly (pow2
        quantization, the mesh's multiple, base-seed device-cache reuse)
        with each lane's
        copy-on-write overlay routed through lane_overlay for the nodepool
        activations."""
        return self.image._lane_arrays(
            [session for _, session in lanes],
            activates=[sc.activates for sc, _ in lanes])

    def _run_chunk(self, chunk, dispatch) -> None:
        """One batched dispatch. A failure propagates: the failover of a
        chunk to fresh runs is not ported (ROADMAP A9)."""
        for res in dispatch(chunk):
            self._finish(res)

    def _finish(self, res: ScenarioResult) -> None:
        self.results[res.scenario.sid] = res

    # ---------------------------------------------------- wave dispatch -----

    def _dispatch_wave_chunk(self, chunk) -> List[ScenarioResult]:
        image = self.image
        with image._lock:
            for _, session, _ in chunk:
                session.ensure_current()
            image.ensure_staged()
            S, active_s, carry_np = self._lane_arrays(
                [(sc, session) for sc, session, _ in chunk])
            K = 1
            max_segs = max((len(segs) for _, _, segs in chunk), default=1)
            while K < max_segs:
                K *= 2
            g_sk = np.zeros((S, K), np.int32)
            m_sk = np.zeros((S, K), np.int32)
            cap1_sk = np.zeros((S, K), bool)
            for li, (_, _, segs) in enumerate(chunk):
                for k, seg in enumerate(segs):
                    g_sk[li, k], m_sk[li, k] = seg.g, seg.m
                    cap1_sk[li, k] = seg.cap1
            g_sk[len(chunk):] = g_sk[0]
            m_sk[len(chunk):] = m_sk[0]
            cap1_sk[len(chunk):] = cap1_sk[0]
            max_m = int(m_sk.max()) if m_sk.size else 0
            n_real = image._sim.na.N
            block = kernels.wave_block_for(max(max_m, 1), n_real)
            kmax = kernels.wave_kmax(max(max_m, 1), n_real, block)
            self._count_dispatch("sweep_wave_fanout")
            counts_skn, requested_s = self._wave_round(
                carry_np, active_s, g_sk, m_sk, cap1_sk, block, kmax)
            image.assert_image_alive()
            out = []
            for li, (sc, _, segs) in enumerate(chunk):
                out.append(self._wave_result(sc, segs, counts_skn[li],
                                             requested_s[li], active_s[li]))
            return out

    def _wave_round(self, carry_np, active_s, g_sk, m_sk, cap1_sk, block,
                    kmax):
        image = self.image
        sim = image._sim
        blk = image.lane_block(active_s.shape[0])
        carry_s, active = image._stage_lane_inputs(carry_np, active_s)
        carry_s, counts = image.fanouts().sweep_wave_fanout(
            image._tables, carry_s, active, g_sk[blk], m_sk[blk], cap1_sk[blk],
            w=sim.score_w, filters=sim.filter_flags, block=block, kmax=kmax)
        return image.fetch(counts, carry_s.requested)

    def _wave_result(self, sc: Scenario, segs: List[_WaveSeg], counts_kn,
                     requested, active_row) -> ScenarioResult:
        image = self.image
        names = image._sim.na.names
        N = image._sim.na.N
        census: Census = {}
        tiers: Dict[str, int] = {}
        scheduled = 0
        for k, seg in enumerate(segs):
            row = counts_kn[k][:N]
            placed = int(row.sum())
            scheduled += placed
            tiers[seg.tier] = tiers.get(seg.tier, 0) + placed
            for ni in np.flatnonzero(row):
                key = (names[int(ni)], seg.sig)
                census[key] = census.get(key, 0) + int(row[ni])
            if seg.m - placed:
                key = ("", seg.sig)
                census[key] = census.get(key, 0) + seg.m - placed
        return ScenarioResult(
            scenario=sc, route="wave", scheduled=scheduled,
            total=len(sc.pods), census=census, tiers=tiers,
            utilization=image._utilization(active_row, requested),
            nodes_live=int(active_row[:N].sum()))

    # ---------------------------------------------------- scan dispatch -----

    def _dispatch_scan_chunk(self, chunk) -> List[ScenarioResult]:
        image = self.image
        with image._lock:
            for _, session in chunk:
                session.ensure_current()
            image.ensure_staged()
            S, active_s, carry_np = self._lane_arrays(list(chunk))
            P = max(len(sc.pods) for sc, _ in chunk)
            P_pad = bucket_capped(max(P, 1), 2048)
            pod_group_s = np.zeros((S, P_pad), np.int32)
            forced_node_s = np.full((S, P_pad), -1, np.int32)
            valid_s = np.zeros((S, P_pad), bool)
            for li, (sc, session) in enumerate(chunk):
                for i, (g, f) in enumerate(session.batch):
                    pod_group_s[li, i] = g
                    forced_node_s[li, i] = f
                valid_s[li, :len(session.batch)] = True
            pod_group_s[len(chunk):] = pod_group_s[0]
            forced_node_s[len(chunk):] = forced_node_s[0]
            valid_s[len(chunk):] = valid_s[0]
            self._count_dispatch("sweep_whatif_fanout")
            choices_s, requested_s = self._scan_round(
                carry_np, active_s, pod_group_s, forced_node_s, valid_s)
            image.assert_image_alive()
            out = []
            for li, (sc, _) in enumerate(chunk):
                out.append(self._scan_result(sc, choices_s[li],
                                             requested_s[li], active_s[li]))
            return out

    def _scan_round(self, carry_np, active_s, pod_group_s, forced_node_s,
                    valid_s):
        image = self.image
        sim = image._sim
        blk = image.lane_block(active_s.shape[0])
        carry_s, active = image._stage_lane_inputs(carry_np, active_s)
        # gpu/storage pinned off: the image gates decline those clusters and
        # requests (as serve's serial round)
        carry_s, choices = image.fanouts().sweep_whatif_fanout(
            image._tables, carry_s, active, pod_group_s[blk], forced_node_s[blk],
            valid_s[blk], n_zones=image._bt.n_zones, enable_gpu=False,
            enable_storage=False, w=sim.score_w, filters=sim.filter_flags)
        return image.fetch(choices, carry_s.requested)

    def _scan_result(self, sc: Scenario, choices, requested,
                     active_row) -> ScenarioResult:
        image = self.image
        names = image._sim.na.names
        N = image._sim.na.N
        census: Census = {}
        tiers: Dict[str, int] = {}
        scheduled = 0
        for i, pod in enumerate(sc.pods):
            sig = scheduling_signature(pod)
            tier = pod["metadata"]["labels"].get(TIER_LABEL, "baseline")
            ni = int(choices[i])
            if ni >= 0:
                scheduled += 1
                tiers[tier] = tiers.get(tier, 0) + 1
                key = (names[ni], sig)
            else:
                key = ("", sig)
            census[key] = census.get(key, 0) + 1
        return ScenarioResult(
            scenario=sc, route="scan", scheduled=scheduled,
            total=len(sc.pods), census=census, tiers=tiers,
            utilization=image._utilization(active_row, requested),
            nodes_live=int(active_row[:N].sum()))

    def _count_dispatch(self, kernel: str) -> None:
        self.dispatches[kernel] = self.dispatches.get(kernel, 0) + 1

    # ------------------------------------------------------ serial oracle ----

    def _fresh_sim(self, sc: Scenario):
        """(sim, bound_pods) — the scenario's cluster from scratch: live
        nodes minus drains plus activated pool nodes, bound pods replayed
        (minus the drained nodes'), the image's cluster objects registered."""
        if self.image is not None:
            sim, bound, _ = self.image.fresh_simulator(
                drains=sc.drains, include=sc.activates)
            return sim, bound
        from ..simulator.engine import Simulator

        skip = set(sc.drains)
        act = set(sc.activates)
        nodes = [copy.deepcopy(n) for n in self._base_nodes
                 if name_of(n) not in skip]
        nodes += [copy.deepcopy(n) for n in self._pool_nodes
                  if name_of(n) in act]
        bound = [copy.deepcopy(p) for p in self._bound
                 if (p.get("spec") or {}).get("nodeName") not in skip]
        return Simulator(nodes, device=self.device), bound

    def serial_result(self, sc: Scenario, route: str = "serial",
                      gate: str = "") -> ScenarioResult:
        """One scenario evaluated the reference way: a fresh Simulator over
        that scenario's cluster, the full engine path (its own wave
        segmentation and all). This is BOTH the fresh route and the parity
        oracle — and what the bench's serial loop times."""
        sim, bound = self._fresh_sim(sc)
        request = [copy.deepcopy(p) for p in sc.pods]
        # signatures snapshot BEFORE scheduling: _commit_pod writes
        # spec.nodeName (part of the signature subtree) and pops the memo,
        # so a post-schedule signature would be node-dependent and never
        # match the batched lane's pre-schedule census keys
        sig_of = {(p["metadata"].get("namespace", "default"),
                   p["metadata"]["name"]): scheduling_signature(p)
                  for p in request}
        failed = sim.schedule_pods(bound + request)

        def req_key(pod):
            md = pod.get("metadata") or {}
            return (md.get("namespace", "default"), md.get("name"))

        census: Census = {}
        tiers: Dict[str, int] = {}
        scheduled = 0
        for ni, pods in enumerate(sim.pods_on_node):
            nname = sim.na.names[ni]
            for pod in pods:
                sig = sig_of.get(req_key(pod))
                if sig is None:
                    continue  # a bound pod, not request material
                scheduled += 1
                tier = (pod["metadata"].get("labels") or {}).get(
                    TIER_LABEL, "baseline")
                tiers[tier] = tiers.get(tier, 0) + 1
                key = (nname, sig)
                census[key] = census.get(key, 0) + 1
        for u in failed:
            sig = sig_of.get(req_key(u.pod))
            if sig is not None:
                key = ("", sig)
                census[key] = census.get(key, 0) + 1
        return ScenarioResult(
            scenario=sc, route=route, scheduled=scheduled,
            total=len(sc.pods), census=census, tiers=tiers,
            utilization=sim.probe_utilization(), nodes_live=sim.na.N,
            gate=gate)

    # ------------------------------------------------------------ parity -----

    def _parity_lanes(self) -> List[int]:
        batched = sorted(sid for sid, r in self.results.items()
                         if r.route in ("wave", "scan"))
        if self.parity == "off" or not batched:
            return []
        if self.parity == "full" or len(batched) <= self.parity_sample:
            return batched
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=[self.seed, 0x9A617]))
        pick = rng.choice(len(batched), size=self.parity_sample,
                          replace=False)
        return sorted(batched[i] for i in pick)

    def _check_parity(self) -> None:
        mismatches: List[str] = []
        for sid in self._parity_lanes():
            res = self.results[sid]
            oracle = self.serial_result(res.scenario)
            self.parity_checked += 1
            if (res.census != oracle.census
                    or res.scheduled != oracle.scheduled
                    or res.utilization != oracle.utilization):
                mismatches.append(self._describe_mismatch(res, oracle))
        if mismatches:
            raise SweepParityError(
                f"{len(mismatches)} sweep lane(s) diverged from the fresh "
                f"serial oracle:\n" + "\n".join(mismatches))

    @staticmethod
    def _describe_mismatch(res: ScenarioResult,
                           oracle: ScenarioResult) -> str:
        diff = []
        keys = set(res.census) | set(oracle.census)
        for key in sorted(keys):
            a, b = res.census.get(key, 0), oracle.census.get(key, 0)
            if a != b:
                diff.append(f"{key[0] or '<unscheduled>'}: "
                            f"batched={a} serial={b}")
                if len(diff) >= 6:
                    break
        return (f"  scenario {res.scenario.sid} ({res.scenario.label}, "
                f"route={res.route}): scheduled {res.scheduled} vs "
                f"{oracle.scheduled}; " + "; ".join(diff))


def _chunks(items: List, size: int):
    for i in range(0, len(items), size):
        yield items[i:i + size]


def _grouped(items: List, key):
    """[(key, lanes)] preserving scenario order within each group."""
    out: Dict[object, List] = {}
    for item in items:
        out.setdefault(key(item), []).append(item)
    return list(out.items())
