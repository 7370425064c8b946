"""The Applier: apply-mode orchestration + capacity planning.

Port of `open_simulator_tpu/apply/applier.py`: the same search, answers and
report, on the port's Simulator (the card by default, the CPU when asked:
`Options.device`). Mirrors the reference's pkg/apply/apply.go:
- config load + validation (NewApplier :61-101, validate :269-306)
- cluster from customConfig dir or kubeconfig (Run step 1, :114-127)
- app list from raw YAML dirs or helm charts (step 2, :129-152)
- newNode template (+ node-name-matched local-storage JSON) (step 3, :156-168)
- the add-node loop (step 4, :203-259) — interactively prompting like the reference's
  survey menu, or (non-interactive extension) automatically searching the minimal
  node count that schedules everything within the MaxCPU/MaxMemory/MaxVG envelope
  (satisfyResourceSetting :689-775). The reference asks the user for each node count;
  the auto-search is this build's capacity-planning mode (deviation, documented).
- report tables (report* :309-687) as plain aligned-text tables instead of pterm.

Not ported yet, each raising NotImplementedError with the ROADMAP item it
waits for: chart apps (A7), a live cluster through `kubeConfig` (A10),
`deadline` and `resume_journal` (A9, with the probe-verdict journal of
resilience/guard.py). `--default-scheduler-config` (api/schedconfig.py)
reaches every Simulator the run builds, the probes' included.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO

from ..api.v1alpha1 import ConfigError, SimonConfig, parse_simon_config, validate_config
from ..core import constants as C
from ..core.types import AppResource, NodeStatus, ResourceTypes, SimulateResult
from ..models.fakenode import new_fake_nodes
from ..simulator.core import simulate
from ..utils.objutil import annotations_of, labels_of, name_of, namespace_of, pod_resource_requests
from ..utils.quantity import format_quantity, parse_milli, parse_quantity
from ..utils.storage import NodeStorage
from ..utils.yamlio import (
    load_cluster_from_directory,
    load_resources_from_directory,
    match_and_set_local_storage_annotation,
)

MAX_AUTO_NODES = 10_000  # auto-search upper bound before giving up
PROBE_FANOUT = 8  # candidates per incremental-probe dispatch (one vmap lane each)


def _grid(lo: int, hi: int, k: int) -> List[int]:
    """Up to k evenly spaced ints covering [lo, hi], endpoints included."""
    if hi <= lo:
        return [max(lo, hi)]
    if hi - lo + 1 <= k:
        return list(range(lo, hi + 1))
    return sorted({lo + round(i * (hi - lo) / (k - 1)) for i in range(k)})


def _interior(lo: int, hi: int, k: int) -> List[int]:
    """Up to k evenly spaced ints strictly inside (lo, hi)."""
    if hi - lo <= 1:
        return []
    if hi - lo - 1 <= k:
        return list(range(lo + 1, hi))
    return sorted({lo + max(1, round(i * (hi - lo) / (k + 1))) for i in range(1, k + 1)})


class CapacityPlanner:
    """Fast add-node search: expand the workload ONCE, probe candidate node
    counts with non-mutating device runs, and start from an arithmetic lower
    bound below which scheduling provably fails.

    The reference's loop re-simulates the whole workload per candidate
    (apply.go:203-259); here a probe skips pod regeneration, placement
    materialization and failure diagnosis, and the authoritative full
    simulation runs only at the chosen answer (the Applier re-validates it
    and falls back to the full-simulation search on any divergence).

    Only built when the probe is provably equivalent: no DaemonSets (their pod
    sets depend on the candidate node list), no open-local storage (the
    envelope check would need VG accounting), and no pre-bound pod AFTER an
    unbound one (probe_pods commits all bound pods first, which could steal
    capacity an earlier unbound pod would have taken in the serial order).
    `try_build` returns None otherwise and the Applier keeps the original
    loop. `device` ("cuda", the default, or "cpu") reaches every Simulator."""

    def __init__(self, base_nodes: List[dict], new_node: dict, pods: List[dict],
                 cluster_objects: Optional[ResourceTypes] = None,
                 app_objects: Optional[List[ResourceTypes]] = None,
                 device=None, sched_config=None) -> None:
        self.base_nodes = base_nodes
        self.new_node = new_node
        self.pods = pods
        self.cluster_objects = cluster_objects
        self.app_objects = app_objects or []
        self.device = device
        self.sched_config = sched_config
        # filled by search(): path ("incremental"/"fresh"), probes (candidate
        # evaluations), dispatches (probe rounds), encode_s (one-time
        # pod-encoding wall), encodes (must stay 1 on the incremental path)
        self.stats: Dict[str, object] = {}
        # the incremental path's session, kept for its growth accounting
        self.session = None

    @classmethod
    def try_build(cls, cluster: ResourceTypes, apps: List[AppResource],
                  new_node: Optional[dict], patch_funcs,
                  device=None, sched_config=None) -> Optional["CapacityPlanner"]:
        from ..models.workloads import expand_workloads_excluding_daemonsets
        from ..algo.queues import sort_affinity, sort_toleration

        if new_node is None:
            return None
        if cluster.daemon_sets or any(a.resource.daemon_sets for a in apps):
            return None
        nodes = cluster.nodes + [new_node]
        if any(annotations_of(n).get(C.AnnoNodeLocalStorage) for n in nodes):
            return None
        cluster2 = cluster.copy()
        pods = expand_workloads_excluding_daemonsets(cluster2)
        for app in apps:
            from ..models.workloads import generate_valid_pods_from_app

            app_pods = generate_valid_pods_from_app(app.name, app.resource, cluster.nodes)
            app_pods = sort_toleration(sort_affinity(app_pods))
            for patch in patch_funcs or []:
                patch(app_pods)
            pods.extend(app_pods)
        seen_unbound = False
        for p in pods:
            if (p.get("spec") or {}).get("nodeName"):
                if seen_unbound:
                    return None  # bound-after-unbound: probe order-inequivalent
            else:
                seen_unbound = True
        return cls(cluster.nodes, new_node, pods,
                   cluster_objects=cluster, app_objects=[a.resource for a in apps],
                   device=device, sched_config=sched_config)

    # ------------------------------------------------------------ arithmetic ----

    def _totals(self):
        """Request totals over the pods the simulation will actually account:
        pods bound to unknown nodes are dropped from every report (the engine's
        homeless handling), so they must not inflate the lower bound either."""
        known = {name_of(n) for n in self.base_nodes}
        cpu_used = mem_used = 0.0
        n_pods = 0
        for p in self.pods:
            nn = (p.get("spec") or {}).get("nodeName")
            if nn and nn not in known:
                continue
            req = pod_resource_requests(p)
            cpu_used += req.get("cpu", 0.0)
            mem_used += req.get("memory", 0.0)
            n_pods += 1
        return cpu_used, mem_used, n_pods

    @staticmethod
    def _node_caps(node: dict):
        alloc = (node.get("status") or {}).get("allocatable") or {}
        return (parse_milli(alloc.get("cpu", 0)), parse_quantity(alloc.get("memory", 0)),
                parse_quantity(alloc.get("pods", 0)))

    @staticmethod
    def _env_pct(name: str) -> int:
        """Lenient variant of satisfy_resource_setting's env parse: probes never
        raise — an unparsable env falls to 100 and the authoritative run (which
        keeps the reference's ConfigError) reports it."""
        s = os.environ.get(name, "")
        try:
            v = int(s) if s else 100
        except ValueError:
            return 100
        return v if 0 <= v <= 100 else 100

    @classmethod
    def _envelope_ok(cls, cpu_used, cpu_alloc, mem_used, mem_alloc) -> bool:
        """satisfy_resource_setting's integer occupancy-rate check
        (apply.go:689-775) on aggregate totals — the single copy the probe and
        the lower bound both use."""
        cpu_rate = int(cpu_used / cpu_alloc * 100) if cpu_alloc else 0
        mem_rate = int(mem_used / mem_alloc * 100) if mem_alloc else 0
        return (cpu_rate <= cls._env_pct(C.EnvMaxCPU)
                and mem_rate <= cls._env_pct(C.EnvMaxMemory))

    def lower_bound(self, totals=None) -> int:
        """Smallest n passing the NECESSARY conditions: per-resource totals fit
        AND the MaxCPU/MaxMemory integer-rate envelope of
        satisfy_resource_setting holds. Any n below provably fails, so the
        probe search starts here. Monotone in n -> binary search, no device.
        `totals` overrides the (cpu_used, mem_used, n_pods) host scan — the
        incremental session derives the same sums from its encoded groups
        without the per-pod loop (ProbeSession.batch_totals)."""
        cpu_used, mem_used, n_pods = totals if totals is not None else self._totals()
        base = [self._node_caps(n) for n in self.base_nodes]
        b_cpu = sum(c for c, _, _ in base)
        b_mem = sum(m for _, m, _ in base)
        b_pods = sum(p for _, _, p in base)
        n_cpu, n_mem, n_podcap = self._node_caps(self.new_node)

        def necessary_ok(n: int) -> bool:
            cpu_a = b_cpu + n * n_cpu
            mem_a = b_mem + n * n_mem
            pods_a = b_pods + n * n_podcap
            if cpu_used > cpu_a or mem_used > mem_a or n_pods > pods_a:
                return False
            return self._envelope_ok(cpu_used, cpu_a, mem_used, mem_a)

        if necessary_ok(0):
            return 0
        lo, hi = 0, MAX_AUTO_NODES + 1
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if necessary_ok(mid):
                hi = mid
            else:
                lo = mid
        return hi

    # --------------------------------------------------------------- probing ----

    def probe(self, n: int):
        """(all_ok, n_failed) for base + n new nodes, via one non-mutating
        device run plus the envelope check on the resulting carry totals."""
        from ..simulator.engine import Simulator

        trial = self.base_nodes + new_fake_nodes(self.new_node, n)
        sim = Simulator(trial, device=self.device, sched_config=self.sched_config)
        if self.cluster_objects is not None:
            sim.register_cluster_objects(self.cluster_objects)
        for rt in self.app_objects:
            sim.register_app_objects(rt)
        scheduled, total = sim.probe_pods(self.pods)
        n_failed = total - scheduled
        if n_failed:
            return False, n_failed
        u = sim.probe_utilization()
        ok = self._envelope_ok(u["cpu_used"], u["cpu_alloc"],
                               u["mem_used"], u["mem_alloc"])
        return ok, 0

    def search(self):
        """(found, best_n, history): the incremental encode-once probe session
        when the workload qualifies (one pod encoding + device transfer for the
        WHOLE search, candidates evaluated as multi-candidate fan-out rounds),
        else the fresh-probe doubling + binary refinement. history = [(n,
        n_failed)] for the give-up diagnostics. found=False means
        no-progress/max-exhausted."""
        self.stats = {"path": "fresh", "probes": 0, "dispatches": 0,
                      "encode_s": 0.0, "encodes": 0}
        out = self._search_incremental()
        if out is None:
            out = self._search_fresh()
        return out

    # ----------------------------------------------- incremental fan-out ----

    def _search_incremental(self):
        """Encode-once search over a ProbeSession, or None when the session's
        equivalence gates reject the workload (the caller then runs the
        fresh-probe search). The answer itself is re-validated ABOVE this
        layer: the Applier's _plan runs one full fresh-Simulator simulation at
        n and falls back to the reference-style full search on divergence —
        the existing provable-equivalence guard, unchanged."""
        from ..simulator.probe import ProbeSession

        session = ProbeSession.try_build(
            self.base_nodes, self.new_node, self.pods,
            cluster_objects=self.cluster_objects, app_objects=self.app_objects,
            n_new=2, fanout=PROBE_FANOUT, device=self.device, sched_config=self.sched_config)
        if session is None:
            return None
        self.session = session
        # the session's group encoding already holds the request totals: skip
        # lower_bound's per-pod host scan (measurable at 100k pods)
        lb = self.lower_bound(totals=session.batch_totals())
        self.stats.update(path="incremental", encode_s=session.encode_s,
                          encodes=session.encodes)
        if lb > MAX_AUTO_NODES:
            return False, MAX_AUTO_NODES, []
        m = max(lb, 1)

        def eval_many(cands):
            out = {}
            session.ensure_capacity(max(cands))
            res = session.probe_many(cands)
            self.stats["probes"] += len(res)
            self.stats["dispatches"] += 1
            for n, (scheduled, total, u) in res.items():
                nf = total - scheduled
                ok = nf == 0 and self._envelope_ok(
                    u["cpu_used"], u["cpu_alloc"], u["mem_used"], u["mem_alloc"])
                out[n] = (ok, nf)
            return out

        # The arithmetic bound is frequently EXACT (homogeneous workloads), so
        # the first dispatch probes it alone — one lane, no fan-out waste; if
        # it passes, minimality is already proven (everything below lb fails).
        first = lb if lb > 0 else 0
        res = eval_many([first])
        ok, nf = res[first]
        if ok:
            return True, first, []
        hist: List[tuple] = [(first, nf)]
        lo_fail = first
        hi_ok = None
        # Doubling collapsed into fan-out rounds: round r grids (2^r m, 2^(r+1) m]
        # with interior points, so the first passing round already brackets
        # tightly.
        round_lo = first + 1
        round_hi = min(2 * m, MAX_AUTO_NODES)
        while hi_ok is None:
            if round_lo > round_hi:
                return False, MAX_AUTO_NODES, hist
            cands = _grid(round_lo, round_hi, PROBE_FANOUT)
            res = eval_many(cands)
            for n in cands:  # increasing; feasibility is monotone in n
                ok, nf = res[n]
                if ok:
                    hi_ok = n
                    break
                lo_fail = max(lo_fail, n)
                hist.append((n, nf))
            if hi_ok is not None:
                break
            # 4x capacity with no progress: remaining pods unfixable by nodes
            last_n, last_nf = hist[-1]
            for n1, nf1 in hist:
                if nf1 > 0 and last_n >= 4 * n1 and last_nf >= nf1:
                    return False, last_n, hist
            if round_hi >= MAX_AUTO_NODES:
                return False, MAX_AUTO_NODES, hist
            round_lo, round_hi = round_hi + 1, min(round_hi * 2, MAX_AUTO_NODES)
        # (PROBE_FANOUT+1)-ary refinement of (lo_fail, hi_ok]
        while hi_ok - lo_fail > 1:
            cands = _interior(lo_fail, hi_ok, PROBE_FANOUT)
            res = eval_many(cands)
            for n in cands:
                ok, _ = res[n]
                if ok:
                    hi_ok = n
                    break
                lo_fail = n
        return True, hi_ok, hist

    # ---------------------------------------------------- fresh fallback ----

    def _search_fresh(self):
        """The original fresh-Simulator probe loop: doubling from the lower
        bound, then binary refinement — one fresh probe per candidate."""
        for key, v in (("probes", 0), ("dispatches", 0), ("encode_s", 0.0),
                       ("encodes", 0)):
            self.stats.setdefault(key, v)
        self.stats["path"] = "fresh"

        def probe(n):
            self.stats["probes"] += 1
            self.stats["dispatches"] += 1
            return self.probe(n)

        lb = self.lower_bound()
        if lb == 0:
            ok, nf = probe(0)
            if ok:
                return True, 0, []
            lb = 1
        hist = []
        lo, hi = max(0, lb - 1), max(lb, 1)  # everything below lb provably fails
        while hi <= MAX_AUTO_NODES:
            ok, nf = probe(hi)
            if ok:
                break
            hist.append((hi, nf))
            # 4x capacity with no progress: remaining pods unfixable by nodes
            if len(hist) >= 3 and hist[-1][1] >= hist[-3][1] > 0:
                return False, hi, hist
            lo, hi = hi, hi * 2
        else:
            return False, MAX_AUTO_NODES, hist
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            ok, _ = probe(mid)
            if ok:
                hi = mid
            else:
                lo = mid
        return True, hi, hist


@dataclass
class Options:
    simon_config: str = ""
    default_scheduler_config: str = ""
    use_greed: bool = False
    interactive: bool = False
    extended_resources: List[str] = field(default_factory=list)
    output_file: str = ""
    # not ported yet (ROADMAP A9): a non-zero value raises NotImplementedError
    deadline: float = 0.0
    resume_journal: str = ""
    # "cuda" (the default, None) or "cpu": the device of every Simulator the
    # run builds; without a CUDA device only an explicit "cpu" runs
    device: Optional[str] = None


class Applier:
    def __init__(self, opts: Options) -> None:
        self.opts = opts
        self.cfg: SimonConfig = parse_simon_config(opts.simon_config)
        validate_config(self.cfg, opts.default_scheduler_config)
        # --default-scheduler-config (GetAndSetSchedulerConfig,
        # pkg/simulator/utils.go:303-381): plugin enable/disable and score
        # weights; unsupported fields raise ConfigError here
        if opts.default_scheduler_config:
            from ..api.schedconfig import parse_scheduler_config

            self.sched_config = parse_scheduler_config(opts.default_scheduler_config)
        else:
            self.sched_config = None
        if opts.deadline:
            raise NotImplementedError("deadline is not ported yet (ROADMAP A9)")
        if opts.resume_journal:
            raise NotImplementedError("resume_journal is not ported yet (ROADMAP A9)")
        self.out: TextIO = sys.stdout
        self.planner: Optional[CapacityPlanner] = None  # the last run's planner, if it built

    # ------------------------------------------------------------------ inputs ----

    def _load_cluster(self) -> ResourceTypes:
        c = self.cfg.spec.cluster
        if c.kube_config:
            raise NotImplementedError(
                "a live cluster through kubeConfig is not ported yet (ROADMAP A10b)")
        return load_cluster_from_directory(c.custom_cluster)

    def _load_apps(self) -> List[AppResource]:
        apps: List[AppResource] = []
        for app in self.cfg.spec.app_list:
            if app.chart:
                raise NotImplementedError(
                    f"app {app.name}: chart apps are not ported yet (ROADMAP A7)")
            rt = load_resources_from_directory(app.path)
            apps.append(AppResource(name=app.name, resource=rt))
        return apps

    def _load_new_node(self) -> Optional[dict]:
        path = self.cfg.spec.new_node
        if not path:
            return None
        rt = load_resources_from_directory(path)
        if not rt.nodes:
            return None
        match_and_set_local_storage_annotation(rt.nodes, path)
        return rt.nodes[0]

    # ------------------------------------------------------------------- run ------

    def run(self) -> Optional[SimulateResult]:
        # The output file is opened (and closed) per run so a reused Applier never
        # writes to a closed stream; without --output-file, self.out stays stdout.
        if self.opts.output_file:
            prev = self.out
            with open(self.opts.output_file, "w") as f:
                self.out = f
                try:
                    return self._run()
                finally:
                    self.out = prev
        return self._run()

    def _run(self) -> Optional[SimulateResult]:
        cluster = self._load_cluster()
        apps = self._load_apps()
        if self.opts.interactive:
            apps = self._select_apps(apps)
        new_node = self._load_new_node()

        patch_funcs = []
        if self.opts.use_greed:
            from ..algo.queues import sort_greed

            def greed_patch(pods, _cluster=cluster):
                pods[:] = sort_greed(pods, _cluster.nodes)

            patch_funcs.append(greed_patch)

        result, n_added = self._plan(cluster, apps, new_node, patch_funcs)
        if result is None:
            return None

        self._println("Simulation success!")
        if n_added:
            self._println(f"(added {n_added} node(s) to make everything schedulable)")
        if len(result.backend_path) > 1:
            # no silent degradation: a mid-run failover is part of the report
            self._println("(degraded run: backend path "
                          + " -> ".join(result.backend_path) + ")")
        self.report(result.node_status, [a.name for a in apps])
        return result

    def _simulate_with(self, cluster, apps, new_node, n, patch_funcs) -> SimulateResult:
        trial = cluster.copy()
        trial.nodes = list(trial.nodes) + new_fake_nodes(new_node, n)
        return simulate(trial, apps, patch_pod_funcs=patch_funcs, device=self.opts.device,
                        sched_config=self.sched_config)

    def _plan(self, cluster, apps, new_node, patch_funcs):
        """Returns (result, nodes_added) or (None, 0) when the user exits / search
        fails. Interactive: the reference's survey loop. Non-interactive: auto-search
        the minimal node count — via CapacityPlanner probes when the workload
        qualifies (the answer is re-validated by one full simulation; any
        divergence falls back to the original loop), else the reference-style
        full-simulation doubling + binary search (apply.go:203-259)."""
        if self.opts.interactive:
            return self._plan_interactive(cluster, apps, new_node, patch_funcs)

        def ok(res: SimulateResult) -> bool:
            satisfied, _ = satisfy_resource_setting(res.node_status)
            return not res.unscheduled_pods and satisfied

        planner = CapacityPlanner.try_build(cluster, apps, new_node, patch_funcs,
                                            device=self.opts.device,
                                            sched_config=self.sched_config)
        self.planner = planner
        if planner is not None:
            found, n, hist = planner.search()
            if found:
                res = self._simulate_with(cluster, apps, new_node, n, patch_funcs)
                if ok(res):
                    return res, n
                # probe/simulation divergence: fall back to the full search
            elif hist:
                # no-progress give-up: one full simulation at the last probe
                # reproduces the reference-style diagnostics without replaying
                # the whole search with full simulations
                res_hi = self._simulate_with(cluster, apps, new_node, n, patch_funcs)
                if ok(res_hi):
                    return res_hi, n  # divergence in the passing direction
                if res_hi.unscheduled_pods:
                    for up in res_hi.unscheduled_pods:
                        self._println(f"  {namespace_of(up.pod)}/{name_of(up.pod)}: {up.reason}")
                    self._println(
                        f"{len(res_hi.unscheduled_pods)} pod(s) still unschedulable "
                        f"after adding {n} nodes with no improvement; they cannot "
                        "be fixed by capacity"
                    )
                    return None, 0
                # probes said unschedulable but the full run disagrees on the
                # envelope only: fall back to the full search
            else:
                self._println(f"gave up after {MAX_AUTO_NODES} added nodes")
                return None, 0

        res = self._simulate_with(cluster, apps, new_node, 0, patch_funcs)
        if ok(res):
            return res, 0
        if new_node is None:
            for up in res.unscheduled_pods:
                self._println(f"  {namespace_of(up.pod)}/{name_of(up.pod)}: {up.reason}")
            self._println(
                f"{len(res.unscheduled_pods)} pod(s) unschedulable and no newNode "
                "spec configured; cannot add capacity"
            )
            return None, 0

        fails = {0: len(res.unscheduled_pods)}
        lo, hi, res_hi = 0, 1, None
        while hi <= MAX_AUTO_NODES:
            res_hi = self._simulate_with(cluster, apps, new_node, hi, patch_funcs)
            if ok(res_hi):
                break
            fails[hi] = len(res_hi.unscheduled_pods)
            # Give up when 4x capacity brought no progress: the remaining pods fail
            # for reasons new nodes cannot fix (bad selectors, impossible affinity).
            ref = fails.get(max(hi // 4, 0))
            if hi >= 4 and ref is not None and fails[hi] >= ref > 0:
                for up in res_hi.unscheduled_pods:
                    self._println(f"  {namespace_of(up.pod)}/{name_of(up.pod)}: {up.reason}")
                self._println(
                    f"{fails[hi]} pod(s) still unschedulable after adding {hi} "
                    "nodes with no improvement; they cannot be fixed by capacity"
                )
                return None, 0
            lo, hi = hi, hi * 2
        else:
            self._println(f"gave up after {MAX_AUTO_NODES} added nodes")
            return None, 0

        best_n, best = hi, res_hi
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            res_mid = self._simulate_with(cluster, apps, new_node, mid, patch_funcs)
            if ok(res_mid):
                hi, best_n, best = mid, mid, res_mid
            else:
                lo = mid
        return best, best_n

    def _plan_interactive(self, cluster, apps, new_node, patch_funcs):
        n = 0
        res = self._simulate_with(cluster, apps, new_node, n, patch_funcs)
        while True:
            satisfied, reason = satisfy_resource_setting(res.node_status)
            if not res.unscheduled_pods and satisfied:
                return res, n
            if not res.unscheduled_pods:
                self._println(reason)
            msg = (
                f"there are still {len(res.unscheduled_pods)} pod(s) that can not be "
                f"scheduled when add {n} nodes, you can:"
            )
            choice = self._ask(
                msg,
                ["show error event of unscheduled pods", "add node(s)", "exit"],
            )
            if choice == 0:
                for i, up in enumerate(res.unscheduled_pods):
                    self._println(
                        f"{i:4d} {namespace_of(up.pod)}/{name_of(up.pod)}: {up.reason}"
                    )
                continue  # no re-simulation, like the reference's SurveyShowResults
            if choice == 1:
                try:
                    n = int(input("input node number: "))
                except (ValueError, EOFError):
                    n = 0
                res = self._simulate_with(cluster, apps, new_node, n, patch_funcs)
                continue
            return None, 0

    def _select_apps(self, apps: List[AppResource]) -> List[AppResource]:
        if not apps:
            return apps
        self._println("Confirm your apps (comma-separated indices, empty = all):")
        for i, a in enumerate(apps):
            self._println(f"  [{i}] {a.name}")
        try:
            line = input("> ").strip()
        except EOFError:
            return apps
        if not line:
            return apps
        picked = []
        for tok in line.split(","):
            tok = tok.strip()
            if tok.isdigit() and int(tok) < len(apps):
                picked.append(apps[int(tok)])
        return picked or apps

    def _ask(self, msg: str, options: List[str]) -> int:
        self._println(msg)
        for i, o in enumerate(options):
            self._println(f"  [{i}] {o}")
        try:
            line = input("> ").strip()
        except EOFError:
            return len(options) - 1  # exit
        return int(line) if line.isdigit() and int(line) < len(options) else 0

    # ----------------------------------------------------------------- report -----

    def _println(self, s: str = "") -> None:
        print(s, file=self.out)

    def report(self, node_statuses: List[NodeStatus], app_names: List[str]) -> None:
        ext = self.opts.extended_resources
        self._report_cluster(node_statuses, ext)
        self._report_apps(node_statuses, app_names)

    def _report_cluster(self, node_statuses: List[NodeStatus], ext: List[str]) -> None:
        self._println("Node Info")
        header = ["Node", "CPU Allocatable", "CPU Requests", "Memory Allocatable",
                  "Memory Requests", "Pod Count", "New Node"]
        rows = [header]
        for st in node_statuses:
            alloc = (st.node.get("status") or {}).get("allocatable") or {}
            cpu_alloc = parse_milli(alloc.get("cpu", 0))
            mem_alloc = parse_quantity(alloc.get("memory", 0))
            cpu_req = sum(pod_resource_requests(p).get("cpu", 0.0) for p in st.pods)
            mem_req = sum(pod_resource_requests(p).get("memory", 0.0) for p in st.pods)
            cpu_frac = int(cpu_req / cpu_alloc * 100) if cpu_alloc else 0
            mem_frac = int(mem_req / mem_alloc * 100) if mem_alloc else 0
            is_new = "√" if C.LabelNewNode in labels_of(st.node) else ""
            rows.append([
                name_of(st.node),
                _fmt_cpu(cpu_alloc),
                f"{_fmt_cpu(cpu_req)}({cpu_frac}%)",
                format_quantity(mem_alloc, binary=True),
                f"{format_quantity(mem_req, binary=True)}({mem_frac}%)",
                str(len(st.pods)),
                is_new,
            ])
        self._render_table(rows)
        self._println()
        if any("open-local" in e for e in ext):
            self._report_local_storage(node_statuses)
        if any("gpu" in e for e in ext):
            self._report_gpu(node_statuses)

    def _report_local_storage(self, node_statuses: List[NodeStatus]) -> None:
        self._println("Node Local Storage")
        rows = [["Node", "Storage Kind", "Storage Name", "Storage Allocatable",
                 "Storage Requests"]]
        for st in node_statuses:
            raw = annotations_of(st.node).get(C.AnnoNodeLocalStorage)
            if not raw:
                continue
            try:
                storage = NodeStorage.from_json(raw)
            except (json.JSONDecodeError, TypeError):
                continue
            for vg in storage.vgs:
                pct = int(vg.requested / vg.capacity * 100) if vg.capacity else 0
                rows.append([name_of(st.node), "VG", vg.name,
                             format_quantity(vg.capacity, binary=True),
                             f"{format_quantity(vg.requested, binary=True)}({pct}%)"])
            for dev in storage.devices:
                rows.append([name_of(st.node), f"Device({dev.media_type})",
                             dev.device,
                             format_quantity(dev.capacity, binary=True),
                             "used" if dev.is_allocated else "unused"])
        self._render_table(rows)
        self._println()

    def _report_gpu(self, node_statuses: List[NodeStatus]) -> None:
        from ..plugins.gpushare import gpu_report_rows, pod_gpu_index

        self._println("GPU Node Resource")
        rows = [["Node", "GPU ID", "GPU Request/Capacity", "Pod List"]]
        all_pods: List[dict] = []
        for st in node_statuses:
            rows.extend(gpu_report_rows(st.node, st.pods))
            all_pods.extend(st.pods)
        self._render_table(rows)
        self._println()
        # Pod -> Node map (apply.go:502-524)
        self._println("Pod -> Node Map")
        rows = [["Pod", "CPU Req", "Mem Req", "GPU Req", "Host Node", "GPU IDX"]]
        for p in sorted(all_pods, key=name_of):
            req = pod_resource_requests(p)
            rows.append([
                name_of(p),
                _fmt_cpu(req.get("cpu", 0.0)),
                format_quantity(req.get("memory", 0.0), binary=True),
                format_quantity(_pod_gpu_mem(p), binary=True),
                (p.get("spec") or {}).get("nodeName", ""),
                pod_gpu_index(p),
            ])
        self._render_table(rows)
        self._println()

    def _report_apps(self, node_statuses: List[NodeStatus], app_names: List[str]) -> None:
        self._println("App Info")
        rows = [["App", "Pod Count", "Nodes"]]
        for app in app_names:
            nodes: Dict[str, int] = {}
            count = 0
            for st in node_statuses:
                for p in st.pods:
                    if labels_of(p).get(C.LabelAppName) == app:
                        count += 1
                        nodes[name_of(st.node)] = nodes.get(name_of(st.node), 0) + 1
            spread = ", ".join(f"{k}({v})" for k, v in sorted(nodes.items()))
            rows.append([app, str(count), spread])
        self._render_table(rows)
        self._println()

    def _render_table(self, rows: List[List[str]]) -> None:
        if not rows:
            return
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        for r in rows:
            self._println("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


def _fmt_cpu(milli: float) -> str:
    """CPU quantities print in cores when whole, else milli (resource.Quantity.String)."""
    if milli % 1000 == 0:
        return str(int(milli // 1000))
    return f"{int(milli)}m"


def _pod_gpu_mem(pod: dict) -> float:
    """Total GPU memory request: per-GPU mem × count (apply.go:377-380)."""
    from ..plugins.gpushare import pod_gpu_count, pod_gpu_mem

    return float(pod_gpu_mem(pod) * pod_gpu_count(pod))


def satisfy_resource_setting(node_statuses: List[NodeStatus]):
    """satisfyResourceSetting (apply.go:689-775): average cpu/mem (and local-storage
    VG) occupancy must not exceed the MaxCPU/MaxMemory/MaxVG env percentages."""
    def env_pct(name: str) -> int:
        s = os.environ.get(name, "")
        if not s:
            return 100
        try:
            v = int(s)
        except ValueError:
            raise ConfigError(f"failed to convert env {name} to int: {s!r}")
        return v if 0 <= v <= 100 else 100

    maxcpu, maxmem, maxvg = env_pct(C.EnvMaxCPU), env_pct(C.EnvMaxMemory), env_pct(C.EnvMaxVG)

    cpu_alloc = mem_alloc = cpu_used = mem_used = 0.0
    vg_cap = vg_req = 0.0
    for st in node_statuses:
        alloc = (st.node.get("status") or {}).get("allocatable") or {}
        cpu_alloc += parse_milli(alloc.get("cpu", 0))
        mem_alloc += parse_quantity(alloc.get("memory", 0))
        for p in st.pods:
            req = pod_resource_requests(p)
            cpu_used += req.get("cpu", 0.0)
            mem_used += req.get("memory", 0.0)
        raw = annotations_of(st.node).get(C.AnnoNodeLocalStorage)
        if raw:
            try:
                storage = NodeStorage.from_json(raw)
            except (json.JSONDecodeError, TypeError):
                return False, f"error when unmarshal json data, node is {name_of(st.node)}"
            for vg in storage.vgs:
                vg_cap += vg.capacity
                vg_req += vg.requested

    cpu_rate = int(cpu_used / cpu_alloc * 100) if cpu_alloc else 0
    mem_rate = int(mem_used / mem_alloc * 100) if mem_alloc else 0
    if cpu_rate > maxcpu:
        return False, (f"the average occupancy rate({cpu_rate}%) of cpu goes beyond "
                       f"the env setting({maxcpu}%)")
    if mem_rate > maxmem:
        return False, (f"the average occupancy rate({mem_rate}%) of memory goes "
                       f"beyond the env setting({maxmem}%)")
    if vg_cap:
        vg_rate = int(vg_req / vg_cap * 100)
        if vg_rate > maxvg:
            return False, (f"the average occupancy rate({vg_rate}%) of vg goes "
                           f"beyond the env setting({maxvg}%)")
    return True, ""
