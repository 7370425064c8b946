"""simonsweep: the cross-scenario report (host code, copied from
`open_simulator_tpu/sweep/report.py`: the same keys, dispatch names and
float formatting, so that both packages write the same bytes).

Per-scenario metrics rows plus per-family aggregates — schedulable-fraction
distributions, the nodepool capacity envelope, the preemption-storm victim
histogram — rendered by the CLI and dumped as JSON.

Determinism contract: the report carries NO wall-clock, hostname, or other
ambient state — every field derives from (spec, seed, results), so two runs
of `simon sweep --seed K` produce byte-identical JSON (the regression test's
whole assertion). Timings go to the CLI's stderr, never in here.
"""

from __future__ import annotations

import json
from statistics import median
from typing import Dict, List

from .families import zones_of
from .runner import ScenarioResult, SweepRunner

SCHEMA = 1


def _frac(scheduled: int, total: int) -> float:
    return round(scheduled / total, 6) if total else 1.0


def _dist(values: List[float]) -> Dict[str, float]:
    return {"min": min(values), "p50": round(median(values), 6),
            "max": max(values)}


def _scenario_row(res: ScenarioResult) -> dict:
    sc = res.scenario
    return {
        "id": sc.sid,
        "family": sc.family,
        "label": sc.label,
        "key": list(sc.key),
        "route": res.route,
        **({"gate": res.gate} if res.gate else {}),
        "pods": res.total,
        "scheduled": res.scheduled,
        "unscheduled": res.total - res.scheduled,
        "fraction": _frac(res.scheduled, res.total),
        "nodes": res.nodes_live,
        "drains": len(sc.drains),
        "activates": len(sc.activates),
        "tiers": {k: res.tiers[k] for k in sorted(res.tiers)},
        "utilization": res.utilization,
        "meta": {k: v for k, v in sc.meta},
    }


def _victims(res: ScenarioResult, baseline: ScenarioResult) -> int:
    """The storm's displaced-baseline count: baseline-tier pods that
    scheduled in the anchor lane but not under the storm — the set
    DefaultPreemption would evict on a capacity-bound cluster, modeled by
    priority-ordered admission (PARITY.md "Sweep fuzzing")."""
    return max(0, baseline.tiers.get("baseline", 0)
               - res.tiers.get("baseline", 0))


def _victim_bucket(v: int) -> str:
    if v == 0:
        return "0"
    if v < 10:
        return "1-9"
    if v < 50:
        return "10-49"
    return "50+"


def _family_summary(family: str, rows: List[dict],
                    results: List[ScenarioResult],
                    baseline: ScenarioResult) -> dict:
    out: dict = {
        "scenarios": len(rows),
        "fraction": _dist([r["fraction"] for r in rows]),
        "scheduled": _dist([float(r["scheduled"]) for r in rows]),
    }
    if family == "preemption_storm":
        victims = [_victims(res, baseline) for res in results]
        hist: Dict[str, int] = {}
        for v in victims:
            hist[_victim_bucket(v)] = hist.get(_victim_bucket(v), 0) + 1
        out["victims"] = {
            "per_scenario": [
                {"label": res.scenario.label, "storm": res.scenario
                 .meta_dict().get("storm"), "victims": v}
                for res, v in zip(results, victims)],
            "hist": {k: hist[k] for k in sorted(hist)},
            "max": max(victims) if victims else 0,
        }
    if family == "nodepool_mix":
        env = sorted(
            ({"pool": res.scenario.meta_dict().get("pool"),
              "nodes": res.nodes_live, "scheduled": res.scheduled,
              "fraction": _frac(res.scheduled, res.total)}
             for res in results),
            key=lambda e: e["pool"])
        out["capacity_envelope"] = env
    if family == "zone_outage":
        out["per_zone"] = [
            {"zones": res.scenario.meta_dict().get("zones"),
             "fraction": _frac(res.scheduled, res.total),
             "drained_nodes": len(res.scenario.drains)}
            for res in results]
    return out


def build_report(runner: SweepRunner) -> dict:
    spec = runner.spec
    ordered = [runner.results[sid] for sid in sorted(runner.results)]
    baseline = ordered[0]
    rows = [_scenario_row(res) for res in ordered]
    fam_order: List[str] = []
    by_family: Dict[str, List[int]] = {}
    for i, res in enumerate(ordered):
        fam = res.scenario.family
        if fam not in by_family:
            fam_order.append(fam)
            by_family[fam] = []
        by_family[fam].append(i)
    routes: Dict[str, int] = {}
    for res in ordered:
        routes[res.route] = routes.get(res.route, 0) + 1
    return {
        "kind": "SweepReport",
        "schema": SCHEMA,
        "name": spec.name,
        "seed": runner.seed,
        "spec_digest": spec.digest(),
        "base": {
            "nodes": len(runner._base_nodes),
            "bound_pods": len(runner._bound),
            "pool_nodes": len(runner._pool_nodes),
            "zones": sorted(zones_of(runner._base_nodes)),
            "resident_image": runner.image is not None,
        },
        "lanes": {k: routes[k] for k in sorted(routes)},
        "dispatches": {k: runner.dispatches[k]
                       for k in sorted(runner.dispatches)},
        "parity": {
            "mode": runner.parity,
            "checked": runner.parity_checked,
            "mismatches": 0,   # a mismatch raises before a report exists
        },
        "scenarios": rows,
        "families": {
            fam: _family_summary(fam, [rows[i] for i in by_family[fam]],
                                 [ordered[i] for i in by_family[fam]],
                                 baseline)
            for fam in fam_order
        },
    }


def report_json(report: dict) -> str:
    """THE byte-stable serialization: sorted keys, fixed separators, one
    trailing newline — what --out writes and the determinism test hashes."""
    return json.dumps(report, sort_keys=True, indent=1) + "\n"


def render_report(report: dict) -> str:
    """Human rendering for the CLI: per-family summary lines + the worst
    scenarios by schedulable fraction."""
    lines = [
        f"sweep {report['name']!r}: {len(report['scenarios'])} scenarios, "
        f"seed {report['seed']}, lanes {report['lanes']}, "
        f"dispatches {report['dispatches'] or '(none batched)'}",
        f"  base: {report['base']['nodes']} nodes"
        + (f" / zones {', '.join(report['base']['zones'])}"
           if report['base']['zones'] else "")
        + (f" / {report['base']['bound_pods']} bound pods"
           if report['base']['bound_pods'] else "")
        + (f" / {report['base']['pool_nodes']} pool nodes"
           if report['base']['pool_nodes'] else ""),
        f"  parity: {report['parity']['mode']} "
        f"({report['parity']['checked']} lanes re-run serially, "
        f"{report['parity']['mismatches']} mismatches)",
    ]
    for fam, summary in report["families"].items():
        fr = summary["fraction"]
        lines.append(
            f"  {fam:<18} {summary['scenarios']:>3} scenario(s)  "
            f"schedulable {fr['min']:.3f} / {fr['p50']:.3f} / "
            f"{fr['max']:.3f} (min/p50/max)")
        if "victims" in summary:
            lines.append(f"    victims: max {summary['victims']['max']}, "
                         f"hist {summary['victims']['hist']}")
        if "capacity_envelope" in summary:
            env = " -> ".join(
                f"+{e['pool']}:{e['scheduled']}"
                for e in summary["capacity_envelope"])
            lines.append(f"    capacity envelope (pool:scheduled): {env}")
    worst = sorted(report["scenarios"], key=lambda r: r["fraction"])[:5]
    lines.append("  tightest scenarios:")
    for r in worst:
        lines.append(
            f"    [{r['id']:>3}] {r['label']:<24} {r['scheduled']}/"
            f"{r['pods']} scheduled ({r['fraction']:.3f}) on {r['nodes']} "
            f"nodes via {r['route']}")
    return "\n".join(lines)
