"""simonsweep: sweep-spec parsing and validation (host code, copied from
`open_simulator_tpu/sweep/spec.py`).

A sweep spec (YAML/JSON, kind: SweepSpec) names ONE base cluster, ONE shared
baseline workload (an ordered list of pod templates), and N scenario
families. Each family compiles (sweep/families.py) into independent
scenarios — node drains, zone outages, priority-ordered preemption storms,
rollout waves, heterogeneous nodepool mixes, seeded Monte-Carlo workload
draws — that the runner (sweep/runner.py) batches onto the scenario axis of
the sweep fan-out kernels.

Determinism contract: everything random derives from the spec's `seed`
through explicit numpy SeedSequence keys (seed, family_index,
scenario_index) — no wall clock, no ambient entropy — so `simon sweep
--seed K` twice produces byte-identical report JSON (tests/test_sweep.py
asserts it).

Probe semantics: scenarios are what-if probes (like serve/), so pod
templates may NOT set spec.priority — mixed priorities would arm the serial
oracle's DefaultPreemption PostFilter, which probe lanes deliberately do not
run. The preemption_storm family models preemption pressure by
priority-ORDERED admission instead (storm pods first, the order the
reference's priority queue produces); see PARITY.md "Sweep fuzzing".
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

SCHEMA = 1

FAMILY_KINDS = ("zone_outage", "node_drain", "preemption_storm",
                "rollout_wave", "nodepool_mix", "monte_carlo")


class SweepSpecError(ValueError):
    """A malformed sweep spec — always raised with the offending field."""


class PodTemplate(NamedTuple):
    """One workload template: `replicas` identical pods, contiguous in the
    batch (the shape real apps produce, and what the wave lane fuses)."""

    name: str
    replicas: int
    cpu: str = "500m"
    memory: str = "512Mi"
    labels: Tuple[Tuple[str, str], ...] = ()
    anti_affinity_on: str = ""   # required anti-affinity vs app=<value>
    affinity_on: str = ""        # required co-location affinity vs app=<value>
    tier: str = "baseline"       # baseline | storm | rollout (report tiers)


class SyntheticBase(NamedTuple):
    nodes: int
    zones: int = 0
    cpu: str = "8"
    memory: str = "16Gi"
    pods: str = "110"
    bound: int = 0               # bound pods committed round-robin
    bound_cpu: str = "500m"
    bound_memory: str = "512Mi"


class BaseSpec(NamedTuple):
    """Either a synthetic cluster or a path of YAML Node (+ bound Pod)
    objects; exactly one of the two is set."""

    synthetic: Optional[SyntheticBase] = None
    cluster: str = ""


class FamilySpec(NamedTuple):
    kind: str
    options: Tuple[Tuple[str, object], ...]  # normalized, hashable

    def opt(self, key: str, default=None):
        for k, v in self.options:
            if k == key:
                return v
        return default


class SweepSpec(NamedTuple):
    name: str
    seed: int
    base: BaseSpec
    workload: Tuple[PodTemplate, ...]
    families: Tuple[FamilySpec, ...]

    def digest(self) -> str:
        """Stable identity of the spec (pre-seed-override): what the report
        records so two runs are comparable only when the spec matched."""
        payload = json.dumps(_normalize(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _normalize(spec: SweepSpec):
    return {
        "schema": SCHEMA,
        "name": spec.name,
        "seed": spec.seed,
        "base": (spec.base.synthetic._asdict() if spec.base.synthetic
                 else {"cluster": spec.base.cluster}),
        "workload": [t._asdict() for t in spec.workload],
        "families": [{"kind": f.kind, "options": list(f.options)}
                     for f in spec.families],
    }


# ------------------------------------------------------------------ parsing ---


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SweepSpecError(msg)


def _as_int(doc: dict, key: str, default=None, minimum=0) -> int:
    v = doc.get(key, default)
    _require(v is not None, f"missing required field '{key}'")
    _require(isinstance(v, int) and not isinstance(v, bool) and v >= minimum,
             f"'{key}' must be an integer >= {minimum} (got {v!r})")
    return v


def _as_str(doc: dict, key: str, default=None) -> str:
    v = doc.get(key, default)
    _require(v is not None, f"missing required field '{key}'")
    return str(v)


def _as_int_list(doc: dict, key: str, minimum=0) -> Tuple[int, ...]:
    v = doc.get(key)
    _require(isinstance(v, (list, tuple)) and v,
             f"'{key}' must be a non-empty list of integers")
    out = []
    for x in v:
        _require(isinstance(x, int) and not isinstance(x, bool)
                 and x >= minimum,
                 f"'{key}' entries must be integers >= {minimum} (got {x!r})")
        out.append(x)
    return tuple(out)


def _parse_template(doc: dict, tier: str = "baseline") -> PodTemplate:
    _require(isinstance(doc, dict), f"workload template must be a mapping "
                                    f"(got {type(doc).__name__})")
    _require("priority" not in doc and "priorityClassName" not in doc,
             "pod templates may not set a priority: sweep lanes are what-if "
             "probes (no PostFilter preemption); the preemption_storm family "
             "models priority by admission ORDER instead")
    name = _as_str(doc, "name")
    labels = doc.get("labels") or {}
    _require(isinstance(labels, dict), "'labels' must be a mapping")
    return PodTemplate(
        name=name,
        replicas=_as_int(doc, "replicas", minimum=0),
        cpu=_as_str(doc, "cpu", "500m"),
        memory=_as_str(doc, "memory", "512Mi"),
        labels=tuple(sorted((str(k), str(v)) for k, v in labels.items())),
        anti_affinity_on=str(doc.get("antiAffinityOn", "") or ""),
        affinity_on=str(doc.get("affinityOn", "") or ""),
        tier=tier,
    )


def _parse_base(doc: dict) -> BaseSpec:
    _require(isinstance(doc, dict) and doc, "spec.base must be a mapping with "
                                            "'synthetic' or 'cluster'")
    syn, cluster = doc.get("synthetic"), doc.get("cluster", "")
    _require(bool(syn) != bool(cluster),
             "spec.base needs exactly one of 'synthetic' or 'cluster'")
    if cluster:
        return BaseSpec(cluster=str(cluster))
    _require(isinstance(syn, dict), "'synthetic' must be a mapping")
    return BaseSpec(synthetic=SyntheticBase(
        nodes=_as_int(syn, "nodes", minimum=1),
        zones=_as_int(syn, "zones", 0),
        cpu=_as_str(syn, "cpu", "8"),
        memory=_as_str(syn, "memory", "16Gi"),
        pods=_as_str(syn, "pods", "110"),
        bound=_as_int(syn, "bound", 0),
        bound_cpu=_as_str(syn, "boundCpu", "500m"),
        bound_memory=_as_str(syn, "boundMemory", "512Mi"),
    ))


def _parse_family(doc: dict, workload: Sequence[PodTemplate]) -> FamilySpec:
    _require(isinstance(doc, dict), "family must be a mapping")
    kind = _as_str(doc, "kind")
    _require(kind in FAMILY_KINDS,
             f"unknown family kind {kind!r} (known: {', '.join(FAMILY_KINDS)})")
    opts: Dict[str, object] = {}
    if kind == "zone_outage":
        zones = doc.get("zones", "all")
        if zones != "all":
            _require(isinstance(zones, (list, tuple)) and zones,
                     "'zones' must be 'all' or a non-empty list of zone names")
            zones = tuple(str(z) for z in zones)
        width = _as_int(doc, "width", 1, minimum=1)
        _require(width <= 2, "'width' must be 1 (single zones) or 2 (pairs)")
        opts = {"zones": zones, "width": width}
    elif kind == "node_drain":
        opts = {"counts": _as_int_list(doc, "counts", minimum=1),
                "draws": _as_int(doc, "draws", 1, minimum=1)}
    elif kind == "preemption_storm":
        opts = {"storms": _as_int_list(doc, "storms", minimum=1),
                "cpu": _as_str(doc, "cpu", "1"),
                "memory": _as_str(doc, "memory", "1Gi")}
    elif kind == "rollout_wave":
        target = _as_str(doc, "workload")
        _require(any(t.name == target for t in workload),
                 f"rollout_wave targets unknown workload {target!r}")
        steps = _as_int_list(doc, "steps", minimum=0)
        _require(all(s <= 100 for s in steps),
                 "'steps' are percentages (0-100)")
        opts = {"workload": target, "steps": steps,
                "cpu": _as_str(doc, "cpu", "750m"),
                "memory": _as_str(doc, "memory", "768Mi")}
    elif kind == "nodepool_mix":
        opts = {"counts": _as_int_list(doc, "counts", minimum=1),
                "cpu": _as_str(doc, "cpu", "16"),
                "memory": _as_str(doc, "memory", "32Gi"),
                "pods": _as_str(doc, "pods", "110")}
    elif kind == "monte_carlo":
        raw = doc.get("templates")
        _require(isinstance(raw, (list, tuple)) and raw,
                 "'templates' must be a non-empty list")
        templates = []
        for t in raw:
            _require(isinstance(t, dict),
                     f"monte_carlo 'templates' entries must be mappings "
                     f"(got {type(t).__name__})")
            rng = t.get("replicas")
            _require(isinstance(rng, (list, tuple)) and len(rng) == 2
                     and all(isinstance(x, int) for x in rng)
                     and 0 <= rng[0] <= rng[1],
                     "monte_carlo template 'replicas' must be [lo, hi]")
            base = _parse_template({**t, "replicas": 0})
            templates.append((base, int(rng[0]), int(rng[1])))
        opts = {"draws": _as_int(doc, "draws", 1, minimum=1),
                "templates": tuple(templates)}
    return FamilySpec(kind=kind, options=tuple(sorted(opts.items())))


def parse_spec(doc: dict) -> SweepSpec:
    _require(isinstance(doc, dict), "sweep spec must be a mapping")
    kind = doc.get("kind", "SweepSpec")
    _require(kind == "SweepSpec", f"kind must be SweepSpec (got {kind!r})")
    spec = doc.get("spec") or {}
    _require(isinstance(spec, dict) and spec, "missing 'spec' body")
    name = ((doc.get("metadata") or {}).get("name")
            or spec.get("name") or "sweep")
    workload_raw = spec.get("workload")
    _require(isinstance(workload_raw, (list, tuple)) and workload_raw,
             "spec.workload must be a non-empty list of pod templates")
    workload = tuple(_parse_template(t) for t in workload_raw)
    names = [t.name for t in workload]
    _require(len(set(names)) == len(names),
             f"duplicate workload template names: {names}")
    fams_raw = spec.get("families")
    _require(isinstance(fams_raw, (list, tuple)) and fams_raw,
             "spec.families must be a non-empty list")
    return SweepSpec(
        name=str(name),
        seed=_as_int(spec, "seed", 0),
        base=_parse_base(spec.get("base") or {}),
        workload=workload,
        families=tuple(_parse_family(f, workload) for f in fams_raw),
    )


def load_spec(path: str) -> SweepSpec:
    """Parse a sweep spec from a YAML or JSON file."""
    if not os.path.isfile(path):
        raise SweepSpecError(f"no such sweep spec file: {path}")
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    import yaml

    try:
        doc = (json.loads(text) if path.endswith(".json")
               else yaml.safe_load(text))
    except (ValueError, yaml.YAMLError) as e:
        # json.JSONDecodeError is a ValueError; the CLI handles
        # SweepSpecError, so a syntax typo prints one line, not a traceback
        raise SweepSpecError(f"{path}: unparseable spec: {e}") from None
    try:
        return parse_spec(doc)
    except SweepSpecError as e:
        raise SweepSpecError(f"{path}: {e}") from None
