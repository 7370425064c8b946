"""simonsweep: scenario-family compilers (host code, copied from
`open_simulator_tpu/sweep/families.py`; only `build_workload` differs).

Each family compiles into a list of `Scenario`s — pure data: the scenario's
pod batch (ordered, contiguous per template), the node names it drains, the
pool nodes it activates, and its explicit PRNG key. Everything random draws
from numpy SeedSequence entropy (seed, family_index, scenario_index); the
SAME spec + seed always compiles the SAME scenarios, byte for byte.

The runner never re-derives any of this: a Scenario IS the overlay — the
copy-on-write machinery (serve/image.py lane_overlay) turns it into one
active-mask row + seed copy on the shared device-resident image.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .spec import PodTemplate, SweepSpec, SweepSpecError

ZONE_LABEL = "topology.kubernetes.io/zone"
TIER_LABEL = "simon.sweep/tier"
POOL_PREFIX = "sweep-pool-"


class Scenario(NamedTuple):
    """One independent cluster future: what changes vs the base cluster."""

    sid: int                 # report id, dense from 0 (0 = baseline)
    family: str
    label: str
    key: Tuple[int, int, int]          # (seed, family_index, scenario_index)
    pods: List[dict]                   # the scenario's what-if workload
    drains: Tuple[str, ...] = ()       # node names removed (with their pods)
    activates: Tuple[str, ...] = ()    # pool node names added
    meta: Tuple[Tuple[str, object], ...] = ()

    def meta_dict(self) -> Dict[str, object]:
        return dict(self.meta)


# ------------------------------------------------------------ pod building ---


def build_pod(name: str, tmpl: PodTemplate) -> dict:
    labels = {"app": tmpl.name, TIER_LABEL: tmpl.tier, **dict(tmpl.labels)}
    spec: dict = {
        "containers": [{
            "name": "main",
            "image": "simon-sweep",
            "resources": {"requests": {"cpu": tmpl.cpu,
                                       "memory": tmpl.memory}},
        }]
    }
    affinity = {}
    if tmpl.anti_affinity_on:
        affinity["podAntiAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {
                    "matchLabels": {"app": tmpl.anti_affinity_on}},
                "topologyKey": "kubernetes.io/hostname",
            }]}
    if tmpl.affinity_on:
        # self-matching required affinity routes OFF the plain wave (the
        # engine's affinity route) — the sweep then rides the exact
        # per-lane serial-scan lane (sweep_whatif_fanout)
        affinity["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {
                    "matchLabels": {"app": tmpl.affinity_on}},
                "topologyKey": "kubernetes.io/hostname",
            }]}
    if affinity:
        spec["affinity"] = affinity
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default", "labels": labels},
        "spec": spec,
    }


def build_workload(templates: Sequence[PodTemplate],
                   _cache: Optional[dict] = None) -> List[dict]:
    """The ordered pod batch for one scenario: one block per PodTemplate,
    each block's replicas contiguous (one wave segment each), names unique
    within the scenario (block-local numbering) so the serial oracle's
    census filters on them. Scenarios with an IDENTICAL template list share
    one list (`_cache`), so a drain or outage grid holds one copy of its
    workload, and its pods' signature memos are computed once. The JAX
    package builds the same dicts as a columnar PodStore, which this port
    does not take yet (ROADMAP A14)."""
    key = tuple(templates)
    if _cache is not None and key in _cache:
        return _cache[key]
    pods = [build_pod(f"sw-{tmpl.name}-{i:05d}", tmpl)
            for tmpl in templates for i in range(tmpl.replicas)]
    if _cache is not None:
        _cache[key] = pods
    return pods


# ----------------------------------------------------------- base building ---


def build_node(name: str, cpu: str, memory: str, pods: str,
               zone: str = "", extra_labels: Optional[dict] = None) -> dict:
    labels = {"kubernetes.io/hostname": name, **(extra_labels or {})}
    if zone:
        labels[ZONE_LABEL] = zone
    alloc = {"cpu": cpu, "memory": memory, "pods": pods}
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels},
        "spec": {},
        "status": {"allocatable": dict(alloc), "capacity": dict(alloc)},
    }


def build_base(spec: SweepSpec) -> Tuple[List[dict], List[dict]]:
    """(nodes, bound_pods) for the spec's base cluster."""
    if spec.base.cluster:
        return _load_cluster(spec.base.cluster)
    syn = spec.base.synthetic
    assert syn is not None
    nodes = [build_node(
        f"sweep-node-{i:05d}", syn.cpu, syn.memory, syn.pods,
        zone=(f"zone-{i % syn.zones}" if syn.zones else ""))
        for i in range(syn.nodes)]
    bound = []
    for i in range(syn.bound):
        tmpl = PodTemplate(name="bound", replicas=0, cpu=syn.bound_cpu,
                           memory=syn.bound_memory, tier="bound")
        pod = build_pod(f"sweep-bound-{i:05d}", tmpl)
        pod["spec"]["nodeName"] = nodes[i % len(nodes)]["metadata"]["name"]
        bound.append(pod)
    return nodes, bound


def _load_cluster(path: str) -> Tuple[List[dict], List[dict]]:
    """Nodes + bound pods from a YAML file or directory (kind: Node / Pod;
    a pod without spec.nodeName in cluster files is rejected — the base
    cluster is committed state, workloads belong in spec.workload)."""
    import os

    from ..utils.yamlio import decode_yaml_content, read_yaml_files

    if os.path.isdir(path):
        contents = read_yaml_files(path)
    elif os.path.isfile(path):
        with open(path, "r", encoding="utf-8") as fh:
            contents = [fh.read()]
    else:
        raise SweepSpecError(f"base.cluster path not found: {path}")
    nodes: List[dict] = []
    bound: List[dict] = []
    for obj in decode_yaml_content(contents):
        kind = obj.get("kind", "")
        if kind == "Node":
            nodes.append(obj)
        elif kind == "Pod":
            if not (obj.get("spec") or {}).get("nodeName"):
                raise SweepSpecError(
                    f"base.cluster pod "
                    f"{(obj.get('metadata') or {}).get('name')!r} has no "
                    f"spec.nodeName; unbound workloads belong in "
                    f"spec.workload")
            bound.append(obj)
    if not nodes:
        raise SweepSpecError(f"base.cluster {path} contains no Node objects")
    return nodes, bound


def zones_of(nodes: Sequence[dict]) -> Dict[str, List[str]]:
    """zone name -> node names, in node order (insertion-ordered)."""
    out: Dict[str, List[str]] = {}
    for n in nodes:
        zone = ((n.get("metadata") or {}).get("labels") or {}).get(ZONE_LABEL)
        if zone:
            out.setdefault(zone, []).append(
                (n.get("metadata") or {}).get("name", ""))
    return out


# ------------------------------------------------------------- compilation ---


def _rng(key: Tuple[int, int, int]) -> np.random.Generator:
    """The ONLY entropy source in the sweep path: an explicit SeedSequence
    key. No wall clock, no global numpy state."""
    return np.random.default_rng(np.random.SeedSequence(entropy=list(key)))


class CompiledSweep(NamedTuple):
    scenarios: List[Scenario]
    pool_nodes: List[dict]   # union nodepool, pre-encoded into the image


def compile_families(spec: SweepSpec, seed: int,
                     base_nodes: Sequence[dict]) -> CompiledSweep:
    """Every scenario of every family, plus the union pool-node list. The
    baseline scenario (the unmodified shared workload) is always sid 0 —
    the anchor lane storm-victim counts and capacity envelopes compare
    against."""
    node_names = [(n.get("metadata") or {}).get("name", "")
                  for n in base_nodes]
    name_set = set(node_names)
    zone_map = zones_of(base_nodes)
    scenarios: List[Scenario] = []

    wl_cache: Dict[tuple, List[dict]] = {}

    def workload(templates):
        return build_workload(templates, _cache=wl_cache)

    def add(family: str, label: str, key, pods, drains=(), activates=(),
            meta=()):
        scenarios.append(Scenario(
            sid=len(scenarios), family=family, label=label, key=tuple(key),
            pods=pods, drains=tuple(drains), activates=tuple(activates),
            meta=tuple(meta)))

    add("baseline", "baseline", (seed, -1, 0), workload(spec.workload))

    pool_max = 0
    pool_tmpl: Optional[Tuple[str, str, str]] = None
    for fi, fam in enumerate(spec.families):
        if fam.kind == "zone_outage":
            zones = fam.opt("zones")
            zone_names = (sorted(zone_map) if zones == "all"
                          else list(zones))
            for z in zone_names:
                if z not in zone_map:
                    raise SweepSpecError(
                        f"zone_outage names unknown zone {z!r} "
                        f"(cluster zones: {sorted(zone_map) or 'none'})")
            if not zone_names:
                raise SweepSpecError(
                    "zone_outage on a cluster with no "
                    f"{ZONE_LABEL} labels")
            groups = ([(z,) for z in zone_names] if fam.opt("width") == 1
                      else [(a, b) for i, a in enumerate(zone_names)
                            for b in zone_names[i + 1:]])
            if not groups:
                # width=2 with a single zone: refuse loudly — silently
                # compiling zero scenarios would report a grid that never ran
                raise SweepSpecError(
                    f"zone_outage width=2 needs at least 2 zones "
                    f"(cluster has {len(zone_names)}: {zone_names})")
            for si, grp in enumerate(groups):
                drains = [n for z in grp for n in zone_map[z]]
                add("zone_outage", f"outage:{'+'.join(grp)}",
                    (seed, fi, si), workload(spec.workload),
                    drains=drains,
                    meta=(("zones", list(grp)),))
        elif fam.kind == "node_drain":
            si = 0
            for k in fam.opt("counts"):
                if k >= len(node_names):
                    raise SweepSpecError(
                        f"node_drain count {k} >= cluster size "
                        f"{len(node_names)}")
                for _ in range(fam.opt("draws")):
                    key = (seed, fi, si)
                    drains = sorted(_rng(key).choice(
                        np.asarray(node_names, dtype=object), size=k,
                        replace=False).tolist())
                    add("node_drain", f"drain:k={k}#{si}", key,
                        workload(spec.workload),
                        drains=drains, meta=(("k", k),))
                    si += 1
        elif fam.kind == "preemption_storm":
            for si, m in enumerate(fam.opt("storms")):
                storm = PodTemplate(
                    name=f"storm{m}", replicas=m, cpu=fam.opt("cpu"),
                    memory=fam.opt("memory"), tier="storm")
                # priority-ordered admission: storm pods FIRST (the order
                # the reference's priority queue would produce), then the
                # baseline workload — displaced baseline pods are the
                # victim proxy (PARITY.md "Sweep fuzzing")
                add("preemption_storm", f"storm:m={m}", (seed, fi, si),
                    workload((storm,) + spec.workload),
                    meta=(("storm", m),))
        elif fam.kind == "rollout_wave":
            target = fam.opt("workload")
            for si, pct in enumerate(fam.opt("steps")):
                templates: List[PodTemplate] = []
                for t in spec.workload:
                    if t.name != target:
                        templates.append(t)
                        continue
                    moved = (t.replicas * pct) // 100
                    if t.replicas - moved:
                        templates.append(
                            t._replace(replicas=t.replicas - moved))
                    if moved:
                        templates.append(PodTemplate(
                            name=f"{t.name}-v2", replicas=moved,
                            cpu=fam.opt("cpu"), memory=fam.opt("memory"),
                            labels=t.labels, tier="rollout"))
                add("rollout_wave", f"rollout:{target}@{pct}%",
                    (seed, fi, si), workload(tuple(templates)),
                    meta=(("step", pct), ("workload", target)))
        elif fam.kind == "nodepool_mix":
            counts = fam.opt("counts")
            tmpl = (fam.opt("cpu"), fam.opt("memory"), fam.opt("pods"))
            if pool_tmpl is not None and pool_tmpl != tmpl:
                raise SweepSpecError(
                    "multiple nodepool_mix families must share one node "
                    "template (one pre-encoded pool)")
            pool_tmpl = tmpl
            pool_max = max(pool_max, max(counts))
            for si, k in enumerate(counts):
                activates = [f"{POOL_PREFIX}{i:05d}" for i in range(k)]
                add("nodepool_mix", f"pool:k={k}", (seed, fi, si),
                    workload(spec.workload),
                    activates=activates, meta=(("pool", k),))
        elif fam.kind == "monte_carlo":
            for si in range(fam.opt("draws")):
                key = (seed, fi, si)
                rng = _rng(key)
                templates = []
                for base, lo, hi in fam.opt("templates"):
                    templates.append(base._replace(
                        replicas=int(rng.integers(lo, hi + 1))))
                add("monte_carlo", f"mc:#{si}", key,
                    workload(tuple(templates)),
                    meta=(("draw", si),))
    for sc in scenarios:
        for name in sc.drains:
            if name not in name_set:
                raise SweepSpecError(
                    f"scenario {sc.label!r} drains unknown node {name!r}")
    pool_nodes: List[dict] = []
    if pool_max:
        cpu, memory, pods = pool_tmpl
        for i in range(pool_max):
            name = f"{POOL_PREFIX}{i:05d}"
            if name in name_set:
                raise SweepSpecError(
                    f"base cluster already has a node named {name!r} "
                    f"(the nodepool prefix {POOL_PREFIX!r} is reserved)")
            pool_nodes.append(build_node(
                name, cpu, memory, pods,
                extra_labels={"simon.sweep/pool": "true"}))
    return CompiledSweep(scenarios=scenarios, pool_nodes=pool_nodes)
