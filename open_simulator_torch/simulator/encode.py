"""Host-side tensorization: k8s objects → dense tables for the batched device scheduler.

This is the string-world ↔ tensor-world boundary (SURVEY.md §7). Everything the vendored
scheduler derives from strings — label selectors, affinity terms, taints, topology
domains, host ports — is interned and pre-evaluated here into numpy tables; the device
kernels (`open_simulator_torch.ops.kernels`) see only integers and floats.

Key ideas:
- **Groups**: pods sharing (namespace, labels, scheduling-relevant spec) — i.e. replicas
  of one workload — share one row of every per-pod table. Static node predicates
  (unschedulable, taints, nodeSelector, required node affinity) and static score inputs
  (Simon max-share, preferred-node-affinity weights, PreferNoSchedule taint counts) are
  evaluated once per group as `[N]` vectors.
- **Counters**: every pairwise pod relation (inter-pod affinity/anti-affinity terms,
  topology-spread constraints, selector-spread) reduces to "number of placed pods
  matching selector S in topology domain d". Distinct (topologyKey, namespaces,
  selector) triples become counter rows; the device carry holds `counter_count [T, D+1]`
  (last column = sentinel for nodes missing the topology key, always zero).
- **Carriers**: the reverse direction — "placed pods *carrying* term t in domain d" —
  for existing-pod anti-affinity (interpodaffinity filtering.go
  satisfyExistingPodsAntiAffinity) and existing-pod preferred/required terms in scoring
  (scoring.go processExistingPod).

DaemonSet pods pinned via matchFields metadata.name affinity are detected and encoded as
`forced_node` so that N pinned pods don't explode the group count.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import constants as C
from ..ops.resources import (
    PODS_I,
    ResourceAxis,
    pod_has_unknown_resource,
    pod_nonzero_cpu_mem,
)
from ..utils.interning import StringTable
from ..utils.objutil import (
    annotations_of,
    labels_of,
    match_label_selector,
    name_of,
    namespace_of,
    pod_host_ports,
    pod_resource_requests,
    toleration_tolerates_taint,
)

# ----------------------------------------------------------------- node arrays --------

_UNSCHED_TAINT = {"key": C.TaintNodeUnschedulable, "effect": "NoSchedule"}


class NodeArrays:
    """Vectorized view of the node list: per-label-key interned value columns, taints,
    allocatable matrix, zone/domain interning."""

    def __init__(self, nodes, axis: ResourceAxis) -> None:
        from .store import NodeStore

        if isinstance(nodes, NodeStore):
            # columnar fast path: adopt the store's block recipes directly —
            # no per-node dict parsing, and `self.nodes` becomes a lazy view
            # that materializes dicts only on indexed access
            self._init_from_store(nodes, axis)
            return
        self.nodes = nodes
        self.axis = axis
        self.N = len(nodes)
        self.names = [name_of(n) for n in nodes]
        self.index = {nm: i for i, nm in enumerate(self.names)}
        self.values = StringTable()  # shared value interner for labels & names

        # label key → int32[N] of value ids (0 = key absent)
        self.label_vals: Dict[str, np.ndarray] = {}
        for i, node in enumerate(nodes):
            for k, v in labels_of(node).items():
                col = self.label_vals.get(k)
                if col is None:
                    col = self.label_vals[k] = np.zeros(self.N, np.int32)
                col[i] = self.values.intern(str(v))
        self.name_ids = np.array([self.values.intern(nm) for nm in self.names], np.int32)

        self.taints: List[Tuple[tuple, ...]] = [
            tuple(
                (t.get("key", ""), t.get("value", "") or "", t.get("effect", ""))
                for t in (n.get("spec") or {}).get("taints") or []
            )
            for n in nodes
        ]
        self.unschedulable = np.array(
            [bool((n.get("spec") or {}).get("unschedulable")) for n in nodes], bool
        )
        self.alloc = np.stack([axis.node_vector(n) for n in nodes]) if nodes else np.zeros((0, axis.R))

        # zone composite key (utilnode.GetZoneKey): region + zone, either label family
        self.zones = StringTable()
        zid = np.zeros(self.N, np.int32)
        for i, node in enumerate(nodes):
            lbl = labels_of(node)
            region = lbl.get(C.LabelTopologyRegion) or lbl.get("failure-domain.beta.kubernetes.io/region") or ""
            zone = lbl.get(C.LabelTopologyZone) or lbl.get(C.LabelTopologyZoneBeta) or ""
            if region or zone:
                zid[i] = self.zones.intern((region, zone))
        self.zone_id = zid  # 0 = no zone

        # topology domains: (topo key, node's value) interned globally
        self.domains = StringTable()
        self._dom_cache: Dict[str, np.ndarray] = {}

    def _init_from_store(self, store, axis: ResourceAxis) -> None:
        """Build every column from a NodeStore's block recipes. Content is
        bit-identical to parsing the materialized dicts (the store parity
        suite holds BatchTables to byte equality); internal string-table ids
        may differ numerically, which no table ever observes — only equality
        and first-appearance order matter, and both are preserved because
        blocks are visited in node order."""
        from .store import LazyNodeSeq

        self.axis = axis
        self.N = N = len(store)
        self.nodes = LazyNodeSeq(store)
        self.names = store.gen_names()
        self.index = {nm: i for i, nm in enumerate(self.names)}
        self.values = StringTable()
        self.label_vals = {}
        self.taints = []
        self.unschedulable = np.zeros(N, bool)
        alloc_rows: List[np.ndarray] = []
        zid = np.zeros(N, np.int32)
        self.zones = StringTable()
        intern = self.values.intern
        off = 0
        for blk in store.blocks:
            cnt = blk.count
            end = off + cnt
            # per-node labels first, in the same per-node visitation order a
            # dict parse would use (hostname before index labels before
            # constants matters only for interner id assignment, which is
            # unobservable — see docstring)
            host_col = self.label_vals.get(HOSTNAME)
            if host_col is None:
                host_col = self.label_vals[HOSTNAME] = np.zeros(N, np.int32)
            for i in range(off, end):
                host_col[i] = intern(self.names[i])
            for k in blk.index_labels:
                col = self.label_vals.get(k)
                if col is None:
                    col = self.label_vals[k] = np.zeros(N, np.int32)
                for i in range(off, end):
                    col[i] = intern(str(i))
            for k, v in blk.labels:
                col = self.label_vals.get(k)
                if col is None:
                    col = self.label_vals[k] = np.zeros(N, np.int32)
                col[off:end] = intern(str(v))
            if blk.zone_cycle is not None:
                key, fmt, mod = blk.zone_cycle
                col = self.label_vals.get(key)
                if col is None:
                    col = self.label_vals[key] = np.zeros(N, np.int32)
                ids = np.array([intern(fmt.format(j)) for j in range(mod)],
                               np.int32)
                col[off:end] = ids[np.arange(off, end) % mod]
            lbl = dict(blk.labels)
            region = (lbl.get(C.LabelTopologyRegion)
                      or lbl.get("failure-domain.beta.kubernetes.io/region")
                      or "")
            zone_keys = (C.LabelTopologyZone, C.LabelTopologyZoneBeta)
            if blk.zone_cycle is not None and blk.zone_cycle[0] in zone_keys:
                key, fmt, mod = blk.zone_cycle
                zids = np.array(
                    [self.zones.intern((region, fmt.format(j)))
                     for j in range(mod)], np.int32)
                zid[off:end] = zids[np.arange(off, end) % mod]
            else:
                zone = next((str(lbl[k]) for k in zone_keys if k in lbl), "")
                if region or zone:
                    zid[off:end] = self.zones.intern((region, zone))
            if blk.taint is not None:
                t, every = blk.taint
                self.taints.extend(
                    ((t,) if i % every == 0 else ())
                    for i in range(off, end))
            else:
                self.taints.extend(() for _ in range(cnt))
            self.unschedulable[off:end] = bool(
                (blk.template.get("spec") or {}).get("unschedulable"))
            alloc_rows.append(np.repeat(
                axis.node_vector(blk.template)[None, :], cnt, axis=0))
            off = end
        self.name_ids = self.label_vals[HOSTNAME].copy() if N else np.zeros(
            0, np.int32)
        self.alloc = (np.concatenate(alloc_rows) if alloc_rows
                      else np.zeros((0, axis.R)))
        self.zone_id = zid
        self.domains = StringTable()
        self._dom_cache = {}

    def extend(self, nodes: List[dict]) -> None:
        """Append nodes IN PLACE — the serving image's delta-ingest path
        (serve/image.py): a live node-add event extends the columnar node
        store by parsing ONE node dict instead of rebuilding NodeArrays over
        the whole (10k+) cluster. Interners (values/zones/domains) are
        append-only, so every existing label/zone/domain id keeps its value;
        only the per-topology domain cache resets (new nodes append fresh
        hostname domains at the END of the table, never renumbering old
        ones). Callers re-derive anything shaped [*, N] afterwards
        (Encoder group statics via rebuild_group_axes, node-side batch
        tables via build_node_axis_tables)."""
        if not nodes:
            return
        base = self.N
        k = len(nodes)
        self.nodes.extend(nodes)
        self.N = len(self.nodes)
        new_names = [name_of(n) for n in nodes]
        self.names.extend(new_names)
        for j, nm in enumerate(new_names):
            self.index[nm] = base + j
        # pad existing label columns first, THEN intern the new nodes' labels
        # (a label key first seen on a new node allocates a full-length col)
        for key in list(self.label_vals):
            self.label_vals[key] = np.concatenate(
                [self.label_vals[key], np.zeros(k, np.int32)])
        for j, node in enumerate(nodes):
            for key, v in labels_of(node).items():
                col = self.label_vals.get(key)
                if col is None:
                    col = self.label_vals[key] = np.zeros(self.N, np.int32)
                col[base + j] = self.values.intern(str(v))
        self.name_ids = np.concatenate(
            [self.name_ids,
             np.array([self.values.intern(nm) for nm in new_names], np.int32)])
        self.taints.extend(
            tuple((t.get("key", ""), t.get("value", "") or "",
                   t.get("effect", ""))
                  for t in (n.get("spec") or {}).get("taints") or [])
            for n in nodes)
        self.unschedulable = np.concatenate(
            [self.unschedulable,
             np.array([bool((n.get("spec") or {}).get("unschedulable"))
                       for n in nodes], bool)])
        self.alloc = np.concatenate(
            [self.alloc, np.stack([self.axis.node_vector(n) for n in nodes])])
        zid = np.zeros(k, np.int32)
        for j, node in enumerate(nodes):
            lbl = labels_of(node)
            region = (lbl.get(C.LabelTopologyRegion)
                      or lbl.get("failure-domain.beta.kubernetes.io/region")
                      or "")
            zone = (lbl.get(C.LabelTopologyZone)
                    or lbl.get(C.LabelTopologyZoneBeta) or "")
            if region or zone:
                zid[j] = self.zones.intern((region, zone))
        self.zone_id = np.concatenate([self.zone_id, zid])
        self._dom_cache.clear()

    def label_numeric(self, key: str) -> np.ndarray:
        out = np.full(self.N, np.nan)
        col = self.label_vals.get(key)
        if col is None:
            return out
        for i in range(self.N):
            if col[i]:
                try:
                    out[i] = int(self.values.value(col[i]))
                except (TypeError, ValueError):
                    pass
        return out

    def domain_of(self, topo_key: str) -> np.ndarray:
        """int32[N] domain index per node under topo_key; -1 where the key is absent.
        (kubernetes.io/hostname always present per MakeValidNode → per-node domains.)"""
        cached = self._dom_cache.get(topo_key)
        if cached is not None:
            return cached
        col = self.label_vals.get(topo_key)
        out = np.full(self.N, -1, np.int32)
        if col is not None:
            for i in range(self.N):
                if col[i]:
                    out[i] = self.domains.intern((topo_key, int(col[i])))
        self._dom_cache[topo_key] = out
        return out

    @property
    def D(self) -> int:
        return len(self.domains)


# ----------------------------------------------------- vectorized node matchers -------


def _expr_vec(na: NodeArrays, expr: dict) -> np.ndarray:
    """NodeSelectorRequirement over labels → bool[N] (objutil.match_expression, vectorized)."""
    key, op = expr.get("key", ""), expr.get("operator", "In")
    values = expr.get("values") or []
    col = na.label_vals.get(key)
    present = (col > 0) if col is not None else np.zeros(na.N, bool)
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return ~present
    if op in ("Gt", "Lt"):
        if len(values) != 1:
            return np.zeros(na.N, bool)
        try:
            v = int(values[0])
        except ValueError:
            return np.zeros(na.N, bool)
        num = na.label_numeric(key)
        with np.errstate(invalid="ignore"):
            return (num > v) if op == "Gt" else (num < v)
    ids = np.array([na.values.lookup(v) for v in values], np.int32)
    if col is None:
        isin = np.zeros(na.N, bool)
    else:
        isin = np.isin(col, ids[ids > 0]) & present
    return isin if op == "In" else ~isin  # NotIn: absent key also matches


def _field_expr_vec(na: NodeArrays, expr: dict) -> np.ndarray:
    if expr.get("key") != "metadata.name":
        return np.zeros(na.N, bool)
    ids = np.array([na.values.lookup(v) for v in expr.get("values") or []], np.int32)
    isin = np.isin(na.name_ids, ids[ids > 0])
    op = expr.get("operator", "In")
    return isin if op == "In" else (~isin if op == "NotIn" else np.zeros(na.N, bool))


def node_selector_term_vec(na: NodeArrays, term: dict) -> np.ndarray:
    """One NodeSelectorTerm → bool[N]; empty term matches nothing (upstream semantics)."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return np.zeros(na.N, bool)
    m = np.ones(na.N, bool)
    for e in exprs:
        m &= _expr_vec(na, e)
    for e in fields:
        m &= _field_expr_vec(na, e)
    return m


def node_affinity_vec(na: NodeArrays, pod_spec: dict) -> np.ndarray:
    """nodeSelector map AND requiredDuringScheduling node affinity → bool[N]."""
    m = np.ones(na.N, bool)
    for k, v in (pod_spec.get("nodeSelector") or {}).items():
        col = na.label_vals.get(k)
        want = na.values.lookup(str(v))
        m &= (col == want) & (col > 0) if col is not None and want else np.zeros(na.N, bool)
    required = ((pod_spec.get("affinity") or {}).get("nodeAffinity") or {}).get(
        "requiredDuringSchedulingIgnoredDuringExecution"
    )
    if required:
        terms = required.get("nodeSelectorTerms") or []
        om = np.zeros(na.N, bool)
        for t in terms:
            om |= node_selector_term_vec(na, t)
        m &= om
    return m


def _taint_masks(na: NodeArrays, tolerations: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """(hard_ok[N], prefer_count[N]): NoSchedule/NoExecute all tolerated, and count of
    untolerated PreferNoSchedule taints (TaintToleration filter + score inputs)."""
    hard_ok = np.ones(na.N, bool)
    prefer_cnt = np.zeros(na.N, np.float32)
    # tolerations relevant to PreferNoSchedule scoring: effect empty or PreferNoSchedule
    pref_tols = [t for t in tolerations if not t.get("effect") or t.get("effect") == "PreferNoSchedule"]
    cache: Dict[tuple, Tuple[bool, int]] = {}
    for i, taints in enumerate(na.taints):
        if not taints:
            continue
        got = cache.get(taints)
        if got is None:
            ok = True
            cnt = 0
            for key, value, effect in taints:
                taint = {"key": key, "value": value, "effect": effect}
                if effect in ("NoSchedule", "NoExecute"):
                    if not any(toleration_tolerates_taint(t, taint) for t in tolerations):
                        ok = False
                elif effect == "PreferNoSchedule":
                    if not any(toleration_tolerates_taint(t, taint) for t in pref_tols):
                        cnt += 1
            got = cache[taints] = (ok, cnt)
        hard_ok[i], prefer_cnt[i] = got
    return hard_ok, prefer_cnt


def _unschedulable_ok(na: NodeArrays, tolerations: List[dict]) -> np.ndarray:
    """NodeUnschedulable plugin: spec.unschedulable blocked unless the pod tolerates the
    node.kubernetes.io/unschedulable:NoSchedule taint."""
    tolerates = any(toleration_tolerates_taint(t, _UNSCHED_TAINT) for t in tolerations)
    return ~na.unschedulable | tolerates


# ------------------------------------------------------------- terms & counters -------

HOSTNAME = C.LabelHostname


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclass(frozen=True)
class CounterSpec:
    """Count of placed pods matching (namespaces, selector) per domain of topo_key."""

    topo_key: str
    namespaces: frozenset
    selector_canon: str

    def selector(self) -> Optional[dict]:
        return json.loads(self.selector_canon)

    def matches_pod(self, pod: dict) -> bool:
        if namespace_of(pod) not in self.namespaces:
            return False
        return match_label_selector(self.selector(), labels_of(pod))


@dataclass(frozen=True)
class CarrierSpec:
    """A term carried by placed pods: (use, topo, namespaces, selector, weight)."""

    use: str  # 'anti' (required anti-affinity), 'hard' (required affinity), 'pref'
    topo_key: str
    namespaces: frozenset
    selector_canon: str
    weight: float  # signed for 'pref'; 1 for anti/hard

    def matches_pod(self, pod: dict) -> bool:
        if namespace_of(pod) not in self.namespaces:
            return False
        return match_label_selector(json.loads(self.selector_canon), labels_of(pod))


def _affinity_terms(pod: dict):
    """Extract (required_aff, required_anti, preferred[(weight, term)]) raw term dicts."""
    aff = (pod.get("spec") or {}).get("affinity") or {}
    pa = aff.get("podAffinity") or {}
    paa = aff.get("podAntiAffinity") or {}
    req_aff = pa.get("requiredDuringSchedulingIgnoredDuringExecution") or []
    req_anti = paa.get("requiredDuringSchedulingIgnoredDuringExecution") or []
    pref = [(p.get("weight", 0), p.get("podAffinityTerm") or {}) for p in
            pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []]
    pref += [(-p.get("weight", 0), p.get("podAffinityTerm") or {}) for p in
             paa.get("preferredDuringSchedulingIgnoredDuringExecution") or []]
    return req_aff, req_anti, pref


def _term_namespaces(term: dict, pod: dict) -> frozenset:
    ns = term.get("namespaces") or []
    return frozenset(ns) if ns else frozenset([namespace_of(pod)])


def _spread_constraints(pod: dict, when: str) -> List[dict]:
    return [
        c for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or []
        if c.get("whenUnsatisfiable", "DoNotSchedule") == when
    ]


def carried_specs_of_pod(pod: dict) -> List[CarrierSpec]:
    """Carrier terms a pod contributes once placed (interpodaffinity's existing-pod
    directions: RequiredAntiAffinityTerms for Filter; Required/Preferred terms for Score)."""
    req_aff, req_anti, pref = _affinity_terms(pod)
    out = []
    for t in req_anti:
        out.append(CarrierSpec("anti", t.get("topologyKey", ""), _term_namespaces(t, pod),
                               _canon(t.get("labelSelector")), 1.0))
    for t in req_aff:
        out.append(CarrierSpec("hard", t.get("topologyKey", ""), _term_namespaces(t, pod),
                               _canon(t.get("labelSelector")), 1.0))
    for w, t in pref:
        if w:
            out.append(CarrierSpec("pref", t.get("topologyKey", ""), _term_namespaces(t, pod),
                                   _canon(t.get("labelSelector")), float(w)))
    return out


# --------------------------------------------------------------- group encoding -------


def _freeze(o):
    """Recursively hashable form of a JSON-ish object (much faster than json.dumps
    canonicalization on the per-pod hot path)."""
    if isinstance(o, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in o.items()))
    if isinstance(o, (list, tuple)):
        return tuple(_freeze(v) for v in o)
    return o


SIG_MEMO_KEY = "__sig_memo__"  # stamped by workload expansion; popped by the engine

# annotation keys that change Filter/commit behavior (plugins/) — part of the
# signature tuple
_SIG_ANNO_KEYS = (C.AnnoGpuMem, C.AnnoGpuCount, C.AnnoGpuIndex, C.AnnoPodLocalStorage)


def scheduling_signature(pod: dict):
    """Pods with equal signatures are interchangeable to every predicate and score.
    Returns an opaque hashable key.

    The workload memo (replicas of one template share a precomputed
    signature) is the fast path; otherwise the pure-Python computed tuple.
    Group ids are handed out in order of first appearance, so the batch
    tables do not depend on how the signature is hashed.
    """
    memo = pod.get(SIG_MEMO_KEY)
    if memo is not None:
        return memo
    spec = pod.get("spec") or {}
    owner_kinds = sorted({r.get("kind", "") for r in (pod.get("metadata") or {}).get("ownerReferences") or []})
    images = sorted(c.get("image", "") for c in spec.get("containers") or [])
    return (
        namespace_of(pod),
        _freeze(labels_of(pod)),
        _freeze(spec.get("nodeSelector")),
        _freeze(spec.get("affinity")),
        _freeze(spec.get("tolerations")),
        _freeze(spec.get("topologySpreadConstraints")),
        spec.get("nodeName"),
        tuple(sorted(pod_host_ports(pod))),
        tuple(sorted(pod_resource_requests(pod).items())),
        # NonZero scoring depends on the per-container split, not just the sum
        tuple(pod_nonzero_cpu_mem(pod)),
        tuple(owner_kinds),
        tuple(images),
        # extended-resource annotations change Filter/commit behavior (plugins/)
        tuple(annotations_of(pod).get(k) for k in _SIG_ANNO_KEYS),
    )


def strip_daemon_pin(pod: dict) -> Tuple[dict, Optional[str]]:
    """Detect the DaemonSet pin pattern — every required term carries matchFields
    metadata.name In [x] for one node x — and return (pod-sans-pin, node name) or
    (pod, None). The stripped pod keeps its matchExpressions so the group's static
    mask still applies (models/workloads.py set_daemon_pod_node_affinity keeps both)."""
    spec = pod.get("spec") or {}
    required = ((spec.get("affinity") or {}).get("nodeAffinity") or {}).get(
        "requiredDuringSchedulingIgnoredDuringExecution"
    )
    if not required:
        return pod, None
    terms = required.get("nodeSelectorTerms") or []
    target = None
    for t in terms:
        mf = t.get("matchFields") or []
        if len(mf) != 1 or mf[0].get("key") != "metadata.name" or mf[0].get("operator") != "In":
            return pod, None
        vals = mf[0].get("values") or []
        if len(vals) != 1 or (target is not None and vals[0] != target):
            return pod, None
        target = vals[0]
    if target is None:
        return pod, None
    import copy

    stripped = copy.deepcopy(pod)
    sterms = stripped["spec"]["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"]
    keep = []
    for t in sterms:
        t.pop("matchFields", None)
        if t.get("matchExpressions"):
            keep.append(t)
    if keep:
        stripped["spec"]["affinity"]["nodeAffinity"][
            "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"] = keep
    else:
        stripped["spec"]["affinity"]["nodeAffinity"].pop(
            "requiredDuringSchedulingIgnoredDuringExecution")
    return stripped, target


def extract_forced_node(pod: dict, na: NodeArrays) -> Tuple[dict, int]:
    """strip_daemon_pin resolved against the cluster: (pod-sans-pin, node index),
    or (pod, -1) when there is no pin or the target node is unknown."""
    stripped, target = strip_daemon_pin(pod)
    if target is None or target not in na.index:
        return pod, -1
    return stripped, na.index[target]


@dataclass
class GroupInfo:
    template: dict
    # per-pod static vectors
    requests: np.ndarray          # [R]
    nonzero: np.ndarray           # [2]
    ports: List[tuple]
    unknown_resource: bool
    # per-node static vectors
    static_mask: np.ndarray       # [N] bool
    mask_taint: np.ndarray        # [N] bool  (component masks kept for diagnostics)
    mask_unsched: np.ndarray      # [N] bool
    mask_aff: np.ndarray          # [N] bool
    mask_extra: np.ndarray        # [N] bool (out-of-tree plugin filters)
    simon_raw: np.ndarray         # [N] f32 (0..1+ max share)
    nodeaff_raw: np.ndarray       # [N] f32
    taint_raw: np.ndarray         # [N] f32
    avoid_raw: np.ndarray         # [N] f32 (0 or 100)
    image_raw: np.ndarray         # [N] f32 (0..100)
    extra_raw: np.ndarray         # [N] f32: out-of-tree plugin score sum
    # term slots (counter ids + params)
    req_aff: List[int] = field(default_factory=list)
    req_anti: List[int] = field(default_factory=list)
    pref: List[Tuple[int, float]] = field(default_factory=list)          # (counter, signed w)
    spread_dns: List[Tuple[int, float, float]] = field(default_factory=list)  # (counter, maxSkew, self)
    spread_sa: List[Tuple[int, float, float]] = field(default_factory=list)
    ss_counter: int = -1
    ss_skip: bool = False         # pod has explicit topologySpreadConstraints
    aff_self: bool = False        # pod matches all its own required affinity selectors
    dns_elig: Optional[np.ndarray] = None  # [N] bool: nodes counted for min-match domains
    carried: List[CarrierSpec] = field(default_factory=list)
    gpu_mem: float = 0.0          # per-GPU memory request (gpu-share annotations)
    gpu_num: float = 0.0
    gpu_pre_ids: Optional[List[int]] = None  # pre-assigned device ids (gpu-index)
    # open-local volume slots, in processing order (plugins/openlocal.py)
    lvm_sizes: List[float] = field(default_factory=list)
    lvm_vg_ids: List[int] = field(default_factory=list)   # 0 = unnamed (Binpack)
    sdev_sizes: List[float] = field(default_factory=list)
    sdev_media: List[int] = field(default_factory=list)   # 1 hdd / 2 ssd


class Encoder:
    """Builds and caches groups/counters/carriers for one Simulator instance."""

    def __init__(self, na: NodeArrays, axis: ResourceAxis, cluster_model) -> None:
        self.na = na
        self.axis = axis
        self.model = cluster_model  # owns services/rc/rs/sts lists + placed pods
        self.groups: Dict[str, int] = {}
        self.group_list: List[GroupInfo] = []
        self.counters: Dict[CounterSpec, int] = {}
        self.counter_list: List[CounterSpec] = []
        self.carriers: Dict[CarrierSpec, int] = {}
        self.carrier_list: List[CarrierSpec] = []
        self.ports = StringTable()  # (protocol, port) → id; hostIP folded (see kernels)
        self.gpu_host = None  # plugins.gpushare.GpuShareHost, set by the engine
        self.local_host = None  # plugins.openlocal.OpenLocalHost, set by the engine
        # --default-scheduler-config disables for the statically-folded filter
        # plugins (taints/unschedulable/node-affinity); set by the engine
        self.filter_disabled: frozenset = frozenset()
        # out-of-tree plugin objects (see plugins/registry.py), set by the engine
        self.extra_plugins: list = []

    # -- interning ---------------------------------------------------------------

    def counter_id(self, topo_key: str, namespaces: frozenset, selector) -> int:
        spec = CounterSpec(topo_key, namespaces, _canon(selector))
        i = self.counters.get(spec)
        if i is None:
            i = len(self.counter_list)
            self.counters[spec] = i
            self.counter_list.append(spec)
        return i

    def carrier_id(self, spec: CarrierSpec) -> int:
        i = self.carriers.get(spec)
        if i is None:
            i = len(self.carrier_list)
            self.carriers[spec] = i
            self.carrier_list.append(spec)
        return i

    def port_ids(self, ports: Sequence[tuple]) -> List[int]:
        # fold hostIP: 0.0.0.0 conflicts with everything on (proto, port); we intern
        # (proto, port) only — a deliberate simplification (distinct specific hostIPs
        # sharing a port are rare in simulation inputs; documented deviation).
        return [self.ports.intern((p[0], p[2])) for p in ports]

    # -- group construction ------------------------------------------------------

    def group_of(self, pod: dict) -> int:
        sig = scheduling_signature(pod)
        if self.extra_plugins:
            # out-of-tree plugins may read any template content; the built-in
            # signature only covers the fields the built-in plugins read, so
            # widen the group key with the full annotations (the plugin
            # contract: verdicts depend on template content — spec, labels,
            # annotations, namespace — never on pod identity like name/uid)
            sig = (sig, _freeze((pod.get("metadata") or {}).get("annotations")))
        gi = self.groups.get(sig)
        if gi is None:
            gi = len(self.group_list)
            self.groups[sig] = gi
            self.group_list.append(self._build_group(pod))
        return gi

    def rebuild_group_axes(self) -> None:
        """Recompute every interned group's node-axis statics against the
        CURRENT NodeArrays — the second half of a delta node-add
        (NodeArrays.extend): group [N] vectors (masks, raw scores, dns
        eligibility) are re-derived from each group's immutable template.
        Group/counter/carrier IDS are stable: _build_group re-interns the
        same CounterSpec/CarrierSpec keys, which the interners resolve to
        their existing slots, so every previously encoded pod_group array
        and every match_cache entry stays valid."""
        self.group_list = [self._build_group(g.template)
                           for g in self.group_list]

    def _build_group(self, pod: dict) -> GroupInfo:
        na, axis = self.na, self.axis
        spec = pod.get("spec") or {}
        tolerations = spec.get("tolerations") or []
        hard_ok, prefer_cnt = _taint_masks(na, tolerations)
        unsched_ok = _unschedulable_ok(na, tolerations)
        aff_ok = node_affinity_vec(na, spec)
        # scheduler-config filter disables (kernel-evaluated filters are
        # flagged off in kernels.FilterFlags instead); NodeName pinning is a
        # separate plugin and stays on
        if "TaintToleration" in self.filter_disabled:
            hard_ok = np.ones(na.N, bool)
        if "NodeUnschedulable" in self.filter_disabled:
            unsched_ok = np.ones(na.N, bool)
        if "NodeAffinity" in self.filter_disabled:
            aff_ok = np.ones(na.N, bool)
        if spec.get("nodeName"):
            aff_ok = aff_ok & (na.name_ids == na.values.lookup(spec["nodeName"]))
        mask = hard_ok & unsched_ok & aff_ok

        requests = axis.pod_vector(pod).astype(np.float32)
        g = GroupInfo(
            template=pod,
            requests=requests,
            nonzero=pod_nonzero_cpu_mem(pod).astype(np.float32),
            ports=pod_host_ports(pod),
            unknown_resource=pod_has_unknown_resource(pod, axis),
            static_mask=mask,
            mask_taint=hard_ok,
            mask_unsched=unsched_ok,
            mask_aff=aff_ok,
            simon_raw=self._simon_raw(requests),
            nodeaff_raw=self._nodeaff_raw(spec),
            taint_raw=prefer_cnt,
            avoid_raw=self._avoid_raw(pod),
            image_raw=self._image_raw(pod),
            extra_raw=np.zeros(na.N, np.float32),
            mask_extra=np.ones(na.N, bool),
            aff_self=True,
        )
        # out-of-tree plugins (extension point parity: the reference's library
        # API accepts extra framework registries, simulator.go:471-500). Their
        # verdicts depend only on (pod template, node), so they fold into the
        # static tables and cost nothing per scheduling step.
        for pl in self.extra_plugins:
            w = float(getattr(pl, "weight", 1.0))
            flt = getattr(pl, "filter", None)
            score = getattr(pl, "score", None)
            for i, node in enumerate(na.nodes):
                if flt is not None and not flt(pod, node):
                    g.mask_extra[i] = False
                if score is not None:
                    g.extra_raw[i] += w * float(score(pod, node))
        g.static_mask = g.static_mask & g.mask_extra

        from ..plugins.gpushare import gpu_id_str_to_list, pod_gpu_count, pod_gpu_index, pod_gpu_mem

        g.gpu_mem = float(pod_gpu_mem(pod))
        g.gpu_num = float(pod_gpu_count(pod))
        pre = pod_gpu_index(pod)
        if pre:
            try:
                ids = gpu_id_str_to_list(pre)
                g.gpu_pre_ids = ids or None
            except ValueError:
                g.gpu_pre_ids = None  # invalid id falls back to normal allocation

        if self.local_host is not None:
            # Volumes are encoded even when NO node has local storage: the filter
            # then fails everywhere, matching the reference's nil-node-cache
            # Unschedulable (open-local.go:60-70).
            from ..plugins.openlocal import resolve_pod_volumes

            lvm, dev = resolve_pod_volumes(pod, self.model.storage_classes)
            g.lvm_sizes = [float(v.size) for v in lvm]
            g.lvm_vg_ids = [
                self.local_host.vg_name_id(v.vg_name) if v.vg_name else 0 for v in lvm
            ]
            g.sdev_sizes = [float(v.size) for v in dev]
            g.sdev_media = [2 if v.media == "ssd" else 1 for v in dev]
        # inter-pod affinity terms
        req_aff, req_anti, pref = _affinity_terms(pod)
        for t in req_aff:
            nss = _term_namespaces(t, pod)
            g.req_aff.append(self.counter_id(t.get("topologyKey", ""), nss, t.get("labelSelector")))
            if namespace_of(pod) not in nss or not match_label_selector(
                t.get("labelSelector"), labels_of(pod)
            ):
                g.aff_self = False
        for t in req_anti:
            g.req_anti.append(
                self.counter_id(t.get("topologyKey", ""), _term_namespaces(t, pod), t.get("labelSelector"))
            )
        for w, t in pref:
            if w:
                g.pref.append(
                    (self.counter_id(t.get("topologyKey", ""), _term_namespaces(t, pod),
                                     t.get("labelSelector")), float(w))
                )
        # topology spread
        own_ns = frozenset([namespace_of(pod)])
        podlabels = labels_of(pod)
        for c in _spread_constraints(pod, "DoNotSchedule"):
            cid = self.counter_id(c.get("topologyKey", ""), own_ns, c.get("labelSelector"))
            selfm = 1.0 if match_label_selector(c.get("labelSelector"), podlabels) else 0.0
            g.spread_dns.append((cid, float(c.get("maxSkew", 1)), selfm))
        for c in _spread_constraints(pod, "ScheduleAnyway"):
            cid = self.counter_id(c.get("topologyKey", ""), own_ns, c.get("labelSelector"))
            selfm = 1.0 if match_label_selector(c.get("labelSelector"), podlabels) else 0.0
            g.spread_sa.append((cid, float(c.get("maxSkew", 1)), selfm))
        if g.spread_dns or g.spread_sa:
            # eligibility for min-match domains / SA counting: nodes passing the pod's
            # node affinity and carrying every constraint topo key (filtering.go
            # calPreFilterState + nodeLabelsMatchSpreadConstraints)
            elig = node_affinity_vec(na, spec)
            for cid, _, _ in g.spread_dns + g.spread_sa:
                elig &= na.domain_of(self.counter_list[cid].topo_key) >= 0
            g.dns_elig = elig
        # selector spread (only when no explicit constraints, selector_spread.go:49-51)
        g.ss_skip = bool(spec.get("topologySpreadConstraints"))
        if not g.ss_skip:
            sel = self.model.default_spread_selector(pod)
            if sel is not None:
                g.ss_counter = self.counter_id(HOSTNAME, own_ns, sel)
        g.carried = [CarrierSpec(cs.use, cs.topo_key, cs.namespaces, cs.selector_canon, cs.weight)
                     for cs in carried_specs_of_pod(pod)]
        for cs in g.carried:
            self.carrier_id(cs)
        return g

    # -- static score inputs -------------------------------------------------------

    def _simon_raw(self, requests: np.ndarray) -> np.ndarray:
        """Simon bin-packing signal (plugin/simon.go:45-68): max over requested
        resources of req/(alloc-req); Share() semantics at alloc-req == 0. Pods with no
        requests score MaxNodeScore on every node (→ constant → normalizes to 0)."""
        alloc = self.na.alloc  # [N, R]
        req = requests.astype(np.float64).copy()  # simonlint: ignore[dtype-drift] -- host-side Share() math; result narrows to f32 below
        req[PODS_I] = 0.0  # the synthetic pods-slot is not a PodRequestsAndLimits entry
        if not req.any():
            return np.ones(self.na.N, np.float32)
        avail = alloc - req[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            share = np.where(
                avail == 0,
                np.where(req[None, :] > 0, 1.0, 0.0),
                req[None, :] / avail,
            )
        share = np.where(req[None, :] > 0, share, 0.0)  # untouched resources contribute 0
        return np.max(np.where(alloc > 0, share, 0.0), axis=1).astype(np.float32)

    def _nodeaff_raw(self, spec: dict) -> np.ndarray:
        raw = np.zeros(self.na.N, np.float32)
        prefs = ((spec.get("affinity") or {}).get("nodeAffinity") or {}).get(
            "preferredDuringSchedulingIgnoredDuringExecution"
        ) or []
        for p in prefs:
            w = p.get("weight", 0)
            if w:
                raw += w * node_selector_term_vec(self.na, p.get("preference") or {}).astype(np.float32)
        return raw

    def _avoid_raw(self, pod: dict) -> np.ndarray:
        """NodePreferAvoidPods (plugin nodepreferavoidpods): 100 unless the node's
        preferAvoidPods annotation targets the pod's RC/RS controller."""
        raw = np.full(self.na.N, 100.0, np.float32)
        owners = (pod.get("metadata") or {}).get("ownerReferences") or []
        ctrl = next((o for o in owners if o.get("controller") and o.get("kind") in
                     ("ReplicationController", "ReplicaSet")), None)
        if ctrl is None:
            return raw
        from .store import LazyNodeSeq

        if (isinstance(self.na.nodes, LazyNodeSeq)
                and not self.na.nodes.store.any_annotation(
                    "scheduler.alpha.kubernetes.io/preferAvoidPods")
                and not self.na.nodes._extra):
            return raw  # no block carries the annotation: skip the N-scan
        for i, node in enumerate(self.na.nodes):
            anno = annotations_of(node).get("scheduler.alpha.kubernetes.io/preferAvoidPods")
            if not anno:
                continue
            try:
                entries = json.loads(anno).get("preferAvoidPods") or []
            except (ValueError, AttributeError):
                continue
            for e in entries:
                pc = ((e.get("podSignature") or {}).get("podController")) or {}
                if pc.get("kind") == ctrl.get("kind") and pc.get("uid", ctrl.get("uid")) == ctrl.get("uid"):
                    raw[i] = 0.0
        return raw

    def _node_image_sizes(self) -> Tuple[List[Dict[str, float]], bool]:
        """Per-node image-name → size maps, built ONCE per encoder: they are
        group-independent, and rebuilding them per group made ImageLocality
        the dominant encode cost on many-group batches (41 groups × 5k nodes
        of dict parsing ≈ 0.75s on the hard-predicate bench)."""
        cached = getattr(self, "_image_sizes_cache", None)
        if cached is not None:
            return cached
        from .store import LazyNodeSeq

        if (isinstance(self.na.nodes, LazyNodeSeq)
                and not self.na.nodes.store.has_images
                and not self.na.nodes._extra):
            # columnar fast path: the store knows no block advertises images,
            # so don't materialize N dicts to learn the same thing
            self._image_sizes_cache = ([], False)
            return self._image_sizes_cache
        sizes: List[Dict[str, float]] = []
        have_any = False
        for node in self.na.nodes:
            m: Dict[str, float] = {}
            for img in (node.get("status") or {}).get("images") or []:
                for nm in img.get("names") or []:
                    m[nm] = float(img.get("sizeBytes", 0))
            if m:
                have_any = True
            sizes.append(m)
        self._image_sizes_cache = (sizes, have_any)
        return sizes, have_any

    def _image_raw(self, pod: dict) -> np.ndarray:
        """ImageLocality (imagelocality plugin): scaled sum of present image sizes,
        normalized over [23MB, 1000MB x numContainers] (calculatePriority scales
        the max threshold per container, image_locality.go:82-91). Zero when
        nodes advertise no images."""
        mb = 1024 * 1024
        n_containers = max(1, len((pod.get("spec") or {}).get("containers") or []))
        min_t, max_t = 23 * mb, 1000 * mb * n_containers
        sizes, have_any = self._node_image_sizes()
        raw = np.zeros(self.na.N, np.float32)
        if not have_any:
            return raw
        images = [c.get("image", "") for c in (pod.get("spec") or {}).get("containers") or []]
        total_nodes = max(1, self.na.N)
        num_nodes = {img: sum(1 for m in sizes if img in m) for img in images}
        for i, m in enumerate(sizes):
            s = 0.0
            for img in images:
                if img in m:
                    s += m[img] * (num_nodes[img] / total_nodes)
            if s < min_t:
                raw[i] = 0.0
            else:
                raw[i] = np.float32(int(100 * (min(s, max_t) - min_t) / (max_t - min_t)))
        return raw


# ------------------------------------------------------------- placed records ---------


@dataclass
class PlacedGroup:
    """Host-side memo of every bound pod sharing one scheduling signature:
    everything the batch-table seeds need, aggregated as per-node counts so
    committing a pod is a dict increment instead of an object allocation
    (the engine's commit loop runs once per pod — 100k allocations were a
    measurable slice of the headline bench)."""

    pod: dict    # representative pod (selector matching reads template fields only)
    sig: object  # opaque hashable scheduling_signature key
    req_vec: np.ndarray      # [R] f32
    nonzero: np.ndarray      # [2] f32
    port_ids: List[int]
    carrier_ids: List[int]
    node_counts: Dict[int, int] = field(default_factory=dict)  # node_i → pods placed


# ---------------------------------------------------------------- batch tables --------


@dataclass
class BatchTables:
    """Everything the device kernels need for one schedulePods batch (all numpy; the
    engine moves them to torch tensors). Dimension names: N nodes, R resources, G groups, T
    counter rows, Tc carrier rows, D domains (+1 sentinel col), PORT port ids (+1
    sentinel 0), P pods."""

    # node-side
    alloc: np.ndarray            # [N, R] f32
    node_zone: np.ndarray        # [N] i32, 0 = no zone
    n_zones: int
    # group-side statics
    static_mask: np.ndarray      # [G, N] bool
    mask_taint: np.ndarray       # [G, N] bool
    mask_unsched: np.ndarray     # [G, N] bool
    mask_aff: np.ndarray         # [G, N] bool
    mask_extra: np.ndarray       # [G, N] bool
    simon_raw: np.ndarray        # [G, N] f32
    nodeaff_raw: np.ndarray      # [G, N] f32
    taint_raw: np.ndarray        # [G, N] f32
    avoid_raw: np.ndarray        # [G, N] f32
    image_raw: np.ndarray        # [G, N] f32
    extra_raw: np.ndarray        # [G, N] f32: out-of-tree plugin scores
    grp_requests: np.ndarray     # [G, R] f32
    grp_nonzero: np.ndarray      # [G, 2] f32
    grp_unknown: np.ndarray      # [G] bool
    grp_ports: np.ndarray        # [G, PP] i32 (0 = pad)
    # counters
    counter_dom: np.ndarray      # [T, N] i32 (domain id; D = key-absent sentinel)
    counter_topo: np.ndarray     # [T] i32: unique-topology row per counter
    topo_dom: np.ndarray         # [U, N] i32: node→domain per unique topo key
    counter_sel_match_g: np.ndarray  # [T, G] bool: does a group pod match counter t
    req_aff_t: np.ndarray        # [G, A] i32 (-1 pad)
    grp_aff_self: np.ndarray     # [G] bool
    req_anti_t: np.ndarray       # [G, B] i32
    pref_t: np.ndarray           # [G, Cp] i32
    pref_w: np.ndarray           # [G, Cp] f32
    dns_t: np.ndarray            # [G, Sd] i32
    dns_maxskew: np.ndarray      # [G, Sd] f32
    dns_self: np.ndarray         # [G, Sd] f32
    dns_edom: np.ndarray         # [G, Sd, D+1] bool
    sa_t: np.ndarray             # [G, Ss] i32
    sa_maxskew: np.ndarray       # [G, Ss] f32
    sa_self: np.ndarray          # [G, Ss] f32
    ss_t: np.ndarray             # [G] i32 (-1 = no selector-spread counter)
    ss_skip: np.ndarray          # [G] bool (explicit constraints → plugin skipped)
    # carriers
    carr_dom: np.ndarray         # [Tc, N] i32
    carr_topo: np.ndarray        # [Tc] i32: unique-topology row per carrier
    carr_anti_t: np.ndarray      # [G, Ca] i32: anti carrier ids matching g (-1 pad)
    carr_w_t: np.ndarray         # [G, Cw] i32: weighted carrier ids for g (-1 pad)
    carr_w_w: np.ndarray         # [G, Cw] f32: those weights
    carr_sel_match_g: np.ndarray  # [Tc, G] bool
    grp_carries: np.ndarray      # [G, Tc] f32
    # gpu-share
    grp_gpu_mem: np.ndarray      # [G] f32
    grp_gpu_num: np.ndarray      # [G] f32
    grp_gpu_pre: np.ndarray      # [G] bool: pod carries a valid pre-assigned gpu-index
    grp_gpu_take: np.ndarray     # [G, MAXDEV] f32: unit counts per device when pre-assigned
    dev_total: np.ndarray        # [N, MAXDEV] f32
    # open-local
    grp_lvm_size: np.ndarray     # [G, SL] f32
    grp_lvm_vg: np.ndarray       # [G, SL] i32 (0 = unnamed)
    grp_sdev_size: np.ndarray    # [G, SD] f32
    grp_sdev_media: np.ndarray   # [G, SD] i32 (1 hdd / 2 ssd; 0 unused)
    vg_cap: np.ndarray           # [N, MAXVG] f32
    vg_nameid: np.ndarray        # [N, MAXVG] i32
    sdev_cap: np.ndarray         # [N, MAXSD] f32
    sdev_media: np.ndarray       # [N, MAXSD] i32
    # initial carry
    seed_requested: np.ndarray   # [N, R] f32
    seed_nonzero: np.ndarray     # [N, 2] f32
    seed_port_used: np.ndarray   # [N, PORT+1] bool
    seed_counter: np.ndarray     # [T, D+1] f32
    seed_carrier: np.ndarray     # [Tc, D+1] f32
    seed_dev_used: np.ndarray    # [N, MAXDEV] f32
    seed_vg_req: np.ndarray      # [N, MAXVG] f32
    seed_sdev_alloc: np.ndarray  # [N, MAXSD] f32
    # batch pods
    pod_group: np.ndarray        # [P] i32
    forced_node: np.ndarray      # [P] i32 (-1 = free)
    valid: np.ndarray            # [P] bool

    @property
    def dims(self) -> tuple:
        return (
            self.alloc.shape[0], self.alloc.shape[1], self.static_mask.shape[0],
            self.counter_dom.shape[0], self.carr_dom.shape[0],
            self.seed_counter.shape[1] - 1, self.seed_port_used.shape[1] - 1,
            self.pod_group.shape[0],
        )


def plugin_flags(bt: "BatchTables") -> Tuple[bool, bool]:
    """(enable_gpu, enable_storage): static kernel flags — True when the batch has
    any gpu / local-storage demand, so inert plugin subgraphs compile away."""
    return (
        bool(bt.grp_gpu_mem.any()),
        bool(bt.grp_lvm_size.any() or bt.grp_sdev_size.any()),
    )


def _bucket(n: int) -> int:
    """Next power of two (≥1) — the padding granularity for encoder-derived axes."""
    return 1 << max(0, (n - 1)).bit_length() if n > 1 else 1


def bucket_capped(n: int, cap: int, floor: int = 8) -> int:
    """Padding target for the pod/node axes: powers of two up to `cap`, then
    multiples of `cap` (bounds compile-cache churn at both small and large sizes)."""
    if n <= 0:
        return floor
    if n <= cap:
        return max(floor, _bucket(n))
    return ((n + cap - 1) // cap) * cap


def _pad_axis(a: np.ndarray, axis: int, target: int, fill) -> np.ndarray:
    cur = a.shape[axis]
    if cur >= target:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, target - cur)
    return np.pad(a, widths, constant_values=fill)


def pad_batch_tables(bt: "BatchTables", multiple: int) -> "BatchTables":
    """Pad the node axis of every table/seed to a multiple of `multiple` with
    phantom nodes that no pod can be placed on (static_mask False everywhere; the
    key-absent sentinel domain, so counters never move)."""
    import dataclasses

    N = bt.alloc.shape[0]
    target = N + ((-N) % multiple)
    if target == N:
        return bt
    D = bt.seed_counter.shape[1] - 1
    return dataclasses.replace(
        bt,
        alloc=_pad_axis(bt.alloc, 0, target, 0.0),
        node_zone=_pad_axis(bt.node_zone, 0, target, 0),
        static_mask=_pad_axis(bt.static_mask, 1, target, False),
        mask_taint=_pad_axis(bt.mask_taint, 1, target, False),
        mask_unsched=_pad_axis(bt.mask_unsched, 1, target, False),
        mask_aff=_pad_axis(bt.mask_aff, 1, target, False),
        mask_extra=_pad_axis(bt.mask_extra, 1, target, False),
        simon_raw=_pad_axis(bt.simon_raw, 1, target, 0.0),
        nodeaff_raw=_pad_axis(bt.nodeaff_raw, 1, target, 0.0),
        taint_raw=_pad_axis(bt.taint_raw, 1, target, 0.0),
        avoid_raw=_pad_axis(bt.avoid_raw, 1, target, 0.0),
        image_raw=_pad_axis(bt.image_raw, 1, target, 0.0),
        extra_raw=_pad_axis(bt.extra_raw, 1, target, 0.0),
        counter_dom=_pad_axis(bt.counter_dom, 1, target, D),
        topo_dom=_pad_axis(bt.topo_dom, 1, target, D),
        carr_dom=_pad_axis(bt.carr_dom, 1, target, D),
        dev_total=_pad_axis(bt.dev_total, 0, target, 0.0),
        vg_cap=_pad_axis(bt.vg_cap, 0, target, 0.0),
        vg_nameid=_pad_axis(bt.vg_nameid, 0, target, 0),
        sdev_cap=_pad_axis(bt.sdev_cap, 0, target, 0.0),
        sdev_media=_pad_axis(bt.sdev_media, 0, target, 0),
        seed_requested=_pad_axis(bt.seed_requested, 0, target, 0.0),
        seed_nonzero=_pad_axis(bt.seed_nonzero, 0, target, 0.0),
        seed_port_used=_pad_axis(bt.seed_port_used, 0, target, False),
        seed_dev_used=_pad_axis(bt.seed_dev_used, 0, target, 0.0),
        seed_vg_req=_pad_axis(bt.seed_vg_req, 0, target, 0.0),
        seed_sdev_alloc=_pad_axis(bt.seed_sdev_alloc, 0, target, 0.0),
    )


def pad_encoder_axes(bt: "BatchTables") -> "BatchTables":
    """Pad every encoder-derived axis (groups G, counters T, carriers Tc, port ids
    PORT, domains D, and the per-group term-slot axes) to power-of-two buckets with
    inert rows/columns.

    Why: the encoder interns groups/counters/domains cumulatively across apps, so
    every ScheduleApp batch otherwise gets brand-new table shapes and a fresh XLA
    compile (~20-40s on TPU). Bucketing bounds the number of distinct compiled
    shapes to a few per decade of growth. Inertness invariants:
    - pad G rows are never indexed (pod_group only holds real ids);
    - pad T/Tc rows carry the key-absent sentinel domain and match no group, so
      they never accumulate or block;
    - pad D columns sit between the real domains and the sentinel column, which
      moves from index D to index D_pad (ids in *_dom are remapped);
    - pad term slots use the same -1/0 fills as ordinary short rows.
    """
    import dataclasses

    G, N = bt.static_mask.shape
    T = bt.counter_dom.shape[0]
    Tc = bt.carr_dom.shape[0]
    D = bt.seed_counter.shape[1] - 1
    PORT = bt.seed_port_used.shape[1] - 1
    Gp, Tp, Tcp, Dp = _bucket(G), _bucket(T), _bucket(Tc), _bucket(D)
    PORTp = _bucket(PORT)
    pad_axis = _pad_axis

    def pad_dom(dom: np.ndarray) -> np.ndarray:
        # remap sentinel D -> Dp, then pad new rows entirely with the sentinel
        return np.where(dom == D, Dp, dom)

    def pad_counter_width(a: np.ndarray) -> np.ndarray:
        # [*, D+1] -> [*, Dp+1]: real cols 0..D-1 keep, sentinel col moves to Dp
        out = np.zeros(a.shape[:-1] + (Dp + 1,), a.dtype)
        out[..., :D] = a[..., :D]
        out[..., Dp] = a[..., D]
        return out

    r = dataclasses.replace(
        bt,
        # G axis
        static_mask=pad_axis(bt.static_mask, 0, Gp, False),
        mask_taint=pad_axis(bt.mask_taint, 0, Gp, False),
        mask_unsched=pad_axis(bt.mask_unsched, 0, Gp, False),
        mask_aff=pad_axis(bt.mask_aff, 0, Gp, False),
        mask_extra=pad_axis(bt.mask_extra, 0, Gp, False),
        simon_raw=pad_axis(bt.simon_raw, 0, Gp, 0.0),
        nodeaff_raw=pad_axis(bt.nodeaff_raw, 0, Gp, 0.0),
        taint_raw=pad_axis(bt.taint_raw, 0, Gp, 0.0),
        avoid_raw=pad_axis(bt.avoid_raw, 0, Gp, 0.0),
        image_raw=pad_axis(bt.image_raw, 0, Gp, 0.0),
        extra_raw=pad_axis(bt.extra_raw, 0, Gp, 0.0),
        grp_requests=pad_axis(bt.grp_requests, 0, Gp, 0.0),
        grp_nonzero=pad_axis(bt.grp_nonzero, 0, Gp, 0.0),
        grp_unknown=pad_axis(bt.grp_unknown, 0, Gp, False),
        grp_ports=pad_axis(pad_axis(bt.grp_ports, 0, Gp, 0), 1, _bucket(bt.grp_ports.shape[1]), 0),
        grp_aff_self=pad_axis(bt.grp_aff_self, 0, Gp, False),
        grp_gpu_mem=pad_axis(bt.grp_gpu_mem, 0, Gp, 0.0),
        grp_gpu_num=pad_axis(bt.grp_gpu_num, 0, Gp, 0.0),
        grp_gpu_pre=pad_axis(bt.grp_gpu_pre, 0, Gp, False),
        grp_gpu_take=pad_axis(bt.grp_gpu_take, 0, Gp, 0.0),
        grp_lvm_size=pad_axis(pad_axis(bt.grp_lvm_size, 0, Gp, 0.0), 1, _bucket(bt.grp_lvm_size.shape[1]), 0.0),
        grp_lvm_vg=pad_axis(pad_axis(bt.grp_lvm_vg, 0, Gp, 0), 1, _bucket(bt.grp_lvm_vg.shape[1]), 0),
        grp_sdev_size=pad_axis(pad_axis(bt.grp_sdev_size, 0, Gp, 0.0), 1, _bucket(bt.grp_sdev_size.shape[1]), 0.0),
        grp_sdev_media=pad_axis(pad_axis(bt.grp_sdev_media, 0, Gp, 0), 1, _bucket(bt.grp_sdev_media.shape[1]), 0),
        ss_t=pad_axis(bt.ss_t, 0, Gp, -1),
        ss_skip=pad_axis(bt.ss_skip, 0, Gp, False),
        grp_carries=pad_axis(pad_axis(bt.grp_carries, 0, Gp, 0.0), 1, Tcp, 0.0),
        # per-group term slots (pad G rows AND slot width)
        req_aff_t=pad_axis(pad_axis(bt.req_aff_t, 0, Gp, -1), 1, _bucket(bt.req_aff_t.shape[1]), -1),
        req_anti_t=pad_axis(pad_axis(bt.req_anti_t, 0, Gp, -1), 1, _bucket(bt.req_anti_t.shape[1]), -1),
        pref_t=pad_axis(pad_axis(bt.pref_t, 0, Gp, -1), 1, _bucket(bt.pref_t.shape[1]), -1),
        pref_w=pad_axis(pad_axis(bt.pref_w, 0, Gp, 0.0), 1, _bucket(bt.pref_w.shape[1]), 0.0),
        dns_t=pad_axis(pad_axis(bt.dns_t, 0, Gp, -1), 1, _bucket(bt.dns_t.shape[1]), -1),
        dns_maxskew=pad_axis(pad_axis(bt.dns_maxskew, 0, Gp, 1.0), 1, _bucket(bt.dns_maxskew.shape[1]), 1.0),
        dns_self=pad_axis(pad_axis(bt.dns_self, 0, Gp, 0.0), 1, _bucket(bt.dns_self.shape[1]), 0.0),
        dns_edom=pad_counter_width(
            pad_axis(pad_axis(bt.dns_edom, 0, Gp, False), 1, _bucket(bt.dns_edom.shape[1]), False)
        ),
        carr_anti_t=pad_axis(pad_axis(bt.carr_anti_t, 0, Gp, -1), 1, _bucket(max(1, bt.carr_anti_t.shape[1])), -1),
        carr_w_t=pad_axis(pad_axis(bt.carr_w_t, 0, Gp, -1), 1, _bucket(max(1, bt.carr_w_t.shape[1])), -1),
        carr_w_w=pad_axis(pad_axis(bt.carr_w_w, 0, Gp, 0.0), 1, _bucket(max(1, bt.carr_w_w.shape[1])), 0.0),
        sa_t=pad_axis(pad_axis(bt.sa_t, 0, Gp, -1), 1, _bucket(bt.sa_t.shape[1]), -1),
        sa_maxskew=pad_axis(pad_axis(bt.sa_maxskew, 0, Gp, 1.0), 1, _bucket(bt.sa_maxskew.shape[1]), 1.0),
        sa_self=pad_axis(pad_axis(bt.sa_self, 0, Gp, 0.0), 1, _bucket(bt.sa_self.shape[1]), 0.0),
        # T axis
        counter_dom=pad_axis(pad_dom(bt.counter_dom), 0, Tp, Dp),
        # pad counter/carrier rows point at the all-sentinel topology row
        # (the last real row by construction), pad topology rows are all-
        # sentinel themselves — neither can ever accumulate
        counter_topo=pad_axis(bt.counter_topo, 0, Tp,
                              bt.topo_dom.shape[0] - 1),
        topo_dom=pad_axis(pad_dom(bt.topo_dom), 0,
                          _bucket(bt.topo_dom.shape[0]), Dp),
        counter_sel_match_g=pad_axis(pad_axis(bt.counter_sel_match_g, 0, Tp, False), 1, Gp, False),
        seed_counter=pad_axis(pad_counter_width(bt.seed_counter), 0, Tp, 0.0),
        # Tc axis
        carr_dom=pad_axis(pad_dom(bt.carr_dom), 0, Tcp, Dp),
        carr_topo=pad_axis(bt.carr_topo, 0, Tcp, bt.topo_dom.shape[0] - 1),
        carr_sel_match_g=pad_axis(pad_axis(bt.carr_sel_match_g, 0, Tcp, False), 1, Gp, False),
        seed_carrier=pad_axis(pad_counter_width(bt.seed_carrier), 0, Tcp, 0.0),
        # PORT axis
        seed_port_used=pad_axis(bt.seed_port_used, 1, PORTp + 1, False),
    )
    return r


def _pad_slots(rows: List[List], width: int, fill, dtype) -> np.ndarray:
    out = np.full((len(rows), max(1, width)), fill, dtype)
    for i, r in enumerate(rows):
        for j, v in enumerate(r):
            out[i, j] = v
    return out


def build_pod_axis_tables(
    enc: Encoder,
    batch: List[Tuple[int, int]],          # (group_id, forced_node) per pod, in order
    pad_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """The node-axis-INDEPENDENT half of BatchTables: per-group statics
    (requests, term slots, selector-match matrices, gpu/storage group rows)
    and the batch pod arrays. Everything here is a function of the encoder's
    interned groups/counters/carriers and the pod order alone — the
    incremental capacity prober computes it exactly once per search and keeps
    it fixed across every candidate node count.

    Side effect: interns every group's host ports, which SIZES the port axis.
    Must therefore run before build_node_axis_tables (the seed port table
    reads len(enc.ports))."""
    G = max(1, len(enc.group_list))
    T = max(1, len(enc.counter_list))
    Tc = max(1, len(enc.carrier_list))
    R = enc.axis.R
    groups = enc.group_list or []
    # Intern every group's host ports BEFORE sizing the port axis, or new ports in this
    # batch would land out of range and clamp onto other pods' columns.
    grp_port_ids = [enc.port_ids(g.ports) for g in groups] or [[]]

    A = max((len(g.req_aff) for g in groups), default=0)
    B = max((len(g.req_anti) for g in groups), default=0)
    Cp = max((len(g.pref) for g in groups), default=0)
    Sd = max((len(g.spread_dns) for g in groups), default=0)
    Ss = max((len(g.spread_sa) for g in groups), default=0)
    PP = max((len(g.ports) for g in groups), default=0)

    carr_sel_match_g = np.zeros((Tc, G), bool)
    for t, cs in enumerate(enc.carrier_list):
        for gi, g in enumerate(groups):
            carr_sel_match_g[t, gi] = cs.matches_pod(g.template)
    # per-group carrier SLOTS: the kernels gather only these rows instead of
    # the full [Tc, N] table (Tc grows with every affinity-carrying pod)
    carr_anti_lists: List[List[int]] = []
    carr_w_lists: List[List[int]] = []
    carr_w_vals: List[List[float]] = []
    for gi in range(len(groups)):
        al: List[int] = []
        wl: List[int] = []
        wv: List[float] = []
        for t, cs in enumerate(enc.carrier_list):
            if not carr_sel_match_g[t, gi]:
                continue
            if cs.use == "anti":
                al.append(t)
            wgt = 1.0 if cs.use == "hard" else (cs.weight if cs.use == "pref" else 0.0)
            if wgt != 0.0:
                wl.append(t)
                wv.append(wgt)
        carr_anti_lists.append(al)
        carr_w_lists.append(wl)
        carr_w_vals.append(wv)
    Ca = max((len(a) for a in carr_anti_lists), default=0)
    Cw = max((len(a) for a in carr_w_lists), default=0)
    counter_sel_match_g = np.zeros((T, G), bool)
    for t, cs in enumerate(enc.counter_list):
        for gi, g in enumerate(groups):
            counter_sel_match_g[t, gi] = cs.matches_pod(g.template)
    grp_carries = np.zeros((G, Tc), np.float32)
    for gi, g in enumerate(groups):
        for cs in g.carried:
            grp_carries[gi, enc.carriers[cs]] = 1.0

    SL = max((len(g.lvm_sizes) for g in groups), default=0)
    SD = max((len(g.sdev_sizes) for g in groups), default=0)

    # ---- batch pod arrays -------------------------------------------------------
    P = len(batch)
    P_pad = max(pad_to or P, P, 1)
    pod_group = np.zeros(P_pad, np.int32)
    forced_node = np.full(P_pad, -1, np.int32)
    valid = np.zeros(P_pad, bool)
    from .store import EncodedRows

    if isinstance(batch, EncodedRows):
        # columnar fast path (simulator/store.py): the store's encode is
        # already two arrays — three vectorized copies, no per-pod loop
        pod_group[:P] = batch.pod_group
        forced_node[:P] = batch.forced_node
        valid[:P] = True
    else:
        for i, (gi, fn) in enumerate(batch):  # simonlint: ignore[per-pod-host-loop] -- legacy list-of-tuples form; EncodedRows takes the vectorized branch
            pod_group[i] = gi
            forced_node[i] = fn
            valid[i] = True

    return dict(
        grp_requests=(
            np.stack([g.requests for g in groups]) if groups else np.zeros((G, R), np.float32)
        ),
        grp_nonzero=(
            np.stack([g.nonzero for g in groups]) if groups else np.zeros((G, 2), np.float32)
        ),
        grp_unknown=np.array([g.unknown_resource for g in groups] or [False], bool),
        grp_ports=_pad_slots(grp_port_ids, PP, 0, np.int32),
        counter_sel_match_g=counter_sel_match_g,
        req_aff_t=_pad_slots([g.req_aff for g in groups] or [[]], A, -1, np.int32),
        grp_aff_self=np.array([g.aff_self for g in groups] or [False], bool),
        req_anti_t=_pad_slots([g.req_anti for g in groups] or [[]], B, -1, np.int32),
        pref_t=_pad_slots([[c for c, _ in g.pref] for g in groups] or [[]], Cp, -1, np.int32),
        pref_w=_pad_slots([[w for _, w in g.pref] for g in groups] or [[]], Cp, 0.0, np.float32),
        dns_t=_pad_slots([[c for c, _, _ in g.spread_dns] for g in groups] or [[]], Sd, -1, np.int32),
        dns_maxskew=_pad_slots([[m for _, m, _ in g.spread_dns] for g in groups] or [[]], Sd, 1.0, np.float32),
        dns_self=_pad_slots([[s for _, _, s in g.spread_dns] for g in groups] or [[]], Sd, 0.0, np.float32),
        sa_t=_pad_slots([[c for c, _, _ in g.spread_sa] for g in groups] or [[]], Ss, -1, np.int32),
        sa_maxskew=_pad_slots([[m for _, m, _ in g.spread_sa] for g in groups] or [[]], Ss, 1.0, np.float32),
        sa_self=_pad_slots([[s for _, _, s in g.spread_sa] for g in groups] or [[]], Ss, 0.0, np.float32),
        ss_t=np.array([g.ss_counter for g in groups] or [-1], np.int32),
        ss_skip=np.array([g.ss_skip for g in groups] or [False], bool),
        carr_sel_match_g=carr_sel_match_g,
        carr_anti_t=_pad_slots(carr_anti_lists or [[]], Ca, -1, np.int32),
        carr_w_t=_pad_slots(carr_w_lists or [[]], Cw, -1, np.int32),
        carr_w_w=_pad_slots(carr_w_vals or [[]], Cw, 0.0, np.float32),
        grp_carries=grp_carries,
        grp_gpu_mem=np.array([g.gpu_mem for g in groups] or [0.0], np.float32),
        grp_gpu_num=np.array([g.gpu_num for g in groups] or [0.0], np.float32),
        grp_lvm_size=_pad_slots([g.lvm_sizes for g in groups] or [[]], SL, 0.0, np.float32),
        grp_lvm_vg=_pad_slots([g.lvm_vg_ids for g in groups] or [[]], SL, 0, np.int32),
        grp_sdev_size=_pad_slots([g.sdev_sizes for g in groups] or [[]], SD, 0.0, np.float32),
        grp_sdev_media=_pad_slots([g.sdev_media for g in groups] or [[]], SD, 0, np.int32),
        pod_group=pod_group,
        forced_node=forced_node,
        valid=valid,
    )


def build_node_axis_tables(
    enc: Encoder,
    placed: Dict[object, PlacedGroup],
    match_cache: Dict[Tuple[int, str], bool],
) -> Dict[str, np.ndarray]:
    """The node-axis half of BatchTables: every [*, N] mask/raw/domain table,
    the per-node plugin matrices, and the carry seeds aggregated from
    `placed`. Reads len(enc.ports), so build_pod_axis_tables must have interned
    the batch's host ports first."""
    na = enc.na
    N, R = na.N, enc.axis.R
    G = max(1, len(enc.group_list))
    T = max(1, len(enc.counter_list))
    Tc = max(1, len(enc.carrier_list))
    groups = enc.group_list or []
    PORT = max(1, len(enc.ports))

    def stack(attr):
        if not groups:
            return np.zeros((G, N), np.float32)
        return np.stack([getattr(g, attr).astype(np.float32) for g in groups])

    static_mask = (
        np.stack([g.static_mask for g in groups]) if groups else np.zeros((G, N), bool)
    )
    # Intern every topology domain FIRST — D (and the sentinel index) depend on it.
    counter_dom_raw = [na.domain_of(cs.topo_key) for cs in enc.counter_list]
    carr_dom_raw = [na.domain_of(cs.topo_key) for cs in enc.carrier_list]
    D = max(1, na.D)  # StringTable length includes the reserved 0 slot; ids are < D

    counter_dom = np.full((T, N), D, np.int32)
    for t, dom in enumerate(counter_dom_raw):
        counter_dom[t] = np.where(dom >= 0, dom, D)
    carr_dom = np.full((Tc, N), D, np.int32)
    for t, dom in enumerate(carr_dom_raw):
        carr_dom[t] = np.where(dom >= 0, dom, D)

    # Topology group-id tensors: counters/carriers sharing a topology key
    # share their entire domain row, so the wave kernels segment-reduce
    # per-node counts once per UNIQUE topology ([U, N]) and broadcast to the
    # [T]/[Tc] rows — _aggregate_commit's per-row T×N scatter was the
    # dominant per-segment fixed cost at 5k nodes. Row U-1 is always the
    # all-sentinel topology, which pad rows and empty tables point at.
    topo_ids: Dict[str, int] = {}
    topo_rows: List[np.ndarray] = []

    def topo_of(key: str, dom_row: np.ndarray) -> int:
        got = topo_ids.get(key)
        if got is None:
            got = topo_ids[key] = len(topo_rows)
            topo_rows.append(np.where(dom_row >= 0, dom_row, D).astype(np.int32))
        return got

    counter_topo = np.zeros(T, np.int32)
    for t, cs in enumerate(enc.counter_list):
        counter_topo[t] = topo_of(cs.topo_key, counter_dom_raw[t])
    carr_topo = np.zeros(Tc, np.int32)
    for t, cs in enumerate(enc.carrier_list):
        carr_topo[t] = topo_of(cs.topo_key, carr_dom_raw[t])
    sentinel_row = len(topo_rows)
    topo_rows.append(np.full(N, D, np.int32))
    if not enc.counter_list:
        counter_topo[:] = sentinel_row
    if not enc.carrier_list:
        carr_topo[:] = sentinel_row
    topo_dom = np.stack(topo_rows)

    Sd = max((len(g.spread_dns) for g in groups), default=0)
    dns_edom = np.zeros((G, max(1, Sd), D + 1), bool)
    for gi, g in enumerate(groups):
        for si, (cid, _, _) in enumerate(g.spread_dns):
            dom = na.domain_of(enc.counter_list[cid].topo_key)
            elig = g.dns_elig if g.dns_elig is not None else np.ones(N, bool)
            dns_edom[gi, si, dom[elig & (dom >= 0)]] = True

    # ---- seeds from placed pods -----------------------------------------------
    # The resource/nonzero sums vectorize across ALL placed groups in two
    # np.add.at passes: bound pods carry per-pod signatures (spec.nodeName
    # joins the signature), so `placed` scales with the bound-pod count and
    # a per-group fancy-index add was the dominant encode cost at 10k+ nodes
    # (~9us x 5000 groups per rebuild — the serving image's churn-refresh
    # p99 spike). Entry order is placed-iteration order, and np.add.at
    # applies repeated-index adds in order of appearance, so the f32
    # accumulation sequence per node is bit-identical to the per-group loop
    # it replaces; count-scaled vectors match the wave kernel's aggregate
    # commit math.
    seed_requested = np.zeros((N, R), np.float32)
    seed_nonzero = np.zeros((N, 2), np.float32)
    seed_port_used = np.zeros((N, PORT + 1), bool)
    seed_counter = np.zeros((T, D + 1), np.float32)
    seed_carrier = np.zeros((Tc, D + 1), np.float32)
    if placed:
        g_idx: List[int] = []
        n_idx: List[int] = []
        c_val: List[float] = []
        for gi, pg in enumerate(placed.values()):
            for ni, c in pg.node_counts.items():
                g_idx.append(gi)
                n_idx.append(ni)
                c_val.append(c)
        if n_idx:
            groups_seq = list(placed.values())
            req_all = np.stack([pg.req_vec for pg in groups_seq])
            nz_all = np.stack([pg.nonzero for pg in groups_seq])
            gi_a = np.asarray(g_idx, np.int64)  # simonlint: ignore[dtype-drift] -- host-side fancy index, never shipped to device
            ni_a = np.asarray(n_idx, np.int64)  # simonlint: ignore[dtype-drift] -- host-side fancy index, never shipped to device
            c_a = np.asarray(c_val, np.float32)[:, None]
            np.add.at(seed_requested, ni_a, req_all[gi_a] * c_a)
            np.add.at(seed_nonzero, ni_a, nz_all[gi_a] * c_a)
    for pg in placed.values():
        if not (pg.port_ids or pg.carrier_ids or enc.counter_list):
            continue
        nis = np.fromiter(pg.node_counts.keys(), np.int64, len(pg.node_counts))  # simonlint: ignore[dtype-drift] -- host-side fancy index, never shipped to device
        cnts = np.fromiter(pg.node_counts.values(), np.float32, len(pg.node_counts))
        for pid in pg.port_ids:
            if pid <= PORT:
                seed_port_used[nis, pid] = True
        for t, cs in enumerate(enc.counter_list):
            key = (t, pg.sig)
            m = match_cache.get(key)
            if m is None:
                m = match_cache[key] = cs.matches_pod(pg.pod)
            if m:
                d = counter_dom[t, nis]
                ok = d < D
                np.add.at(seed_counter[t], d[ok], cnts[ok])
        for cid in pg.carrier_ids:
            d = carr_dom[cid, nis]
            ok = d < D
            np.add.at(seed_carrier[cid], d[ok], cnts[ok])

    # ---- gpu-share tables -------------------------------------------------------
    gpu_host = enc.gpu_host
    if gpu_host is not None and gpu_host.enabled:
        maxdev = _bucket(gpu_host.max_devs)
        dev_total = gpu_host.dev_total_matrix(maxdev)
        seed_dev_used = gpu_host.dev_used_matrix(maxdev)
    else:
        maxdev = 1
        dev_total = np.zeros((N, 1), np.float32)
        seed_dev_used = np.zeros((N, 1), np.float32)
    grp_gpu_pre = np.zeros(G, bool)
    grp_gpu_take = np.zeros((G, maxdev), np.float32)
    for gi, g in enumerate(groups):
        if g.gpu_pre_ids:
            grp_gpu_pre[gi] = True
            for d in g.gpu_pre_ids:
                if 0 <= d < maxdev:  # out-of-range ids are skipped (reference warns)
                    grp_gpu_take[gi, d] += 1.0

    # ---- open-local tables ------------------------------------------------------
    local_host = enc.local_host
    if local_host is not None and local_host.enabled:
        maxvg = _bucket(max(local_host.max_vgs, 1))
        maxsd = _bucket(max(local_host.max_devs, 1))
        vg_cap, vg_nameid, seed_vg_req = local_host.vg_matrices(maxvg)
        sdev_cap, sdev_media, seed_sdev_alloc = local_host.device_matrices(maxsd)
        seed_sdev_alloc = seed_sdev_alloc.astype(np.float32)
    else:
        vg_cap = seed_vg_req = np.zeros((N, 1), np.float32)
        vg_nameid = np.zeros((N, 1), np.int32)
        sdev_cap = seed_sdev_alloc = np.zeros((N, 1), np.float32)
        sdev_media = np.zeros((N, 1), np.int32)

    return dict(
        alloc=na.alloc.astype(np.float32),
        node_zone=na.zone_id.astype(np.int32),
        n_zones=len(na.zones) + 1,
        static_mask=static_mask,
        mask_taint=(np.stack([g.mask_taint for g in groups]) if groups else np.zeros((G, N), bool)),
        mask_unsched=(np.stack([g.mask_unsched for g in groups]) if groups else np.zeros((G, N), bool)),
        mask_aff=(np.stack([g.mask_aff for g in groups]) if groups else np.zeros((G, N), bool)),
        mask_extra=(np.stack([g.mask_extra for g in groups]) if groups else np.zeros((G, N), bool)),
        simon_raw=stack("simon_raw"),
        nodeaff_raw=stack("nodeaff_raw"),
        taint_raw=stack("taint_raw"),
        avoid_raw=stack("avoid_raw"),
        image_raw=stack("image_raw"),
        extra_raw=stack("extra_raw"),
        counter_dom=counter_dom,
        counter_topo=counter_topo,
        topo_dom=topo_dom,
        carr_dom=carr_dom,
        carr_topo=carr_topo,
        dns_edom=dns_edom,
        grp_gpu_pre=grp_gpu_pre,
        grp_gpu_take=grp_gpu_take,
        dev_total=dev_total,
        vg_cap=vg_cap,
        vg_nameid=vg_nameid,
        sdev_cap=sdev_cap,
        sdev_media=sdev_media,
        seed_vg_req=seed_vg_req,
        seed_sdev_alloc=seed_sdev_alloc,
        seed_dev_used=seed_dev_used,
        seed_requested=seed_requested,
        seed_nonzero=seed_nonzero,
        seed_port_used=seed_port_used,
        seed_counter=seed_counter,
        seed_carrier=seed_carrier,
    )


def build_batch_tables(
    enc: Encoder,
    batch: List[Tuple[int, int]],          # (group_id, forced_node) per pod, in order
    placed: Dict[object, PlacedGroup],
    match_cache: Dict[Tuple[int, str], bool],
    pad_to: Optional[int] = None,
) -> BatchTables:
    """Assemble numpy tables for one batch. `match_cache` memoizes counter-selector vs
    placed-pod-signature matches across batches (engine-owned).

    Construction is split along the node axis: build_pod_axis_tables is a
    function of the encoder + pod order only (computed once per capacity
    search by the incremental prober), build_node_axis_tables carries every
    [*, N] table and the seeds. The pod-axis half runs first — it interns the
    batch's host ports, which sizes the node-side seed port table."""
    pod_side = build_pod_axis_tables(enc, batch, pad_to=pad_to)
    node_side = build_node_axis_tables(enc, placed, match_cache)
    return BatchTables(**pod_side, **node_side)


def extend_node_axis(
    bt: "BatchTables",
    k: int,
    template_col: int,
    hostname_counters: Sequence[int] = (),
    hostname_carriers: Sequence[int] = (),
) -> "BatchTables":
    """Append k copies of node column `template_col` to every node-axis table of
    an UNPADDED BatchTables (the pre-pad_encoder_axes form) — the incremental
    capacity prober's growth path: extending the candidate-node axis without
    rebuilding NodeArrays/Encoder from raw node dicts.

    Template copies are indistinguishable to every selector except through
    their hostname label (new_fake_nodes rewrites only kubernetes.io/hostname),
    so every appended column is a verbatim copy of the template column, EXCEPT
    the rows listed in hostname_counters/hostname_carriers: those topologies
    have one domain per node, so each appended node gets a fresh domain id.
    With hostname rows present the domain axis therefore grows by k: the
    seed/edom sentinel column moves from D to D+k and the new interior columns
    start at zero (no placed pod can be on an appended node). WITHOUT hostname
    rows the domain axis is untouched — the appended columns reuse the
    template's domain ids verbatim, so repeated extensions never widen the
    counter tables (and the device-resident growth path in probe.py can
    extend the node axis shard-locally with no sentinel remap). Seeds for the
    appended nodes are zero either way — the caller must only append nodes
    that carry no bound pods."""
    if k <= 0:
        return bt
    import dataclasses

    N = bt.alloc.shape[0]
    D = bt.seed_counter.shape[1] - 1
    per_node = bool(hostname_counters) or bool(hostname_carriers)
    newD = D + k if per_node else D

    def rep_col(a: np.ndarray) -> np.ndarray:  # [*, N, ...] along axis 1
        return np.concatenate(
            [a, np.repeat(a[:, template_col:template_col + 1], k, axis=1)], axis=1)

    def rep_row(a: np.ndarray) -> np.ndarray:  # [N, ...] along axis 0
        return np.concatenate(
            [a, np.repeat(a[template_col:template_col + 1], k, axis=0)], axis=0)

    def zero_rows(a: np.ndarray) -> np.ndarray:  # [N, ...]: appended seeds are empty
        return np.concatenate(
            [a, np.zeros((k,) + a.shape[1:], a.dtype)], axis=0)

    def widen(a: np.ndarray) -> np.ndarray:  # [*, D+1] -> [*, newD+1]
        if not per_node:
            return a  # domain axis unchanged: no widening, no sentinel move
        out = np.zeros(a.shape[:-1] + (newD + 1,), a.dtype)
        out[..., :D] = a[..., :D]
        out[..., newD] = a[..., D]  # sentinel column moves with D
        return out

    new_dom_ids = (D + np.arange(k)).astype(np.int32)

    def dom_ext(dom: np.ndarray, per_node_rows: Sequence[int]) -> np.ndarray:
        ext = rep_col(dom)
        if not per_node:
            return ext  # template domain ids replicate verbatim
        ext = np.where(ext == D, newD, ext).astype(np.int32)  # sentinel remap
        for t in per_node_rows:
            ext[t, N:] = new_dom_ids  # fresh hostname domain per appended node
        return ext

    return dataclasses.replace(
        bt,
        alloc=rep_row(bt.alloc),
        node_zone=np.concatenate(
            [bt.node_zone, np.repeat(bt.node_zone[template_col:template_col + 1], k)]),
        static_mask=rep_col(bt.static_mask),
        mask_taint=rep_col(bt.mask_taint),
        mask_unsched=rep_col(bt.mask_unsched),
        mask_aff=rep_col(bt.mask_aff),
        mask_extra=rep_col(bt.mask_extra),
        simon_raw=rep_col(bt.simon_raw),
        nodeaff_raw=rep_col(bt.nodeaff_raw),
        taint_raw=rep_col(bt.taint_raw),
        avoid_raw=rep_col(bt.avoid_raw),
        image_raw=rep_col(bt.image_raw),
        extra_raw=rep_col(bt.extra_raw),
        counter_dom=dom_ext(bt.counter_dom, hostname_counters),
        # hostname TOPOLOGY rows get the same fresh per-node domains as the
        # hostname counter/carrier rows that reference them
        topo_dom=dom_ext(bt.topo_dom, sorted({
            int(bt.counter_topo[t]) for t in hostname_counters
        } | {int(bt.carr_topo[t]) for t in hostname_carriers})),
        carr_dom=dom_ext(bt.carr_dom, hostname_carriers),
        dns_edom=widen(bt.dns_edom),
        dev_total=rep_row(bt.dev_total),
        vg_cap=rep_row(bt.vg_cap),
        vg_nameid=rep_row(bt.vg_nameid),
        sdev_cap=rep_row(bt.sdev_cap),
        sdev_media=rep_row(bt.sdev_media),
        seed_requested=zero_rows(bt.seed_requested),
        seed_nonzero=zero_rows(bt.seed_nonzero),
        seed_port_used=zero_rows(bt.seed_port_used),
        seed_dev_used=zero_rows(bt.seed_dev_used),
        seed_vg_req=zero_rows(bt.seed_vg_req),
        seed_sdev_alloc=zero_rows(bt.seed_sdev_alloc),
        seed_counter=widen(bt.seed_counter),
        seed_carrier=widen(bt.seed_carrier),
    )
