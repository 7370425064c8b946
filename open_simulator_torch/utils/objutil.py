"""Host-side (string-world) accessors and matchers over k8s object dicts.

These implement the exact matching semantics the vendored scheduler applies —
label selectors (k8s.io/apimachinery labels.SelectorFromSet / LabelSelectorAsSelector),
node-affinity terms (nodeaffinity filter), tolerations (v1helper.TolerationsTolerateTaint) —
used both for host-side pre-computation of per-group static node masks (see
simulator/encode.py) and by the DaemonSet controller simulation
(reference pkg/utils/utils.go:325-366).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from .quantity import parse_milli, parse_quantity

# ------------------------------------------------------------------ metadata ----------


def meta(obj: dict) -> dict:
    return obj.get("metadata") or {}


def name_of(obj: dict) -> str:
    return meta(obj).get("name", "")


def namespace_of(obj: dict) -> str:
    return meta(obj).get("namespace") or "default"


def namespaced_name(obj: dict) -> str:
    return f"{namespace_of(obj)}/{name_of(obj)}"


def labels_of(obj: dict) -> Dict[str, str]:
    return meta(obj).get("labels") or {}


def annotations_of(obj: dict) -> Dict[str, str]:
    return meta(obj).get("annotations") or {}


def set_label(obj: dict, key: str, value: str) -> None:
    obj.setdefault("metadata", {}).setdefault("labels", {})[key] = value


def set_annotation(obj: dict, key: str, value: str) -> None:
    obj.setdefault("metadata", {}).setdefault("annotations", {})[key] = value


def owner_references(obj: dict) -> List[dict]:
    return meta(obj).get("ownerReferences") or []


def is_owned_by_kind(pod: dict, kind: str) -> bool:
    return any(ref.get("kind") == kind for ref in owner_references(pod))


# ----------------------------------------------------------- label selectors ----------


def match_expression(labels: Dict[str, str], expr: dict) -> bool:
    """One LabelSelectorRequirement / NodeSelectorRequirement against a label map.

    Operators per k8s: In, NotIn, Exists, DoesNotExist, Gt, Lt (Gt/Lt are node-only and
    compare integers).
    """
    key = expr.get("key", "")
    op = expr.get("operator", "In")
    values = expr.get("values") or []
    present = key in labels
    if op == "In":
        return present and labels[key] in values
    if op == "NotIn":
        return not present or labels[key] not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op in ("Gt", "Lt"):
        if not present or len(values) != 1:
            return False
        try:
            lbl, val = int(labels[key]), int(values[0])
        except ValueError:
            return False
        return lbl > val if op == "Gt" else lbl < val
    return False


def match_label_selector(selector: Optional[dict], labels: Dict[str, str]) -> bool:
    """metav1.LabelSelector {matchLabels, matchExpressions} vs a label map.

    A nil selector matches nothing in k8s scheduling contexts (affinity terms with nil
    selector match no pods); an empty selector matches everything.
    """
    if selector is None:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        if not match_expression(labels, expr):
            return False
    return True


def selector_from_set(match_labels: Dict[str, str], labels: Dict[str, str]) -> bool:
    """labels.SelectorFromSet — plain equality map (used by Services / RC)."""
    return all(labels.get(k) == v for k, v in match_labels.items())


# ------------------------------------------------------------- node affinity ----------


def match_node_selector_term(node: dict, term: dict) -> bool:
    """One NodeSelectorTerm (matchExpressions AND matchFields) against a node.

    An empty/nil term matches NO node (component-helpers nodeaffinity
    isEmptyNodeSelectorTerm); matchFields supports only metadata.name, as upstream does.
    """
    if not (term.get("matchExpressions") or term.get("matchFields")):
        return False
    labels = labels_of(node)
    for expr in term.get("matchExpressions") or []:
        if not match_expression(labels, expr):
            return False
    for expr in term.get("matchFields") or []:
        if expr.get("key") != "metadata.name":
            return False
        if not match_expression({"metadata.name": name_of(node)}, expr):
            return False
    return True


def match_node_selector(node: dict, node_selector: dict) -> bool:
    """v1.NodeSelector: nodeSelectorTerms are ORed; an empty term list matches nothing."""
    terms = node_selector.get("nodeSelectorTerms") or []
    return any(match_node_selector_term(node, t) for t in terms)


def pod_matches_node_affinity(pod: dict, node: dict) -> bool:
    """The NodeAffinity filter: spec.nodeSelector AND requiredDuringScheduling affinity.

    Mirrors vendored nodeaffinity.Filter semantics (plugins/nodeaffinity/node_affinity.go).
    """
    spec = pod.get("spec") or {}
    ns = spec.get("nodeSelector")
    if ns:
        if not all(labels_of(node).get(k) == v for k, v in ns.items()):
            return False
    affinity = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    required = affinity.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required:
        if not match_node_selector(node, required):
            return False
    return True


def preferred_node_affinity_score(pod: dict, node: dict) -> int:
    """Sum of matching preferredDuringScheduling term weights (nodeaffinity.Score)."""
    spec = pod.get("spec") or {}
    affinity = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    total = 0
    for pref in affinity.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        weight = pref.get("weight", 0)
        term = pref.get("preference") or {}
        if match_node_selector_term(node, term):
            total += weight
    return total


# --------------------------------------------------------- taints/tolerations ----------


def node_taints(node: dict) -> List[dict]:
    return (node.get("spec") or {}).get("taints") or []


def pod_tolerations(pod: dict) -> List[dict]:
    return (pod.get("spec") or {}).get("tolerations") or []


def toleration_tolerates_taint(tol: dict, taint: dict) -> bool:
    """v1helper.TolerationsTolerateTaint single-pair check."""
    if tol.get("effect") and tol.get("effect") != taint.get("effect"):
        return False
    if tol.get("key") and tol.get("key") != taint.get("key"):
        return False
    op = tol.get("operator") or "Equal"
    if op == "Exists":
        return True
    return (tol.get("value") or "") == (taint.get("value") or "")


def find_untolerated_taint(node: dict, pod: dict, effects: Iterable[str]) -> Optional[dict]:
    """First taint (with effect in `effects`) no toleration tolerates; None if all tolerated."""
    tols = pod_tolerations(pod)
    for taint in node_taints(node):
        if taint.get("effect") not in effects:
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in tols):
            return taint
    return None


def untolerated_prefer_no_schedule_count(node: dict, pod: dict) -> int:
    """TaintToleration score input: count of intolerable PreferNoSchedule taints."""
    tols = pod_tolerations(pod)
    cnt = 0
    for taint in node_taints(node):
        if taint.get("effect") != "PreferNoSchedule":
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in tols):
            cnt += 1
    return cnt


# ------------------------------------------------------------- pod resources ----------

# Resource axis canonical names used across the tensor layer.
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL = "ephemeral-storage"
PODS = "pods"


def _requests_of_container(c: dict) -> Dict[str, float]:
    out = {}
    for k, v in ((c.get("resources") or {}).get("requests") or {}).items():
        out[k] = parse_milli(v) if k == CPU else parse_quantity(v)
    return out


def pod_resource_requests(pod: dict) -> Dict[str, float]:
    """Effective pod requests: max(sum(containers), each initContainer) + overhead.

    Matches resourcehelper.PodRequestsAndLimits / scheduler's computePodResourceRequest.
    CPU is in MILLI-cores; everything else in base units.
    """
    spec = pod.get("spec") or {}
    total: Dict[str, float] = {}
    for c in spec.get("containers") or []:
        for k, v in _requests_of_container(c).items():
            total[k] = total.get(k, 0) + v
    for c in spec.get("initContainers") or []:
        for k, v in _requests_of_container(c).items():
            if v > total.get(k, 0):
                total[k] = v
    for k, v in (spec.get("overhead") or {}).items():
        q = parse_milli(v) if k == CPU else parse_quantity(v)
        total[k] = total.get(k, 0) + q
    return total


def node_allocatable(node: dict) -> Dict[str, float]:
    """status.allocatable → base units (cpu in milli). Falls back to capacity."""
    status = node.get("status") or {}
    alloc = status.get("allocatable") or status.get("capacity") or {}
    out: Dict[str, float] = {}
    for k, v in alloc.items():
        out[k] = parse_milli(v) if k == CPU else parse_quantity(v)
    return out


def pod_host_ports(pod: dict) -> List[tuple]:
    """(protocol, hostIP, hostPort) triples the NodePorts plugin checks.

    Only spec.containers are scanned (node_ports.go getContainerPorts ignores init
    containers). hostNetwork pods expose every containerPort as a host port (k8s
    defaulting sets hostPort = containerPort for hostNetwork pods).
    """
    spec = pod.get("spec") or {}
    host_net = bool(spec.get("hostNetwork"))
    out = []
    for c in spec.get("containers") or []:
        for p in c.get("ports") or []:
            hp = p.get("hostPort")
            if hp is None and host_net:
                hp = p.get("containerPort")
            if hp:
                out.append((p.get("protocol") or "TCP", p.get("hostIP") or "0.0.0.0", int(hp)))
    return out


def pod_is_bound(pod: dict) -> bool:
    return bool((pod.get("spec") or {}).get("nodeName"))


def pod_scheduler_name(pod: dict) -> str:
    return (pod.get("spec") or {}).get("schedulerName") or "default-scheduler"
