"""Object validation for generated pods/nodes.

The reference runs full k8s apimachinery validation on every generated object
(reference pkg/utils/utils.go:495-508 ValidatePod → validation.ValidatePodCreate,
utils.go:625-645 ValidateNode). This module reimplements the checks that can
actually fire on simulator inputs: DNS-1123 names and namespaces, label
key/value syntax, required fields, non-negative resource quantities, requests
≤ limits, container port ranges + per-pod hostPort uniqueness, toleration
operator/effect combinations, volume name uniqueness, topology-spread
constraint shape, node-selector requirement operators, and known
restart/DNS policies.
"""

from __future__ import annotations

import re
from typing import List

from .quantity import InvalidQuantity, parse_decimal

_DNS1123_SUBDOMAIN = re.compile(r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$")
_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_QUALIFIED_NAME = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")
_LABEL_VALUE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?$")

_TOLERATION_OPS = ("", "Exists", "Equal")
_TAINT_EFFECTS = ("", "NoSchedule", "PreferNoSchedule", "NoExecute")
_SELECTOR_OPS = ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")


class ValidationError(ValueError):
    pass


def _err(errs: List[str], msg: str) -> None:
    errs.append(msg)


def validate_name(name: str, errs: List[str], what: str) -> None:
    if not name:
        _err(errs, f"{what}: name is required")
    elif len(name) > 253 or not _DNS1123_SUBDOMAIN.match(name):
        _err(errs, f"{what}: invalid DNS-1123 name {name!r}")


def _validate_resources(res: dict, errs: List[str], where: str) -> None:
    requests = (res or {}).get("requests") or {}
    limits = (res or {}).get("limits") or {}
    for bucket_name, bucket in (("requests", requests), ("limits", limits)):
        for k, v in bucket.items():
            try:
                q = parse_decimal(v)
            except InvalidQuantity as e:
                _err(errs, f"{where}.{bucket_name}[{k}]: {e}")
                continue
            if q < 0:
                _err(errs, f"{where}.{bucket_name}[{k}]: must be non-negative")
    for k, v in requests.items():
        if k in limits:
            try:
                if parse_decimal(v) > parse_decimal(limits[k]):
                    _err(errs, f"{where}: request of {k} exceeds limit")
            except InvalidQuantity:
                pass


def _validate_labels(labels: dict, errs: List[str], where: str) -> None:
    """metav1.validation.ValidateLabels: qualified-name keys (optional
    DNS-subdomain prefix), 63-char label-value syntax."""
    for k, v in (labels or {}).items():
        prefix, _, name = str(k).rpartition("/")
        if prefix and (len(prefix) > 253 or not _DNS1123_SUBDOMAIN.match(prefix)):
            _err(errs, f"{where}: invalid label key prefix {prefix!r}")
        if not name or len(name) > 63 or not _QUALIFIED_NAME.match(name):
            _err(errs, f"{where}: invalid label key {k!r}")
        if len(str(v)) > 63 or not _LABEL_VALUE.match(str(v)):
            _err(errs, f"{where}: invalid label value {v!r} for key {k!r}")


def _validate_ports(containers: List[dict], errs: List[str]) -> None:
    """validateContainerPorts + AccumulateUniqueHostPorts: port ranges and
    per-pod (hostPort, protocol, hostIP) uniqueness."""
    seen_host = set()
    for c in containers:
        cname = c.get("name", "")
        for p in c.get("ports") or []:
            cp = p.get("containerPort")
            if not isinstance(cp, int) or not 0 < cp <= 65535:
                _err(errs, f"container {cname}: invalid containerPort {cp!r}")
            hp = p.get("hostPort")
            if hp is not None:
                if not isinstance(hp, int) or not 0 < hp <= 65535:
                    _err(errs, f"container {cname}: invalid hostPort {hp!r}")
                else:
                    key = (hp, p.get("protocol") or "TCP", p.get("hostIP") or "")
                    if key in seen_host:
                        _err(errs, f"container {cname}: duplicate hostPort {key}")
                    seen_host.add(key)
            proto = p.get("protocol")
            if proto and proto not in ("TCP", "UDP", "SCTP"):
                _err(errs, f"container {cname}: invalid protocol {proto!r}")


def _validate_tolerations(tolerations: List[dict], errs: List[str]) -> None:
    """validateTolerations: operator/value combinations and known effects."""
    for t in tolerations or []:
        op = t.get("operator") or ""
        if op not in _TOLERATION_OPS:
            _err(errs, f"toleration: invalid operator {op!r}")
        if op == "Exists" and t.get("value"):
            _err(errs, "toleration: value must be empty with operator Exists")
        if not t.get("key") and op not in ("", "Exists"):
            _err(errs, "toleration: empty key requires operator Exists")
        eff = t.get("effect") or ""
        if eff not in _TAINT_EFFECTS:
            _err(errs, f"toleration: invalid effect {eff!r}")


def _validate_selector_terms(affinity: dict, errs: List[str]) -> None:
    """ValidateNodeSelectorRequirement over every node-affinity term."""
    na = (affinity or {}).get("nodeAffinity") or {}
    terms = ((na.get("requiredDuringSchedulingIgnoredDuringExecution") or {})
             .get("nodeSelectorTerms") or [])
    terms = list(terms) + [
        p.get("preference") or {}
        for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []
    ]
    for term in terms:
        for req in (term.get("matchExpressions") or []) + (term.get("matchFields") or []):
            op = req.get("operator", "")
            vals = req.get("values") or []
            if op not in _SELECTOR_OPS:
                _err(errs, f"affinity: invalid operator {op!r}")
            elif op in ("In", "NotIn") and not vals:
                _err(errs, f"affinity: operator {op} requires values")
            elif op in ("Exists", "DoesNotExist") and vals:
                _err(errs, f"affinity: operator {op} forbids values")
            elif op in ("Gt", "Lt") and len(vals) != 1:
                _err(errs, f"affinity: operator {op} requires exactly one value")


def _validate_spread(constraints: List[dict], errs: List[str]) -> None:
    """validateTopologySpreadConstraints: positive maxSkew, topologyKey
    required, known whenUnsatisfiable."""
    for c in constraints or []:
        ms = c.get("maxSkew")
        if not isinstance(ms, int) or ms <= 0:
            _err(errs, f"topologySpreadConstraint: maxSkew must be > 0, got {ms!r}")
        if not c.get("topologyKey"):
            _err(errs, "topologySpreadConstraint: topologyKey is required")
        wu = c.get("whenUnsatisfiable", "DoNotSchedule")
        if wu not in ("DoNotSchedule", "ScheduleAnyway"):
            _err(errs, f"topologySpreadConstraint: invalid whenUnsatisfiable {wu!r}")


def validate_pod(pod: dict) -> None:
    """Raise ValidationError listing every problem found (mirrors ValidatePod)."""
    errs: List[str] = []
    md = pod.get("metadata") or {}
    validate_name(md.get("name", ""), errs, "pod")
    ns = md.get("namespace")
    if ns and (len(ns) > 63 or not _DNS1123_LABEL.match(ns)):
        _err(errs, f"pod: invalid namespace {ns!r}")
    _validate_labels(md.get("labels") or {}, errs, "pod")
    spec = pod.get("spec") or {}
    containers = spec.get("containers") or []
    if not containers:
        _err(errs, "pod: spec.containers is required")
    seen = set()
    # name uniqueness is required across containers AND initContainers (ValidatePodCreate)
    for c in containers + (spec.get("initContainers") or []):
        cname = c.get("name", "")
        if not cname or not _DNS1123_LABEL.match(cname):
            _err(errs, f"container: invalid name {cname!r}")
        if not c.get("image"):
            _err(errs, f"container {cname}: image is required")
        _validate_resources(c.get("resources") or {}, errs, f"container {cname}")
        if cname in seen:
            _err(errs, f"container: duplicate name {cname!r}")
        seen.add(cname)
    _validate_ports(containers + (spec.get("initContainers") or []), errs)
    _validate_tolerations(spec.get("tolerations") or [], errs)
    _validate_selector_terms(spec.get("affinity") or {}, errs)
    _validate_spread(spec.get("topologySpreadConstraints") or [], errs)
    seen_vols = set()
    for v in spec.get("volumes") or []:
        vn = v.get("name", "")
        if not vn or len(vn) > 63 or not _DNS1123_LABEL.match(vn):
            _err(errs, f"volume: invalid name {vn!r}")
        if vn in seen_vols:
            _err(errs, f"volume: duplicate name {vn!r}")
        seen_vols.add(vn)
    rp = spec.get("restartPolicy")
    if rp and rp not in ("Always", "OnFailure", "Never"):
        _err(errs, f"pod: invalid restartPolicy {rp!r}")
    dp = spec.get("dnsPolicy")
    if dp and dp not in ("ClusterFirst", "ClusterFirstWithHostNet", "Default", "None"):
        _err(errs, f"pod: invalid dnsPolicy {dp!r}")
    if errs:
        raise ValidationError("invalid pod: " + "; ".join(errs))


def validate_node(node: dict) -> None:
    """Mirrors ValidateNode: name + non-negative capacity/allocatable quantities."""
    errs: List[str] = []
    md = node.get("metadata") or {}
    validate_name(md.get("name", ""), errs, "node")
    _validate_labels(md.get("labels") or {}, errs, "node")
    for t in (node.get("spec") or {}).get("taints") or []:
        if not t.get("key"):
            _err(errs, "node taint: key is required")
        if t.get("effect") not in ("NoSchedule", "PreferNoSchedule", "NoExecute"):
            _err(errs, f"node taint: invalid effect {t.get('effect')!r}")
    status = node.get("status") or {}
    for bucket_name in ("capacity", "allocatable"):
        for k, v in (status.get(bucket_name) or {}).items():
            try:
                if parse_decimal(v) < 0:
                    _err(errs, f"node.{bucket_name}[{k}]: must be non-negative")
            except InvalidQuantity as e:
                _err(errs, f"node.{bucket_name}[{k}]: {e}")
    if errs:
        raise ValidationError("invalid node: " + "; ".join(errs))
