"""Controller simulation: expand workload objects into the pods kube-controller-manager
would create.

Mirrors reference pkg/utils/utils.go:
- Deployment → synthetic ReplicaSet → pods (:132-171)
- ReplicaSet/ReplicationController → pods (:137-159)
- StatefulSet → ordinal-named pods + volumeClaimTemplates → local-storage annotation
  (:219-292)
- Job / CronJob → `completions` pods (:173-203)
- DaemonSet → one pod per eligible node with node-name matchFields affinity
  (:325-366, :770-815; eligibility = daemon.Predicates, daemon_controller.go:1251-1258)
- MakeValidPod defaulting/sanitization (:378-463)

Pod names follow the reference convention `<owner>-<suffix>` (SetObjectMetaFromObject,
utils.go:295-323); suffixes here are deterministic (monotone counter rendered as 10
lowercase alnum chars) instead of random, which keeps simulations reproducible.
"""

from __future__ import annotations

import copy
import itertools
import json
from typing import List

from ..core import constants as C
from ..utils.objutil import (
    find_untolerated_taint,
    name_of,
    namespace_of,
    pod_matches_node_affinity,
    set_annotation,
    set_label,
)
from ..utils.quantity import parse_quantity
from ..utils.validate import validate_pod

_counter = itertools.count(1)
_ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789"


def _suffix() -> str:
    """Deterministic 10-char suffix (stands in for apimachinery rand.String(10))."""
    n = next(_counter)
    chars = []
    for _ in range(10):
        n, r = divmod(n, len(_ALPHABET))
        chars.append(_ALPHABET[r])
    return "".join(chars)


def reset_name_counter() -> None:
    """Test hook: restart suffix sequence."""
    global _counter
    _counter = itertools.count(1)


def _uid() -> str:
    return f"uid-{next(_counter):08d}"


def _object_meta_from(owner: dict, template: dict, kind: str) -> dict:
    """ObjectMeta for a controller-created pod (SetObjectMetaFromObject, utils.go:295-323)."""
    tmeta = template.get("metadata") or {}
    return {
        "name": f"{name_of(owner)}-{_suffix()}",
        "namespace": namespace_of(owner),
        "uid": _uid(),
        "generateName": name_of(owner),
        "labels": copy.deepcopy(tmeta.get("labels") or {}),
        "annotations": copy.deepcopy(tmeta.get("annotations") or {}),
        "ownerReferences": [
            {
                "apiVersion": owner.get("apiVersion", "apps/v1"),
                "kind": kind,
                "name": name_of(owner),
                "uid": (owner.get("metadata") or {}).get("uid", ""),
                "controller": True,
                "blockOwnerDeletion": True,
            }
        ],
    }


def make_valid_pod(pod: dict) -> dict:
    """Defaulting + sanitization (MakeValidPod, utils.go:378-463): default namespace/
    dnsPolicy/restartPolicy/schedulerName; strip env/mounts/probes/imagePullSecrets/
    managedFields/status; PVC volumes become hostPath /tmp; then validate."""
    pod = copy.deepcopy(pod)
    meta = pod.setdefault("metadata", {})
    meta.setdefault("labels", {})
    meta.setdefault("annotations", {})
    if not meta.get("namespace"):
        meta["namespace"] = "default"
    meta.pop("managedFields", None)
    spec = pod.setdefault("spec", {})
    spec.setdefault("dnsPolicy", "ClusterFirst")
    spec.setdefault("restartPolicy", "Always")
    spec.setdefault("schedulerName", C.DefaultSchedulerName)
    spec.pop("imagePullSecrets", None)
    for key in ("containers", "initContainers"):
        for c in spec.get(key) or []:
            c.setdefault("terminationMessagePolicy", "FallbackToLogsOnError")
            c.setdefault("imagePullPolicy", "IfNotPresent")
            if (c.get("securityContext") or {}).get("privileged") is not None:
                c["securityContext"]["privileged"] = False
            c.pop("volumeMounts", None)
            c.pop("env", None)
            if key == "containers":
                c.pop("livenessProbe", None)
                c.pop("readinessProbe", None)
                c.pop("startupProbe", None)
    for v in spec.get("volumes") or []:
        if "persistentVolumeClaim" in v:
            v.pop("persistentVolumeClaim")
            v["hostPath"] = {"path": "/tmp"}
    pod["status"] = {}
    validate_pod(pod)
    return pod


def make_valid_pod_by_pod(pod: dict) -> dict:
    """MakeValidPodByPod (utils.go:368-376): fresh UID + sanitize."""
    pod = copy.deepcopy(pod)
    pod.setdefault("metadata", {})["uid"] = _uid()
    return make_valid_pod(pod)


def _add_workload_info(pod: dict, kind: str, name: str, namespace: str) -> dict:
    set_annotation(pod, C.AnnoWorkloadKind, kind)
    set_annotation(pod, C.AnnoWorkloadName, name)
    set_annotation(pod, C.AnnoWorkloadNamespace, namespace)
    return pod


def _stamp_sig_memo(pods: List[dict]) -> List[dict]:
    """Pods expanded from one workload template are scheduling-identical: compute
    the group signature once and memoize it on every replica (the engine pops the
    marker when emitting results). Cuts the per-pod host encode cost for large
    replica counts to O(1) per workload."""
    if len(pods) > 1:
        from ..simulator.encode import scheduling_signature

        sig = scheduling_signature(pods[0])
        for p in pods:
            p["__sig_memo__"] = sig
    return pods


def _pods_from_template(owner: dict, kind: str, replicas: int, template: dict) -> List[dict]:
    """Replicas of one template differ only in metadata.name/uid (generated
    here), so defaulting + sanitization + validation run ONCE on a prototype
    and the remaining replicas are byte-copies with fresh name/uid — the
    reference fans this out over goroutines instead
    (pkg/simulator/utils.go:77-115); one validated prototype is both faster
    and equally exact, since make_valid_pod is deterministic and never reads
    the generated name."""
    if replicas <= 0:
        return _stamp_sig_memo([])
    proto = {
        "metadata": _object_meta_from(owner, template, kind),
        "spec": copy.deepcopy(template.get("spec") or {}),
    }
    proto = make_valid_pod(proto)
    _add_workload_info(proto, kind, name_of(owner), namespace_of(owner))
    pods = [proto]
    if replicas > 1:
        import pickle

        owner_name = name_of(owner)
        blob = pickle.dumps(proto, -1)  # ~3x faster than deepcopy for dicts
        for _ in range(replicas - 1):
            pod = pickle.loads(blob)
            md = pod["metadata"]
            md["name"] = f"{owner_name}-{_suffix()}"
            md["uid"] = _uid()
            pods.append(pod)
    return _stamp_sig_memo(pods)


def pods_from_replicaset(rs: dict) -> List[dict]:
    spec = rs.get("spec") or {}
    replicas = spec.get("replicas", 1)
    if replicas is None:
        replicas = 1
    return _pods_from_template(rs, C.ReplicaSet, int(replicas), spec.get("template") or {})


def pods_from_replicationcontroller(rc: dict) -> List[dict]:
    spec = rc.get("spec") or {}
    replicas = spec.get("replicas", 1)
    if replicas is None:
        replicas = 1
    return _pods_from_template(rc, C.ReplicationController, int(replicas), spec.get("template") or {})


def pods_from_deployment(deploy: dict) -> List[dict]:
    """Deployment → synthetic RS (name `<deploy>-<suffix>`) → pods (utils.go:132-171)."""
    spec = deploy.get("spec") or {}
    rs = {
        "apiVersion": "apps/v1",
        "kind": C.ReplicaSet,
        "metadata": _object_meta_from(deploy, spec.get("template") or {}, C.Deployment),
        "spec": {
            "selector": spec.get("selector"),
            "replicas": spec.get("replicas", 1),
            "template": spec.get("template") or {},
        },
    }
    return pods_from_replicaset(rs)


def pods_from_statefulset(sts: dict) -> List[dict]:
    """STS pods are renamed `<sts>-<ordinal>`; volumeClaimTemplates with open-local/yoda
    storage classes are serialized into the pod local-storage annotation
    (utils.go:219-292)."""
    spec = sts.get("spec") or {}
    replicas = spec.get("replicas", 1)
    if replicas is None:
        replicas = 1
    pods = _pods_from_template(sts, C.StatefulSet, int(replicas), spec.get("template") or {})
    for ordinal, pod in enumerate(pods):
        pod["metadata"]["name"] = f"{name_of(sts)}-{ordinal}"
    _set_storage_annotation(pods, spec.get("volumeClaimTemplates") or [], name_of(sts))
    # the storage annotation is signature-relevant: re-stamp after writing it
    for pod in pods:
        pod.pop("__sig_memo__", None)
    return _stamp_sig_memo(pods)


_LVM_SCS = {C.OpenLocalSCNameLVM, C.YodaSCNameLVM}
_SSD_SCS = {C.OpenLocalSCNameDeviceSSD, C.OpenLocalSCNameMountPointSSD, C.YodaSCNameDeviceSSD, C.YodaSCNameMountPointSSD}
_HDD_SCS = {C.OpenLocalSCNameDeviceHDD, C.OpenLocalSCNameMountPointHDD, C.YodaSCNameDeviceHDD, C.YodaSCNameMountPointHDD}


def _set_storage_annotation(pods: List[dict], volume_claim_templates: List[dict], sts_name: str) -> None:
    # Wire format matches the reference's Volume struct (utils.go:515-521): size is a
    # string-encoded int64 (json:"size,string"), storage class under "scName".
    volumes = []
    for pvc in volume_claim_templates:
        sc = (pvc.get("spec") or {}).get("storageClassName")
        size = parse_quantity(
            (((pvc.get("spec") or {}).get("resources") or {}).get("requests") or {}).get("storage", 0)
        )
        if sc in _LVM_SCS:
            volumes.append({"size": str(int(size)), "kind": "LVM", "scName": sc})
        elif sc in _SSD_SCS:
            volumes.append({"size": str(int(size)), "kind": "SSD", "scName": sc})
        elif sc in _HDD_SCS:
            volumes.append({"size": str(int(size)), "kind": "HDD", "scName": sc})
        # unknown storage classes are logged-and-skipped by the reference
    payload = json.dumps({"volumes": volumes})
    for pod in pods:
        set_annotation(pod, C.AnnoPodLocalStorage, payload)


def pods_from_job(job: dict) -> List[dict]:
    spec = job.get("spec") or {}
    completions = spec.get("completions", 1)
    if completions is None:
        completions = 1
    return _pods_from_template(job, C.Job, int(completions), spec.get("template") or {})


def pods_from_cronjob(cronjob: dict) -> List[dict]:
    """CronJob → one synthetic Job instance (utils.go:173-218)."""
    spec = cronjob.get("spec") or {}
    job_template = (spec.get("jobTemplate") or {}).get("spec") or {}
    tmpl = job_template.get("template") or {}
    job = {
        "apiVersion": "batch/v1",
        "kind": C.Job,
        "metadata": _object_meta_from(cronjob, tmpl, C.CronJob),
        "spec": job_template,
    }
    return pods_from_job(job)


# ------------------------------------------------------------------ DaemonSet ----------


def set_daemon_pod_node_affinity(pod: dict, node_name: str) -> None:
    """Pin a daemon pod to one node via matchFields metadata.name affinity, preserving
    each existing required term's matchExpressions (utils.go:770-815)."""
    req = {"key": "metadata.name", "operator": "In", "values": [node_name]}
    spec = pod.setdefault("spec", {})
    affinity = spec.setdefault("affinity", {})
    node_aff = affinity.setdefault("nodeAffinity", {})
    required = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution")
    if not required or not required.get("nodeSelectorTerms"):
        node_aff["requiredDuringSchedulingIgnoredDuringExecution"] = {
            "nodeSelectorTerms": [{"matchFields": [req]}]
        }
        return
    for term in required["nodeSelectorTerms"]:
        term["matchFields"] = [req]


def node_should_run_pod(node: dict, pod: dict) -> bool:
    """daemon.Predicates (daemon_controller.go:1251-1258): nodeName fit, nodeSelector +
    required affinity fit, and NoSchedule/NoExecute taints tolerated."""
    node_name = (pod.get("spec") or {}).get("nodeName")
    if node_name and node_name != name_of(node):
        return False
    if not pod_matches_node_affinity(pod, node):
        return False
    if find_untolerated_taint(node, pod, ("NoSchedule", "NoExecute")) is not None:
        return False
    return True


def pods_from_daemonset(ds: dict, nodes: List[dict]) -> List[dict]:
    """One pinned pod per node passing daemon.Predicates (utils.go:337-366)."""
    pods = []
    spec = ds.get("spec") or {}
    template = spec.get("template") or {}
    for node in nodes:
        pod = {
            "metadata": _object_meta_from(ds, template, C.DaemonSet),
            "spec": copy.deepcopy(template.get("spec") or {}),
        }
        set_daemon_pod_node_affinity(pod, name_of(node))
        pod = make_valid_pod(pod)
        _add_workload_info(pod, C.DaemonSet, name_of(ds), namespace_of(ds))
        if node_should_run_pod(node, pod):
            pods.append(pod)
    if len(pods) > 1:
        # DS pods differ only by their per-node pin, which the engine strips
        # before grouping; the shared signature is the UNPINNED template's.
        tmpl_pod = make_valid_pod({
            "metadata": _object_meta_from(ds, template, C.DaemonSet),
            "spec": copy.deepcopy(template.get("spec") or {}),
        })
        _add_workload_info(tmpl_pod, C.DaemonSet, name_of(ds), namespace_of(ds))
        from ..simulator.encode import scheduling_signature

        sig = scheduling_signature(tmpl_pod)
        for p in pods:
            p["__sig_memo__"] = sig
    return pods


# --------------------------------------------------------------- fake nodes -----------


def make_valid_node(node: dict, node_name: str) -> dict:
    """Rename + hostname label + UID + validate (MakeValidNodeByNode, utils.go:473-492)."""
    node = copy.deepcopy(node)
    meta = node.setdefault("metadata", {})
    meta["name"] = node_name
    meta["uid"] = _uid()
    meta.setdefault("labels", {})[C.LabelHostname] = node_name
    meta.setdefault("annotations", {})
    meta.pop("managedFields", None)
    from ..utils.validate import validate_node

    validate_node(node)
    return node


# ---------------------------------------------------------- app/cluster expand --------


def expand_workloads_excluding_daemonsets(rt) -> List[dict]:
    """GetValidPodExcludeDaemonSet (pkg/simulator/utils.go:79-230): raw pods + every
    workload kind except DaemonSet, which needs the node list."""
    pods: List[dict] = []
    for pod in rt.pods:
        pods.append(make_valid_pod_by_pod(pod))
    for deploy in rt.deployments:
        pods.extend(pods_from_deployment(deploy))
    for rs in rt.replica_sets:
        pods.extend(pods_from_replicaset(rs))
    for rc in rt.replication_controllers:
        pods.extend(pods_from_replicationcontroller(rc))
    for sts in rt.stateful_sets:
        pods.extend(pods_from_statefulset(sts))
    for job in rt.jobs:
        pods.extend(pods_from_job(job))
    for cj in rt.cron_jobs:
        pods.extend(pods_from_cronjob(cj))
    return pods


def generate_valid_pods_from_app(app_name: str, rt, nodes: List[dict]) -> List[dict]:
    """GenerateValidPodsFromAppResources (pkg/simulator/utils.go:37-74): expand all
    workloads, pin DaemonSet pods per node, then stamp the app-name label."""
    pods = expand_workloads_excluding_daemonsets(rt)
    for ds in rt.daemon_sets:
        pods.extend(pods_from_daemonset(ds, nodes))
    # The app-name label lands AFTER expansion stamped the signature memos, and
    # labels are part of the scheduling signature — refresh each workload's memo
    # (one recompute per distinct old memo, still O(1) per replica) so identical
    # templates from different apps never share a scheduling group. DaemonSet
    # memos keep the documented invariant of being the UNPINNED template's
    # signature (pods_from_daemonset), so the per-node pin is stripped first.
    from ..simulator.encode import SIG_MEMO_KEY, scheduling_signature, strip_daemon_pin

    remapped: dict = {}
    for pod in pods:
        set_label(pod, C.LabelAppName, app_name)
        old = pod.pop(SIG_MEMO_KEY, None)
        if old is not None:
            new = remapped.get(old)
            if new is None:
                stripped, target = strip_daemon_pin(pod)
                new = remapped[old] = scheduling_signature(
                    stripped if target is not None else pod
                )
            pod[SIG_MEMO_KEY] = new
    return pods
