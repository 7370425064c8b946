"""KubeSchedulerConfiguration parsing for --default-scheduler-config.

The port's own copy of `open_simulator_tpu/api/schedconfig.py`. The
reference threads the file through the kube-scheduler options machinery
(GetAndSetSchedulerConfig, pkg/simulator/utils.go:303-381 +
InitKubeSchedulerConfiguration:277-295): the file's profile replaces the
default profile, so its plugin enable/disable lists and score weights govern
scheduling. This module parses the same file into plain data the engine maps
onto its kernels: per-score-plugin weights (disable = weight 0) and the set of
disabled filter plugins.

Parity boundaries, enforced loudly (a config the engine cannot honor raises
ConfigError instead of silently degrading):
- exactly one profile, schedulerName default-scheduler;
- percentageOfNodesToScore must be absent or 100 (the simulator pins it to 100,
  utils.go:370);
- extenders / pluginConfig args / queueSort-preFilter-permit overrides are
  unsupported;
- plugin names must come from the v1.20 default registry + the Simon set
  (an unknown name fails scheduler.New in the reference too);
- volume filter plugins may be listed (enable/disable) but are inert either
  way: MakeValidPod rewrites every PVC to hostPath (see PARITY.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Mapping

from .v1alpha1 import ConfigError

# score plugin name -> (engine weight key, default weight); defaults are the
# v1.20 provider registry (algorithmprovider/registry.go:118-137) with the
# Simon set appended at weight 1 (the framework's zero->1 rule).
SCORE_PLUGINS: Dict[str, tuple] = {
    "NodeResourcesLeastAllocated": ("least", 1.0),
    "NodeResourcesBalancedAllocation": ("balanced", 1.0),
    "ImageLocality": ("image", 1.0),
    "InterPodAffinity": ("interpod", 1.0),
    "NodeAffinity": ("nodeaff", 1.0),
    "NodePreferAvoidPods": ("avoid", 10000.0),
    "PodTopologySpread": ("pts", 2.0),
    "TaintToleration": ("taint", 1.0),
    "SelectorSpread": ("ss", 1.0),
    "Simon": ("simon", 1.0),
    "Open-Gpu-Share": ("gpushare", 1.0),
    "Open-Local": ("openlocal", 1.0),
}

# filter plugins the engine can disable: kernel-evaluated ones map to
# FilterFlags fields, statically-folded ones to encoder keys.
KERNEL_FILTERS = {
    "NodeResourcesFit": "fit",
    "NodePorts": "ports",
    "InterPodAffinity": "interpod",
    "PodTopologySpread": "spread",
}
ENCODER_FILTERS = {"TaintToleration", "NodeUnschedulable", "NodeAffinity"}

# default filter set members that are inert under simulator semantics, so
# enabling/disabling them changes nothing: the volume plugins act on PVCs that
# MakeValidPod rewrote to hostPath (pkg/utils/utils.go:378-463), NodeName
# pins are folded into required node affinity by the workload expansion, and
# DefaultPreemption never runs because failed pods are deleted, not retried.
INERT_FILTERS = frozenset({
    "VolumeBinding", "NodeVolumeLimits", "EBSLimits", "GCEPDLimits",
    "AzureDiskLimits", "VolumeRestrictions", "VolumeZone", "NodeName",
    "Open-Local", "Open-Gpu-Share",
})
KNOWN_FILTERS = frozenset(KERNEL_FILTERS) | ENCODER_FILTERS | INERT_FILTERS

# top-level fields that cannot affect placement in a simulator: parsed and
# ignored, matching the reference (events/leader election are stubbed out,
# utils.go:289-292).
IGNORED_TOP_LEVEL = {
    "apiVersion", "kind", "profiles", "percentageOfNodesToScore",
    "leaderElection", "clientConnection", "healthzBindAddress",
    "metricsBindAddress", "enableProfiling", "enableContentionProfiling",
    "parallelism", "podInitialBackoffSeconds", "podMaxBackoffSeconds",
}

_API_VERSIONS = {
    "kubescheduler.config.k8s.io/v1beta1",
    "kubescheduler.config.k8s.io/v1beta2",
}


@dataclass(frozen=True)
class SchedulerConfig:
    """Engine-facing result: full score weight map (0 = disabled) + disabled
    filter sets, split by where the engine applies them."""

    score_weights: Mapping[str, float] = field(
        default_factory=lambda: {k: d for k, (_, d) in SCORE_PLUGINS.items()})
    disabled_kernel_filters: FrozenSet[str] = frozenset()
    disabled_encoder_filters: FrozenSet[str] = frozenset()
    # postFilter: the default set has exactly DefaultPreemption
    # (algorithmprovider/registry.go:106-110); disabling it turns the
    # engine's preemption pass off (simulator/preemption.py)
    preemption_disabled: bool = False

    def weight_kwargs(self) -> Dict[str, float]:
        """{engine weight key: weight} for kernels.ScoreWeights(**kwargs)."""
        return {SCORE_PLUGINS[name][0]: w for name, w in self.score_weights.items()}


DEFAULT_SCHEDULER_CONFIG = SchedulerConfig()


def _plugin_list(obj, where: str) -> List[dict]:
    if obj is None:
        return []
    if not isinstance(obj, list):
        raise ConfigError(f"scheduler config: {where} must be a list")
    out = []
    for item in obj:
        if not isinstance(item, dict) or "name" not in item:
            raise ConfigError(f"scheduler config: malformed plugin entry in {where}: {item!r}")
        out.append(item)
    return out


def parse_scheduler_config(path: str) -> SchedulerConfig:
    """Load and validate a KubeSchedulerConfiguration file. Raises ConfigError
    on anything the engine cannot honor (see module docstring)."""
    import yaml  # the engine imports this module; only a parse needs yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    if doc is None:
        return DEFAULT_SCHEDULER_CONFIG
    if not isinstance(doc, dict):
        raise ConfigError(f"scheduler config {path}: not a mapping")
    api = doc.get("apiVersion", "")
    if api and api not in _API_VERSIONS:
        raise ConfigError(f"scheduler config: unsupported apiVersion {api!r}")
    kind = doc.get("kind", "")
    if kind and kind != "KubeSchedulerConfiguration":
        raise ConfigError(f"scheduler config: unsupported kind {kind!r}")
    unknown = set(doc) - IGNORED_TOP_LEVEL - {"extenders"}
    if unknown:
        raise ConfigError(
            f"scheduler config: unsupported field(s) {sorted(unknown)}")
    if doc.get("extenders"):
        raise ConfigError("scheduler config: extenders are not supported")
    pct = doc.get("percentageOfNodesToScore")
    if pct not in (None, 0, 100):
        raise ConfigError(
            "scheduler config: percentageOfNodesToScore must be 100 (the "
            f"simulator pins it, utils.go:370); got {pct}")

    profiles = doc.get("profiles") or []
    if not isinstance(profiles, list) or len(profiles) > 1:
        raise ConfigError("scheduler config: exactly one profile is supported")
    if not profiles:
        return DEFAULT_SCHEDULER_CONFIG
    prof = profiles[0] or {}
    name = prof.get("schedulerName")
    if name not in (None, "default-scheduler"):
        raise ConfigError(
            f"scheduler config: schedulerName must be default-scheduler, got {name!r}")
    if prof.get("pluginConfig"):
        raise ConfigError("scheduler config: pluginConfig args are not supported")
    unknown = set(prof) - {"schedulerName", "plugins", "pluginConfig"}
    if unknown:
        raise ConfigError(
            f"scheduler config: unsupported profile field(s) {sorted(unknown)}")

    plugins = prof.get("plugins") or {}
    # extension points whose overrides the engine cannot honor; bind/reserve
    # are accepted when they only touch the Simon set (the reference itself
    # rewrites them, utils.go:321-368)
    for point in set(plugins) - {"score", "filter", "bind", "reserve", "postFilter"}:
        if (plugins.get(point) or {}).get("enabled") or (plugins.get(point) or {}).get("disabled"):
            raise ConfigError(
                f"scheduler config: overriding the {point} extension point is not supported")
    preemption_disabled = False
    pf = plugins.get("postFilter") or {}
    for entry in _plugin_list(pf.get("disabled"), "postFilter.disabled"):
        if entry["name"] in ("*", "DefaultPreemption"):
            preemption_disabled = True
        else:
            raise ConfigError(
                f"scheduler config: unknown postFilter plugin {entry['name']!r}")
    for entry in _plugin_list(pf.get("enabled"), "postFilter.enabled"):
        if entry["name"] != "DefaultPreemption":
            raise ConfigError(
                f"scheduler config: unknown postFilter plugin {entry['name']!r}")
        preemption_disabled = False
    for point in ("bind", "reserve"):
        for entry in _plugin_list((plugins.get(point) or {}).get("enabled"), point):
            if entry["name"] not in ("Simon", "Open-Local", "Open-Gpu-Share", "DefaultBinder"):
                raise ConfigError(
                    f"scheduler config: unsupported {point} plugin {entry['name']!r}")

    weights = {k: d for k, (_, d) in SCORE_PLUGINS.items()}
    score = plugins.get("score") or {}
    for entry in _plugin_list(score.get("disabled"), "score.disabled"):
        nm = entry["name"]
        if nm == "*":
            weights = {k: 0.0 for k in weights}
        elif nm in weights:
            weights[nm] = 0.0
        else:
            raise ConfigError(f"scheduler config: unknown score plugin {nm!r}")
    for entry in _plugin_list(score.get("enabled"), "score.enabled"):
        nm = entry["name"]
        if nm not in SCORE_PLUGINS:
            raise ConfigError(f"scheduler config: unknown score plugin {nm!r}")
        w = entry.get("weight", 0)
        try:
            w = float(w)
        except (TypeError, ValueError):
            raise ConfigError(f"scheduler config: bad weight for {nm!r}: {entry.get('weight')!r}")
        # the framework's zero->1 rule for enabled score plugins
        weights[nm] = w if w > 0 else 1.0

    disabled_kernel: set = set()
    disabled_encoder: set = set()
    flt = plugins.get("filter") or {}
    for entry in _plugin_list(flt.get("disabled"), "filter.disabled"):
        nm = entry["name"]
        if nm == "*":
            disabled_kernel.update(KERNEL_FILTERS)
            disabled_encoder.update(ENCODER_FILTERS)
        elif nm in KERNEL_FILTERS:
            disabled_kernel.add(nm)
        elif nm in ENCODER_FILTERS:
            disabled_encoder.add(nm)
        elif nm in INERT_FILTERS:
            pass  # inert either way, see INERT_FILTERS
        else:
            raise ConfigError(f"scheduler config: unknown filter plugin {nm!r}")
    for entry in _plugin_list(flt.get("enabled"), "filter.enabled"):
        nm = entry["name"]
        if nm not in KNOWN_FILTERS:
            raise ConfigError(f"scheduler config: unknown filter plugin {nm!r}")
        disabled_kernel.discard(nm)
        disabled_encoder.discard(nm)

    return SchedulerConfig(
        score_weights=weights,
        disabled_kernel_filters=frozenset(disabled_kernel),
        disabled_encoder_filters=frozenset(disabled_encoder),
        preemption_disabled=preemption_disabled,
    )
