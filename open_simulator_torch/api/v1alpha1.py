"""The `simon/v1alpha1 Config` CR — the apply-mode configuration file.

The port's own copy of `open_simulator_tpu/api/v1alpha1.py`. Mirrors the
reference's pkg/api/v1alpha1/types.go:3-29 and the Applier validation at
pkg/apply/apply.go:269-306, so reference config files (e.g.
example/simon-config.yaml) load unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional


class ConfigError(ValueError):
    pass


@dataclass
class AppInfo:
    name: str
    path: str
    chart: bool = False


@dataclass
class Cluster:
    custom_cluster: str = ""   # customConfig: YAML dir describing a fake cluster
    kube_config: str = ""      # kubeConfig: path to a live cluster's kubeconfig


@dataclass
class SimonSpec:
    cluster: Cluster = field(default_factory=Cluster)
    app_list: List[AppInfo] = field(default_factory=list)
    new_node: str = ""


@dataclass
class SimonConfig:
    api_version: str = "simon/v1alpha1"
    kind: str = "Config"
    name: str = ""
    spec: SimonSpec = field(default_factory=SimonSpec)


def parse_simon_config(path: str) -> SimonConfig:
    """Load + decode a Simon config file. Relative paths inside the config are
    interpreted relative to the process CWD, as in the reference."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    spec_raw = raw.get("spec") or {}
    cluster_raw = spec_raw.get("cluster") or {}
    apps = [
        AppInfo(
            name=a.get("name", ""),
            path=a.get("path", ""),
            chart=bool(a.get("chart", False)),
        )
        for a in spec_raw.get("appList") or []
    ]
    return SimonConfig(
        api_version=raw.get("apiVersion", ""),
        kind=raw.get("kind", ""),
        name=(raw.get("metadata") or {}).get("name", ""),
        spec=SimonSpec(
            cluster=Cluster(
                custom_cluster=cluster_raw.get("customConfig", "") or "",
                kube_config=cluster_raw.get("kubeConfig", "") or "",
            ),
            app_list=apps,
            new_node=spec_raw.get("newNode", "") or "",
        ),
    )


def validate_config(
    cfg: SimonConfig, scheduler_config: Optional[str] = None
) -> None:
    """The Applier validity test (apply.go:269-306): cluster source XOR + every
    referenced path must exist."""
    c = cfg.spec.cluster
    if bool(c.kube_config) == bool(c.custom_cluster):
        raise ConfigError("only one of values of both kubeConfig and customConfig must exist")
    for label, p in (("kubeConfig", c.kube_config), ("customConfig", c.custom_cluster),
                     ("scheduler config", scheduler_config or ""),
                     ("newNode", cfg.spec.new_node)):
        if p and not os.path.exists(p):
            raise ConfigError(f"invalid path of {label}: {p}")
    for app in cfg.spec.app_list:
        if not os.path.exists(app.path):
            raise ConfigError(f"invalid path of {app.name} app: {app.path}")
