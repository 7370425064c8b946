"""YAML ingestion: recursive directory walk → decoded k8s objects → ResourceTypes.

Mirrors the reference's cluster/app file loading (reference pkg/utils/utils.go:43-130
`GetYamlContentFromDirectory`, and reference pkg/simulator/utils.go:233-275
`GetObjectFromYamlContent`): walk a directory tree, split multi-document YAML, bucket each
object by kind, error on unknown kinds.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List

from ..core import constants as C
from ..core.types import KIND_TO_FIELD, ResourceTypes
from .objutil import name_of


class UnknownKindError(ValueError):
    pass


def read_yaml_files(directory: str) -> List[str]:
    """Recursively collect .yaml/.yml file contents under `directory` (sorted walk)."""
    contents = []
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"not a directory: {directory}")
    for root, dirs, files in os.walk(directory):
        dirs.sort()
        for fname in sorted(files):
            if fname.endswith((".yaml", ".yml")):
                with open(os.path.join(root, fname), "r", encoding="utf-8") as f:
                    contents.append(f.read())
    return contents


def decode_yaml_content(contents: Iterable[str]) -> List[dict]:
    """Split multi-doc YAML strings into object dicts, skipping empty docs.
    `yaml` is imported here, not at module load: hosts that only run the
    scheduler on synthetic clusters need not have it."""
    import yaml

    # libyaml-backed loader when present: 5-10x faster parsing, which matters
    # for multi-thousand-node cluster dumps; semantics identical to SafeLoader
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    objs = []
    for content in contents:
        for doc in yaml.load_all(content, Loader=loader):
            if isinstance(doc, dict) and doc:
                objs.append(doc)
    return objs


def bucket_objects(objs: Iterable[dict], strict: bool = True) -> ResourceTypes:
    """Dispatch decoded objects into ResourceTypes by `kind`.

    `strict=True` raises on unsupported kinds, matching GetObjectFromYamlContent's
    "unknown struct type" error; strict=False skips them (server-mode snapshots may carry
    kinds the simulator ignores).
    """
    rt = ResourceTypes()
    for obj in objs:
        kind = obj.get("kind")
        field = KIND_TO_FIELD.get(kind)
        if field is None:
            if strict:
                raise UnknownKindError(f"unknown struct type: kind={kind!r}")
            continue
        getattr(rt, field).append(obj)
    return rt


def load_resources_from_directory(directory: str, strict: bool = True) -> ResourceTypes:
    return bucket_objects(decode_yaml_content(read_yaml_files(directory)), strict=strict)


def match_and_set_local_storage_annotation(nodes: List[dict], directory: str) -> None:
    """MatchAndSetLocalStorageAnnotationOnNode (pkg/simulator/utils.go:385-401):
    node-name-matched .json files in `directory` become the node's
    simon/node-local-storage annotation."""
    storage = load_json_files(directory)
    for node in nodes:
        info = storage.get(name_of(node))
        if info is not None:
            node.setdefault("metadata", {}).setdefault("annotations", {})[
                C.AnnoNodeLocalStorage
            ] = json.dumps(info)


def _load_cluster_from_directory(directory: str, strict: bool = True) -> ResourceTypes:
    """CreateClusterResourceFromClusterConfig (simulator.go:604-619): YAML objects
    plus node-name-matched local-storage specs applied as node annotations."""
    rt = load_resources_from_directory(directory, strict=strict)
    match_and_set_local_storage_annotation(rt.nodes, directory)
    return rt


def load_json_files(directory: str) -> dict:
    """name → parsed JSON for .json files in a dir (local-storage node specs,
    reference pkg/simulator/utils.go:385-401 matches node-name.json to nodes)."""
    import json

    out = {}
    if not os.path.isdir(directory):
        return out
    for root, dirs, files in os.walk(directory):
        dirs.sort()
        for fname in sorted(files):
            if fname.endswith(".json"):
                with open(os.path.join(root, fname), "r", encoding="utf-8") as f:
                    out[os.path.splitext(fname)[0]] = json.load(f)
    return out


def load_cluster_from_directory(directory: str, strict: bool = True) -> ResourceTypes:
    """Traced wrapper — same 100ms LogIfLong as the live-cluster fetch."""
    from .trace import Span

    with Span("load cluster from directory", log_if_longer=0.1):
        return _load_cluster_from_directory(directory, strict)
