"""Fake-node factory for the capacity planner.

The port's own copy of `open_simulator_tpu/models/fakenode.py` (same names
from the same seed). Mirrors NewFakeNodes/NewFakeNode/MakeValidNodeByNode
(the reference's pkg/utils/utils.go:885-915,473-492): clone a template node N
times under `simon-<rand5>` names with the hostname label rewritten and the
`simon/new-node` marker label set.
"""

from __future__ import annotations

import copy
import random
from typing import List, Optional

from ..core import constants as C
from ..utils.validate import validate_node


def _rand5(rng: random.Random) -> str:
    # k8s rand.String uses lowercase alphanumerics minus confusables; close enough
    alphabet = "bcdfghjklmnpqrstvwxz2456789"
    return "".join(rng.choice(alphabet) for _ in range(5))


def make_valid_node_by_node(node: dict, nodename: str) -> dict:
    out = copy.deepcopy(node)
    md = out.setdefault("metadata", {})
    md["name"] = nodename
    # Quirk parity with MakeValidNodeByNode: the hostname label is only rewritten
    # when the template had a labels map at all (Go nil-map check, not emptiness).
    if md.get("labels") is None:
        md["labels"] = {}
    else:
        md["labels"][C.LabelHostname] = nodename
    if md.get("annotations") is None:
        md["annotations"] = {}
    md.pop("managedFields", None)
    validate_node(out)
    return out


def new_fake_nodes(
    node: Optional[dict], node_count: int, seed: Optional[int] = None
) -> List[dict]:
    """Clone `node` node_count times with fresh names. `seed` makes names
    deterministic (tests); default is time-seeded like the reference."""
    if node is None and node_count != 0:
        raise ValueError(
            "new node is nil when adding node to cluster, please check whether "
            "newNode in configuration file is empty"
        )
    rng = random.Random(seed)
    nodes = []
    taken = set()
    for _ in range(node_count):
        while True:
            hostname = f"{C.NewNodeNamePrefix}-{_rand5(rng)}"
            if hostname not in taken:
                taken.add(hostname)
                break
        valid = make_valid_node_by_node(node, hostname)
        valid["metadata"].setdefault("labels", {})[C.LabelNewNode] = ""
        nodes.append(valid)
    return nodes


def new_fake_node(node: Optional[dict]) -> dict:
    """Single fake node keeping its own name (server mode's NewNodes handling)."""
    if node is None:
        raise ValueError("new node is nil")
    valid = make_valid_node_by_node(node, (node.get("metadata") or {}).get("name", ""))
    valid["metadata"].setdefault("labels", {})[C.LabelNewNode] = ""
    return valid
