"""Local-storage annotation codec (the open-local data model).

Mirrors NodeStorage/Volume (reference pkg/utils/utils.go:510-525) and
open-local's SharedResource/ExclusiveResource (vendor/github.com/alibaba/open-local/
pkg/scheduler/algorithm/cache/types.go:39-70). The reference's Go structs use
`json:",string"` tags, so numbers and booleans arrive as strings
("capacity": "107374182400", "isAllocated": "false"); this codec accepts both.
"""

from __future__ import annotations

import json
from typing import List, Optional

from ..core import constants as C
from .objutil import annotations_of


def to_int(v, default: int = 0) -> int:
    if v is None:
        return default
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip()
    if not s:
        return default
    try:
        return int(float(s))
    except ValueError:
        return default


def to_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() == "true"


class VG:
    """A shared LVM volume group (open-local SharedResource)."""

    def __init__(self, name: str, capacity: int, requested: int = 0) -> None:
        self.name = name
        self.capacity = capacity
        self.requested = requested

    def to_json(self) -> dict:
        return {"name": self.name, "capacity": str(self.capacity),
                "requested": str(self.requested)}


class Device:
    """An exclusive block device (open-local ExclusiveResource)."""

    def __init__(self, device: str, capacity: int, media_type: str = "hdd",
                 is_allocated: bool = False, name: str = "") -> None:
        self.device = device
        self.name = name or device
        self.capacity = capacity
        self.media_type = media_type
        self.is_allocated = is_allocated

    def to_json(self) -> dict:
        return {"name": self.name, "device": self.device,
                "capacity": str(self.capacity), "mediaType": self.media_type,
                "isAllocated": str(self.is_allocated).lower()}


class NodeStorage:
    def __init__(self, vgs: Optional[List[VG]] = None,
                 devices: Optional[List[Device]] = None) -> None:
        self.vgs = vgs or []
        self.devices = devices or []

    @classmethod
    def from_json(cls, raw: str) -> "NodeStorage":
        data = json.loads(raw) or {}
        vgs = [
            VG(v.get("name", ""), to_int(v.get("capacity")), to_int(v.get("requested")))
            for v in data.get("vgs") or []
        ]
        devices = [
            Device(
                d.get("device", d.get("name", "")),
                to_int(d.get("capacity")),
                d.get("mediaType", "hdd"),
                to_bool(d.get("isAllocated")),
                d.get("name", ""),
            )
            for d in data.get("devices") or []
        ]
        return cls(vgs, devices)

    def to_json(self) -> str:
        return json.dumps(
            {"vgs": [v.to_json() for v in self.vgs],
             "devices": [d.to_json() for d in self.devices]}
        )


def get_node_storage(node: dict) -> Optional[NodeStorage]:
    """GetNodeStorage (utils.go:527-538): decode the node annotation, None if absent."""
    raw = annotations_of(node).get(C.AnnoNodeLocalStorage)
    if not raw:
        return None
    return NodeStorage.from_json(raw)


def set_node_storage(node: dict, storage: NodeStorage) -> None:
    node.setdefault("metadata", {}).setdefault("annotations", {})[
        C.AnnoNodeLocalStorage
    ] = storage.to_json()


class Volume:
    """A pod's local-storage volume request (utils.go:516-521)."""

    def __init__(self, size: int, kind: str, sc_name: str) -> None:
        self.size = size
        self.kind = kind  # "LVM" | "HDD" | "SSD"
        self.sc_name = sc_name


def get_pod_local_volumes(pod: dict) -> List[Volume]:
    """Decode the simon/pod-local-storage annotation's VolumeRequest."""
    raw = annotations_of(pod).get(C.AnnoPodLocalStorage)
    if not raw:
        return []
    data = json.loads(raw) or {}
    return [
        Volume(to_int(v.get("size")), v.get("kind", ""), v.get("scName", ""))
        for v in data.get("volumes") or []
    ]
