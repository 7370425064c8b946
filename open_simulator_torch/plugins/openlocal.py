"""Open-Local: LVM volume-group + exclusive-device local-storage simulation.

Mirrors reference pkg/simulator/plugin/open-local.go and the vendored
alibaba/open-local algorithms (vendor/.../scheduler/algorithm/algo/common.go):

- Pods carry a `simon/pod-local-storage` VolumeRequest annotation (synthesized from
  StatefulSet volumeClaimTemplates by SetStorageAnnotationOnPods, utils.go:249-292).
- Nodes carry `simon/node-local-storage` with VGs (shared, bytes) and Devices
  (exclusive, media-typed).
- Filter: every LVM volume must fit a VG (named VG exact, unnamed → Binpack
  tightest-fit by free space, common.go:59-130); every device volume needs a free
  device of its media type with enough capacity (ssd checked before hdd; volumes
  and devices matched in ascending size order, common.go:290-350,393-447).
- Score (Binpack strategy): LVM = avg over used VGs of used/capacity × 10;
  Device = avg over units of requested/allocated × 10; both ints, summed, then
  min-max normalized by the plugin's NormalizeScore (open-local.go:140-172).
- Bind: adds the allocations into the node annotation (open-local.go:175-254).

The batched engine evaluates filter+score as [N, MAXVG]/[N, MAXSDEV] tensor math
with the running requested/allocated state in the scan carry (ops/kernels.py);
this module owns the string world: volume parsing, SC resolution, the host ledger
that replays allocations for committed pods, and the annotation writeback.

Media type resolution follows the reference strictly: the StorageClass object's
`parameters.mediaType` decides ssd/hdd; volumes whose SC is missing or has no
(or an unrecognized) mediaType are silently dropped from the device checks — the
reference's demo_1 `sc-device-ssd.yaml` even ships a "sdd" typo relying on this.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..core import constants as C
from ..utils.objutil import name_of
from ..utils.storage import (
    NodeStorage,
    get_node_storage,
    get_pod_local_volumes,
    set_node_storage,
)

MAX_SCORE = 10  # open-local algo MaxScore (common.go:34)

LVM_SC_NAMES = (C.OpenLocalSCNameLVM, C.YodaSCNameLVM)


class OpenLocalVolume:
    """One volume demand, fully resolved: kind, size, vg name (may be ""), media."""

    def __init__(self, size: int, kind: str, sc_name: str, vg_name: str, media: str) -> None:
        self.size = size
        self.kind = kind          # "LVM" | "SSD" | "HDD" (annotation Kind)
        self.sc_name = sc_name
        self.vg_name = vg_name    # SC parameters.vgName, "" = unnamed (Binpack)
        self.media = media        # SC parameters.mediaType: "ssd" | "hdd" | ""


def resolve_pod_volumes(
    pod: dict, storage_classes: List[dict]
) -> Tuple[List[OpenLocalVolume], List[OpenLocalVolume]]:
    """(lvm_volumes, device_volumes) for a pod, in the reference's processing
    order. Routing follows GetPodLocalPVCs (utils.go:580-623) exactly: any volume
    whose Kind is LVM/HDD/SSD is accepted, and the LVM-vs-device split is by the
    STORAGE CLASS NAME (open-local-lvm / yoda-lvm-default → LVM; everything else →
    device, media from the SC object's parameters.mediaType, unknown media
    dropped). LVM: named-VG first then unnamed (input order, DivideLVMPVCs);
    devices: ssd-before-hdd, each ascending by size (ProcessDevicePVC +
    CheckExclusiveResourceMeetsPVCSize sorts)."""
    sc_map = {name_of(sc): sc for sc in storage_classes}
    lvm_named: List[OpenLocalVolume] = []
    lvm_unnamed: List[OpenLocalVolume] = []
    dev_ssd: List[OpenLocalVolume] = []
    dev_hdd: List[OpenLocalVolume] = []
    for vol in get_pod_local_volumes(pod):
        if vol.kind not in ("LVM", "HDD", "SSD"):
            continue  # unsupported kind, logged-and-skipped by the reference
        sc = sc_map.get(vol.sc_name)
        params = (sc or {}).get("parameters") or {}
        if vol.sc_name in LVM_SC_NAMES:
            v = OpenLocalVolume(vol.size, vol.kind, vol.sc_name, params.get("vgName", ""), "")
            (lvm_named if v.vg_name else lvm_unnamed).append(v)
        else:
            media = params.get("mediaType", "")
            v = OpenLocalVolume(vol.size, vol.kind, vol.sc_name, "", media)
            if media == "ssd":
                dev_ssd.append(v)
            elif media == "hdd":
                dev_hdd.append(v)
            # else: dropped, like DividePVCAccordingToMediaType with unknown media
    dev_ssd.sort(key=lambda v: v.size)
    dev_hdd.sort(key=lambda v: v.size)
    return lvm_named + lvm_unnamed, dev_ssd + dev_hdd


# ------------------------------------------------------------------ allocation ------


def allocate_lvm(
    vgs: List, volumes: List[OpenLocalVolume]
) -> Tuple[bool, List[Tuple[int, int]]]:
    """Sequentially place LVM volumes onto VGs. Returns (fits, [(vg_idx, size)]).
    Named VG → exact match; unnamed → Binpack: tightest fit by free space
    (ascending-free first-fit ≡ smallest free ≥ size; ties → lowest index)."""
    free = [vg.capacity - vg.requested for vg in vgs]
    units: List[Tuple[int, int]] = []
    for vol in volumes:
        if vol.vg_name:
            idx = next((i for i, vg in enumerate(vgs) if vg.name == vol.vg_name), -1)
            if idx < 0 or free[idx] < vol.size:
                return False, units
        else:
            cands = [i for i in range(len(vgs)) if free[i] >= vol.size and vgs[i].capacity > 0]
            if not cands:
                return False, units
            idx = min(cands, key=lambda i: (free[i], i))
        free[idx] -= vol.size
        units.append((idx, vol.size))
    return True, units


def allocate_devices(
    devices: List, volumes: List[OpenLocalVolume]
) -> Tuple[bool, List[Tuple[int, int]]]:
    """Match device volumes (pre-sorted ssd-asc then hdd-asc) to free devices of
    the same media type, reproducing ProcessDevicePVC +
    CheckExclusiveResourceMeetsPVCSize (common.go:290-350,393-447) INCLUDING its
    quirks:
    - per-media count pre-check: free devices < requested volumes → fail;
    - one merge pass over (devices asc-capacity, volumes asc-size): a volume fails
      the node only when the scan reaches the LAST device and it is too small;
    - when devices run out mid-scan (last device already consumed), the remaining
      volumes are silently dropped and the node still fits — a reference bug we
      keep for placement parity.
    Returns (fits, [(device_idx, size)])."""
    taken = [d.is_allocated for d in devices]
    units: List[Tuple[int, int]] = []
    for media in ("ssd", "hdd"):  # ssd processed before hdd (ProcessDevicePVC)
        vols = [v for v in volumes if v.media == media]
        if not vols:
            continue
        order = sorted(
            (i for i, d in enumerate(devices) if d.media_type == media and not taken[i]),
            key=lambda i: (devices[i].capacity, i),
        )
        if len(order) < len(vols):
            return False, units
        j = 0
        for vol in vols:
            assigned = False
            while j < len(order):
                idx = order[j]
                if devices[idx].capacity < vol.size:
                    if j == len(order) - 1:
                        return False, units
                    j += 1
                    continue
                taken[idx] = True
                units.append((idx, vol.size))
                j += 1
                assigned = True
                break
            if not assigned:
                break  # devices exhausted: rest silently dropped (reference bug)
    return True, units


def score_binpack(
    vgs: List, lvm_units: List[Tuple[int, int]],
    devices: List, dev_units: List[Tuple[int, int]],
) -> int:
    """ScoreLVM (Binpack) + ScoreDevice (common.go:660-724): integers, summed."""
    score = 0
    if lvm_units:
        used: Dict[int, int] = {}
        for idx, size in lvm_units:
            used[idx] = used.get(idx, 0) + size
        acc = sum(u / vgs[i].capacity for i, u in used.items() if vgs[i].capacity)
        score += int(acc / len(used) * MAX_SCORE)
    if dev_units:
        acc = sum(size / devices[i].capacity for i, size in dev_units if devices[i].capacity)
        score += int(acc / len(dev_units) * MAX_SCORE)
    return score


# ------------------------------------------------------------------ host ledger -----


class OpenLocalHost:
    """Host half: per-node NodeStorage ledgers; replays Bind for committed pods."""

    def __init__(self, nodes: List[dict]) -> None:
        self.nodes = nodes
        store = getattr(nodes, "store", None)  # simulator/store.py LazyNodeSeq
        if store is not None and not store.may_have_local_storage:
            # columnar fast path: no block template carries the node-local-
            # storage annotation — skip the N-dict materializing scan
            self.states: List[Optional[NodeStorage]] = [None] * len(nodes)
        else:
            self.states = [get_node_storage(n) for n in nodes]
        self.vg_names: Dict[str, int] = {}  # name -> id (1-based; 0 = unnamed)
        for st in self.states:
            if st:
                for vg in st.vgs:
                    self.vg_names.setdefault(vg.name, len(self.vg_names) + 1)
        self.max_vgs = max((len(st.vgs) for st in self.states if st), default=0)
        self.max_devs = max((len(st.devices) for st in self.states if st), default=0)
        # id(pod) → (node_i, lvm_units, dev_units): the exact units reserve()
        # granted, so a preemption eviction can release precisely those
        self._alloc: Dict[int, tuple] = {}

    @property
    def enabled(self) -> bool:
        return self.max_vgs > 0 or self.max_devs > 0

    def vg_name_id(self, name: str) -> int:
        return self.vg_names.setdefault(name, len(self.vg_names) + 1)

    def reserve(self, pod: dict, node_i: int, storage_classes: List[dict]) -> bool:
        """The Bind writeback (open-local.go:215-250): allocate, bump VG requested,
        mark devices allocated, refresh the node annotation."""
        lvm, dev = resolve_pod_volumes(pod, storage_classes)
        if not lvm and not dev:
            return False
        state = self.states[node_i]
        if state is None:
            return False
        ok_l, lvm_units = allocate_lvm(state.vgs, lvm)
        ok_d, dev_units = allocate_devices(state.devices, dev)
        if not (ok_l and ok_d):
            # The kernel filter (f32) admitted a placement the exact-integer host
            # allocator rejects — possible only at f32 precision edges (~16KiB at
            # 100Gi scales). Surface it: a silent skip would desync the node
            # annotation from the device-side carry.
            logging.warning(
                "open-local: host allocation failed for committed pod %s on node %s "
                "(f32/int precision edge); node annotation left unchanged",
                name_of(pod), name_of(self.nodes[node_i]),
            )
            return False
        for idx, size in lvm_units:
            state.vgs[idx].requested += size
        for idx, _ in dev_units:
            state.devices[idx].is_allocated = True
        self._alloc[id(pod)] = (node_i, lvm_units, dev_units)
        set_node_storage(self.nodes[node_i], state)
        return True

    def release(self, pod: dict, node_i: int) -> None:
        """Undo reserve() for one pod (preemption eviction), returning exactly
        the units it was granted. No reference analog (see gpushare.release)."""
        rec = self._alloc.pop(id(pod), None)
        if rec is None or rec[0] != node_i:
            return
        state = self.states[node_i]
        if state is None:
            return
        for idx, size in rec[1]:
            state.vgs[idx].requested -= size
        for idx, _ in rec[2]:
            state.devices[idx].is_allocated = False
        set_node_storage(self.nodes[node_i], state)

    def snapshot(self):
        """Copy of VG/device ledgers + the node annotation this plugin owns."""
        from ..utils.objutil import annotations_of

        states = []
        for st, node in zip(self.states, self.nodes):
            if st is None:
                states.append(None)
                continue
            states.append((
                [vg.requested for vg in st.vgs],
                [d.is_allocated for d in st.devices],
                annotations_of(node).get(C.AnnoNodeLocalStorage),
            ))
        return states, dict(self._alloc)

    def restore(self, snap) -> None:
        states, self._alloc = snap[0], dict(snap[1])
        for st, node, rec in zip(self.states, self.nodes, states):
            if st is None or rec is None:
                continue
            for vg, req in zip(st.vgs, rec[0]):
                vg.requested = req
            for d, alloc in zip(st.devices, rec[1]):
                d.is_allocated = alloc
            anns = node.setdefault("metadata", {}).setdefault("annotations", {})
            if rec[2] is None:
                anns.pop(C.AnnoNodeLocalStorage, None)
            else:
                anns[C.AnnoNodeLocalStorage] = rec[2]

    # ---- tensorization ---------------------------------------------------------

    def vg_matrices(self, max_vgs: int):
        import numpy as np

        N = len(self.states)
        cap = np.zeros((N, max_vgs), np.float32)
        nid = np.zeros((N, max_vgs), np.int32)
        req = np.zeros((N, max_vgs), np.float32)
        for i, st in enumerate(self.states):
            if not st:
                continue
            for j, vg in enumerate(st.vgs[:max_vgs]):
                cap[i, j] = vg.capacity
                nid[i, j] = self.vg_name_id(vg.name)
                req[i, j] = vg.requested
        return cap, nid, req

    def device_matrices(self, max_devs: int):
        import numpy as np

        N = len(self.states)
        cap = np.zeros((N, max_devs), np.float32)
        media = np.zeros((N, max_devs), np.int32)  # 0 none, 1 hdd, 2 ssd
        alloc = np.zeros((N, max_devs), bool)
        for i, st in enumerate(self.states):
            if not st:
                continue
            for j, d in enumerate(st.devices[:max_devs]):
                cap[i, j] = d.capacity
                media[i, j] = 2 if d.media_type == "ssd" else (1 if d.media_type == "hdd" else 0)
                alloc[i, j] = d.is_allocated
        return cap, media, alloc
