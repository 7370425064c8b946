"""Encoded tables past the default kernel build's fixed axes.

The default build of the hand kernels holds a group's term slots in arrays of
64 (ops/kernels.py MAX_SLOTS), a node's GPU devices, volume groups and storage
devices in arrays of 32 (MAX_NODE_DEVS) and the affinity kernels' candidate
key in 32 bits (domains up to AFFINITY_MAX_D1 = 2^21); a table past one of
them runs in the wide build. `widen(bt, axis, width)` makes such a table from
an encoded BatchTables of either package (the two share their field names):

- a slot or node-device axis gets inert entries IN FRONT of the real ones
  (the encoder's own fills: -1 term ids, 0 weights, ports, sizes and
  capacities, maxSkew 1, no eligible domain), so that every real term or
  device sits at an index past the default build's cap;
- the domain axis gets empty domains between the real ones and the sentinel,
  which moves to the new last column (the encoder's `pad_encoder_axes` rule:
  every `*_dom` entry at the old sentinel moves with it).

Neither changes what the JAX package computes on the table apart from the
device numbering; both packages get the same widened table.
"""

from __future__ import annotations

import copy

import numpy as np

# axis -> [(BatchTables field, its axis, fill)]
SLOT_FIELDS = {
    "A": [("req_aff_t", 1, -1)],
    "B": [("req_anti_t", 1, -1)],
    "Cp": [("pref_t", 1, -1), ("pref_w", 1, 0.0)],
    "Sd": [("dns_t", 1, -1), ("dns_maxskew", 1, 1.0), ("dns_self", 1, 0.0),
           ("dns_edom", 1, False)],
    "Ss": [("sa_t", 1, -1), ("sa_maxskew", 1, 1.0), ("sa_self", 1, 0.0)],
    "Ca": [("carr_anti_t", 1, -1)],
    "Cw": [("carr_w_t", 1, -1), ("carr_w_w", 1, 0.0)],
    "PP": [("grp_ports", 1, 0)],
    "SL": [("grp_lvm_size", 1, 0.0), ("grp_lvm_vg", 1, 0)],
    "SD": [("grp_sdev_size", 1, 0.0), ("grp_sdev_media", 1, 0)],
}
DEVICE_FIELDS = {
    "MAXDEV": [("grp_gpu_take", 1, 0.0), ("dev_total", 1, 0.0), ("seed_dev_used", 1, 0.0)],
    "MAXVG": [("vg_cap", 1, 0.0), ("vg_nameid", 1, 0), ("seed_vg_req", 1, 0.0)],
    "MAXSD": [("sdev_cap", 1, 0.0), ("sdev_media", 1, 0), ("seed_sdev_alloc", 1, 0.0)],
}
AXES = tuple(SLOT_FIELDS) + tuple(DEVICE_FIELDS) + ("D1",)
DOMAIN_MAPS = ("counter_dom", "topo_dom", "carr_dom")
DOMAIN_ROWS = ("seed_counter", "seed_carrier", "dns_edom")


def width_of(bt, axis: str) -> int:
    """The axis' width in bt."""
    if axis == "D1":
        return int(bt.seed_counter.shape[1])
    field, ax, _ = (SLOT_FIELDS.get(axis) or DEVICE_FIELDS[axis])[0]
    return int(getattr(bt, field).shape[ax])


def _prepend(a: np.ndarray, ax: int, k: int, fill) -> np.ndarray:
    shape = list(a.shape)
    shape[ax] = k
    return np.concatenate([np.full(shape, fill, a.dtype), a], axis=ax)


def widen(bt, axis: str, width: int):
    """A copy of bt whose `axis` holds max(width, its own) entries."""
    have = width_of(bt, axis)
    out = copy.copy(bt)
    if width <= have:
        return out
    if axis == "D1":
        D, Dn = have - 1, width - 1
        for f in DOMAIN_MAPS:
            a = getattr(bt, f)
            setattr(out, f, np.where(a == D, Dn, a).astype(a.dtype))
        for f in DOMAIN_ROWS:
            a = getattr(bt, f)
            w = np.zeros(a.shape[:-1] + (width,), a.dtype)
            w[..., :D] = a[..., :D]
            w[..., Dn] = a[..., D]
            setattr(out, f, w)
        return out
    for f, ax, fill in (SLOT_FIELDS.get(axis) or DEVICE_FIELDS[axis]):
        setattr(out, f, _prepend(getattr(bt, f), ax, width - have, fill))
    return out


def widen_all(bt, widths: dict):
    """widen() on every axis of `widths` ({axis: width})."""
    for axis, width in widths.items():
        bt = widen(bt, axis, width)
    return bt
