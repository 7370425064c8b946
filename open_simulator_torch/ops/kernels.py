"""Device kernels of the serial scheduling route, in PyTorch and CUDA.

Port of `open_simulator_tpu/ops/kernels.py` (the jitted `schedule_batch` scan
and the `feasibility_jit` diagnostic). One scan step is one scheduleOne cycle
of the vendored scheduler: filter every node, score the feasible ones with the
v1.20 default plugin set plus the Simon bin-packing plugin, pick the winner
(highest score, lowest node index among ties), commit it into the carry.

Two implementations of each kernel live here:

- the plain PyTorch functions (`feasibility`, `score_components`, `scores`,
  `commit`, `step`, `schedule_batch_plain`), which mirror the JAX expressions
  operation for operation, so that every floor sees the same f32 input; they
  are the CPU path and the oracle for the hand-written kernels;
- the wrappers `feasibility_jit` and `schedule_batch`, which take the plain
  version for tensors on the CPU and launch the CUDA kernels of
  `csrc/schedule.cu` for tensors on the card (never the plain version there,
  and no fallback: a failed build or launch raises). Each wrapper counts its
  launches in its `launches` attribute.

The xray flight recorder's diagnostic `explain_jit` (JAX `explain_pod` /
`explain_jit`) follows the same pattern: the plain `explain_pod`, K7
(`csrc/explain.cu`) on the card.

Numerical contract (shared with csrc/schedule.cu): every f32 operation is
done separately and in the JAX expression's order (no fused multiply-add);
sums over the small slot axes (and over a node's GPU devices and volume
groups) run left to right from 0; `log` is taken in f64 and rounded once to
f32. The GPU-share and Open-Local branches (`enable_gpu`, `enable_storage`,
`gpu_live`) are runtime arguments: off, they cost nothing.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cluster import SMEM_MAX, STATS_WORDS, choose, choose_cached
from .resources import CPU_I, MEM_I


class ScoreWeights(NamedTuple):
    """Per-score-plugin weights, default = the v1.20 provider registry
    (registry.go:118-137; Simon/OpenLocal/GpuShare default to weight 1 via
    the framework's zero->1 rule for enabled score plugins). A disabled score
    plugin is weight 0."""

    least: float = 1.0       # NodeResourcesLeastAllocated
    balanced: float = 1.0    # NodeResourcesBalancedAllocation
    image: float = 1.0       # ImageLocality
    interpod: float = 1.0    # InterPodAffinity
    nodeaff: float = 1.0     # NodeAffinity
    avoid: float = 10000.0   # NodePreferAvoidPods
    pts: float = 2.0         # PodTopologySpread
    taint: float = 1.0       # TaintToleration
    ss: float = 1.0          # SelectorSpread
    simon: float = 1.0       # Simon bin-packing
    # Open-Gpu-Share's Score is Simon's formula: its term is a second Simon
    # term with its own weight.
    gpushare: float = 1.0
    openlocal: float = 1.0   # Open-Local


class FilterFlags(NamedTuple):
    """Enable flags for the filter plugins evaluated inside the kernel (the
    statically-folded ones — taints/unschedulable/node-affinity — are
    disabled at encode time instead)."""

    fit: bool = True         # NodeResourcesFit
    ports: bool = True       # NodePorts
    interpod: bool = True    # InterPodAffinity
    spread: bool = True      # PodTopologySpread


DEFAULT_WEIGHTS = ScoreWeights()
DEFAULT_FILTERS = FilterFlags()

_F32 = torch.float32


class Tables(NamedTuple):
    """Scan-invariant device tables (see encode.BatchTables for field docs);
    same fields and dtypes as the JAX package's `Tables`."""

    alloc: torch.Tensor
    node_zone: torch.Tensor
    static_mask: torch.Tensor
    mask_taint: torch.Tensor
    mask_unsched: torch.Tensor
    mask_aff: torch.Tensor
    mask_extra: torch.Tensor  # [G, N] bool: out-of-tree plugin filters (static)
    simon_raw: torch.Tensor
    nodeaff_raw: torch.Tensor
    taint_raw: torch.Tensor
    avoid_raw: torch.Tensor
    image_raw: torch.Tensor
    extra_raw: torch.Tensor  # [G, N] f32: out-of-tree plugin score sum (static)
    grp_requests: torch.Tensor
    grp_nonzero: torch.Tensor
    grp_unknown: torch.Tensor
    grp_ports: torch.Tensor
    counter_dom: torch.Tensor
    counter_topo: torch.Tensor  # [T] i32: unique-topology row id per counter
    topo_dom: torch.Tensor      # [U, N] i32: node→domain per unique topology key
    counter_sel_match_g: torch.Tensor
    req_aff_t: torch.Tensor
    grp_aff_self: torch.Tensor
    req_anti_t: torch.Tensor
    pref_t: torch.Tensor
    pref_w: torch.Tensor
    dns_t: torch.Tensor
    dns_maxskew: torch.Tensor
    dns_self: torch.Tensor
    dns_edom: torch.Tensor
    sa_t: torch.Tensor
    sa_maxskew: torch.Tensor
    sa_self: torch.Tensor
    ss_t: torch.Tensor
    ss_skip: torch.Tensor
    carr_dom: torch.Tensor
    carr_topo: torch.Tensor    # [Tc] i32: unique-topology row id per carrier
    carr_anti_t: torch.Tensor  # [G, Ca] i32: anti-use carrier ids matching g (-1 pad)
    carr_w_t: torch.Tensor     # [G, Cw] i32: carrier ids with interpod weight for g
    carr_w_w: torch.Tensor     # [G, Cw] f32: those weights (hard=1 / signed pref)
    grp_carries: torch.Tensor
    # GPU-share (open-gpu-share.go Filter; per-device ledger in the carry)
    grp_gpu_mem: torch.Tensor   # [G] f32: per-GPU memory request (0 = no GPU)
    grp_gpu_num: torch.Tensor   # [G] f32: number of GPUs requested
    grp_gpu_pre: torch.Tensor   # [G] bool: valid pre-assigned gpu-index present
    grp_gpu_take: torch.Tensor  # [G, MAXDEV] f32: unit counts per device when pre-assigned
    dev_total: torch.Tensor     # [N, MAXDEV] f32: per-device total memory (0 = absent)
    # Open-Local storage (plugins/openlocal.py; VG/device state in the carry)
    grp_lvm_size: torch.Tensor   # [G, SL] f32: LVM volume sizes (0 = unused slot)
    grp_lvm_vg: torch.Tensor     # [G, SL] i32: VG name id (0 = unnamed -> Binpack)
    grp_sdev_size: torch.Tensor  # [G, SD] f32: device volume sizes
    grp_sdev_media: torch.Tensor  # [G, SD] i32: 1 hdd / 2 ssd (0 = unused)
    vg_cap: torch.Tensor         # [N, MAXVG] f32 (0 = absent VG)
    vg_nameid: torch.Tensor      # [N, MAXVG] i32
    sdev_cap: torch.Tensor       # [N, MAXSD] f32
    sdev_media: torch.Tensor     # [N, MAXSD] i32


class Carry(NamedTuple):
    """Mutable cluster state threaded through the scan."""

    requested: torch.Tensor    # [N, R] f32
    nonzero: torch.Tensor      # [N, 2] f32
    port_used: torch.Tensor    # [N, PORT+1] bool
    counter: torch.Tensor      # [T, D+1] f32
    carrier: torch.Tensor      # [Tc, D+1] f32
    dev_used: torch.Tensor     # [N, MAXDEV] f32
    vg_req: torch.Tensor       # [N, MAXVG] f32
    sdev_alloc: torch.Tensor   # [N, MAXSD] f32


class SerialState(NamedTuple):
    """The only state a single-group serial run mutates (the JAX
    `SerialState` of schedule_group_serial); the plain scan updates it in
    place."""

    j: torch.Tensor       # [N] i32: per-node copies placed so far
    cnt: torch.Tensor     # [Sd, D+1] f32: live DoNotSchedule counter rows
    cnt_sa: torch.Tensor  # [Ss, D+1] f32: live ScheduleAnyway counter rows


_SEED_OF = {f: "seed_" + f for f in Carry._fields}


def _to_tensor(a, device) -> torch.Tensor:
    """A copy of numpy array `a` on `device` (same dtype; the port may
    update staged state in place, so it never aliases the caller's array)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def tables_from_batch(bt, device) -> Tables:
    """Tables from a numpy BatchTables, field by field BY NAME (the port's
    counterpart of parallel/mesh.py tables_from_batch + engine _to_device)."""
    return Tables(**{f: _to_tensor(getattr(bt, f), device) for f in Tables._fields})


def carry_from_batch(bt, device) -> Carry:
    """The batch's seed carry (BatchTables.seed_*) as tensors."""
    return Carry(**{f: _to_tensor(getattr(bt, s), device) for f, s in _SEED_OF.items()})


def carry_from_numpy(arrays: Dict[str, np.ndarray], device) -> Carry:
    """A carry from a {field: numpy array} mapping — e.g. a JAX `Carry`
    fetched as numpy (`{k: np.asarray(v) for k, v in carry._asdict()}`)."""
    return Carry(**{f: _to_tensor(np.asarray(arrays[f]), device) for f in Carry._fields})


def _flr(x):
    return torch.floor(x)


def _slot_ids(row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(validity mask, clamped long ids) for one group's slot row (-1 = pad)."""
    return (row >= 0), row.clamp(min=0).long()


def counter_rows_at(tb: Tables, cry: Carry, ids: torch.Tensor):
    """Gather counter rows by slot ids: (rows [k, D+1], per-node values
    [k, N], key_present [k, N], dom [k, N]). `dom == D` is the key-absent
    sentinel column."""
    rows = cry.counter[ids]
    dom = tb.counter_dom[ids].long()
    D = cry.counter.shape[1] - 1
    return rows, torch.gather(rows, 1, dom), dom < D, dom


def carrier_rows_at(tb: Tables, cry: Carry, ids: torch.Tensor) -> torch.Tensor:
    return torch.gather(cry.carrier[ids], 1, tb.carr_dom[ids].long())


def _masked_sum(valid: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """sum over axis 0 of where(valid[:, None], vals, 0), added left to right
    from 0 (the order the JAX reduction uses and csrc/schedule.cu repeats)."""
    acc = torch.zeros(vals.shape[1:], dtype=vals.dtype, device=vals.device)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for k in range(vals.shape[0]):
        acc = acc + torch.where(valid[k], vals[k], zero)
    return acc


def least_balanced(used_c, used_m, a_c, a_m):
    """NodeResourcesLeastAllocated (least_allocated.go:93-115, integer
    divisions floored) + NodeResourcesBalancedAllocation
    (balanced_allocation.go:96-120)."""
    def least_one(u, a):
        return torch.where((a > 0) & (u <= a), _flr((a - u) * 100.0 / a), 0.0)

    least = _flr((least_one(used_c, a_c) + least_one(used_m, a_m)) / 2.0)
    cf = torch.where(a_c > 0, used_c / a_c, 1.0)
    mf = torch.where(a_m > 0, used_m / a_m, 1.0)
    balanced = torch.where((cf >= 1.0) | (mf >= 1.0), 0.0,
                           _flr((1.0 - torch.abs(cf - mf)) * 100.0))
    return least, balanced


def _zone_sums(pernode, F, zones, Z: int) -> torch.Tensor:
    """SelectorSpread's [Z] per-zone sums of the per-node counts over F
    (integer-valued f32: exact in any order)."""
    return torch.zeros(Z, dtype=_F32, device=pernode.device).index_add_(
        0, zones.long(), torch.where(F, pernode, 0.0))


def _selector_spread_blend(pernode, zones, zone_sums, have_zones, maxN):
    """SelectorSpread's per-node count score blended 2/3 with the zone score
    on a zoned node of a zoned feasible set; unfloored."""
    node_score = torch.where(maxN > 0, 100.0 * (maxN - pernode) / maxN, 100.0)
    maxZ = torch.max(torch.cat([zone_sums.new_zeros(1), zone_sums[1:]]))
    zscore = torch.where(maxZ > 0, 100.0 * (maxZ - zone_sums[zones.long()]) / maxZ, 100.0)
    return torch.where(have_zones & (zones > 0),
                       node_score * (1.0 / 3.0) + zscore * (2.0 / 3.0), node_score)


def selector_spread_score(pernode, F, zones, Z: int, maxN):
    """SelectorSpread (selector_spread.go:104-160): per-node count score with
    2/3 zone blending over the feasible set F; unfloored."""
    return _selector_spread_blend(pernode, zones, _zone_sums(pernode, F, zones, Z),
                                  torch.any(F & (zones > 0)), maxN)


def topology_weight(topo_size: torch.Tensor) -> torch.Tensor:
    """ln(topology size + 2), taken in f64 and rounded once to f32 (the
    kernel does the same with the device's f64 log)."""
    return torch.log((topo_size + 2.0).double()).float()


def _sa_marks(relevantF, dom_rows, D: int) -> torch.Tensor:
    """ScheduleAnyway's [Ss, D+1] domain marks: 1 where a relevant node of
    the term's topology lies (the sentinel column D included)."""
    Ss = dom_rows.shape[0]
    marks = torch.zeros((Ss, D + 1), dtype=_F32, device=relevantF.device)
    return marks.scatter_reduce_(1, dom_rows, relevantF.to(_F32).expand(Ss, -1).contiguous(),
                                 reduce="amax")


def _sa_raw(cnt_sa, marks, svalid, maxskew) -> torch.Tensor:
    """ScheduleAnyway's raw per-node score, weighted by ln(topology size + 2)
    of every term (the marked domains but the sentinel)."""
    D = marks.shape[1] - 1
    tpw = topology_weight(torch.sum(marks[:, :D], dim=1))
    contrib = cnt_sa * tpw[:, None] + (maxskew[:, None] - 1.0)
    return _flr(_masked_sum(svalid, contrib))


def _sa_partials(sa_raw, relevantF) -> torch.Tensor:
    """[max, max of the negated] raw score over the relevant nodes (-inf
    where there is none): the min rides negated."""
    ninf = float("-inf")
    return torch.stack([torch.amax(torch.where(relevantF, sa_raw, ninf)),
                        torch.amax(torch.where(relevantF, -sa_raw, ninf))])


def _sa_normalized(sa_raw, relevantF, red) -> torch.Tensor:
    """ScheduleAnyway's normalized score from the reduced `_sa_partials`."""
    sa_max = torch.clamp(red[0], min=0.0)
    sa_min_raw = -red[1]
    sa_min = torch.where(torch.isfinite(sa_min_raw), sa_min_raw, 0.0)
    return torch.where(
        ~relevantF, 0.0,
        torch.where(sa_max > 0, _flr((sa_max + sa_min - sa_raw) * 100.0 / sa_max), 100.0))


def schedule_anyway_score(cnt_sa, relevantF, dom_rows, svalid, maxskew, D: int):
    """PodTopologySpread ScheduleAnyway scoring (scoring.go:108-200)."""
    sa_raw = _sa_raw(cnt_sa, _sa_marks(relevantF, dom_rows, D), svalid, maxskew)
    return _sa_normalized(sa_raw, relevantF, _sa_partials(sa_raw, relevantF))


def interpod_raw(tb: Tables, cry: Carry, g: int) -> torch.Tensor:
    """InterPodAffinity raw score (scoring.go): incoming preferred terms plus
    existing pods' required (HardPodAffinityWeight=1) and preferred terms."""
    pvalid, pids = _slot_ids(tb.pref_t[g])
    _, pref_at, _, _ = counter_rows_at(tb, cry, pids)
    ip_raw = _masked_sum(pvalid, tb.pref_w[g][:, None] * pref_at)
    cw_valid, cw_ids = _slot_ids(tb.carr_w_t[g])
    cw_at = carrier_rows_at(tb, cry, cw_ids)
    return ip_raw + _masked_sum(cw_valid, tb.carr_w_w[g][:, None] * cw_at)


def _sum_left(vals: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, added left to right from 0 (the order the
    kernels use over a node's GPU devices and volume groups)."""
    acc = torch.zeros(vals.shape[:-1], dtype=vals.dtype, device=vals.device)
    for k in range(vals.shape[-1]):
        acc = acc + vals[..., k]
    return acc


def storage_alloc(tb: Tables, cry: Carry, g: int) -> dict:
    """Open-Local allocation of group g's volumes on every node at once (JAX
    `storage_alloc` :274): LVM volumes in slot order (a named VG exactly, an
    unnamed one by Binpack: the tightest VG that fits, lowest index on
    ties), then device volumes (the smallest free device of the media type
    that fits), with the reference's quirks kept: a per-media count
    pre-check, a volume fails the node only when the last free device is
    too small, and volumes past a consumed last device are dropped
    silently. Returns {ok [N] bool, lvm_add [N, MAXVG], dev_add [N, MAXSD],
    raw [N] f32 (Binpack LVM + device score), has_storage}. A slot with no
    volume changes nothing, so it is skipped."""
    N, V = tb.vg_cap.shape
    Dv = tb.sdev_cap.shape[1]
    dev = tb.vg_cap.device
    inf = torch.tensor(float("inf"), device=dev)
    iota_v = torch.arange(V, device=dev)
    iota_d = torch.arange(Dv, device=dev)
    lvm_sizes = tb.grp_lvm_size[g].tolist()
    lvm_vgs = tb.grp_lvm_vg[g].tolist()
    dev_sizes = tb.grp_sdev_size[g].tolist()
    dev_media = tb.grp_sdev_media[g].tolist()
    has_lvm = any(s > 0 for s in lvm_sizes)
    has_dev = any(s > 0 for s in dev_sizes)

    ok = torch.ones(N, dtype=torch.bool, device=dev)
    lvm_add = torch.zeros((N, V), dtype=_F32, device=dev)
    for size, nid in zip(lvm_sizes, lvm_vgs):
        if not size > 0:
            continue
        size = tb.grp_lvm_size.new_tensor(size)
        free = tb.vg_cap - (cry.vg_req + lvm_add)
        if nid > 0:  # named VG: the first VG of that name
            slot_named = tb.vg_nameid == nid
            fit = torch.any(slot_named & (free >= size), dim=1)
            tgt = torch.argmax(slot_named.to(torch.int32), dim=1)
        else:  # Binpack: the tightest VG that fits
            cand = (tb.vg_cap > 0) & (free >= size)
            fit = torch.any(cand, dim=1)
            tgt = torch.argmin(torch.where(cand, free, inf), dim=1)
        take = (iota_v[None, :] == tgt[:, None]).to(_F32)
        lvm_add = lvm_add + take * size * fit[:, None].to(_F32)
        ok = ok & fit

    # devices: CheckExclusiveResourceMeetsPVCSize's single merge pass
    free_start, last_idx = {}, {}
    for m in (1, 2):
        fs = (tb.sdev_media == m) & (cry.sdev_alloc < 0.5) & (tb.sdev_cap > 0)
        free_start[m] = fs
        maxcap = torch.amax(torch.where(fs, tb.sdev_cap, -1.0), dim=1, keepdim=True)
        is_max = fs & (tb.sdev_cap == maxcap)
        # "last" in the ascending (capacity, index) order: the highest index
        # among the maxima, 0 when no device is free
        last_idx[m] = torch.argmax(is_max.to(torch.int64) * (iota_d[None, :] + 1), dim=1)
        n_vols = sum(1 for s, md in zip(dev_sizes, dev_media) if md == m and s > 0)
        if n_vols:
            ok = ok & (fs.sum(dim=1) >= n_vols)
    dev_add = torch.zeros((N, Dv), dtype=_F32, device=dev)
    dev_acc = torch.zeros(N, dtype=_F32, device=dev)
    dev_units = torch.zeros(N, dtype=_F32, device=dev)
    for size, media in zip(dev_sizes, dev_media):
        if not size > 0:
            continue
        size = tb.grp_sdev_size.new_tensor(size)
        m = 2 if media == 2 else 1
        free_now = free_start[m] & (dev_add < 0.5)
        fit_mask = free_now & (tb.sdev_cap >= size)
        fit = torch.any(fit_mask, dim=1)
        tgt = torch.argmin(torch.where(fit_mask, tb.sdev_cap, inf), dim=1)
        take = (iota_d[None, :] == tgt[:, None]).to(_F32) * fit[:, None].to(_F32)
        dev_add = dev_add + take
        last_free = torch.gather(free_now, 1, last_idx[m][:, None])[:, 0]
        ok = ok & ~(~fit & last_free)
        chosen_cap = torch.sum(take * tb.sdev_cap, dim=1)  # one nonzero term: exact
        dev_acc = dev_acc + torch.where(fit, size / torch.clamp(chosen_cap, min=1.0), 0.0)
        dev_units = dev_units + fit.to(_F32)

    # ScoreLVM (Binpack): mean over the used VGs of used/capacity x 10, floored
    used = lvm_add > 0
    vg_frac = torch.where(used & (tb.vg_cap > 0), lvm_add / torch.clamp(tb.vg_cap, min=1.0), 0.0)
    n_used = used.sum(dim=1).to(_F32)
    zero = torch.zeros(N, dtype=_F32, device=dev)
    lvm_raw = (torch.where(n_used > 0, _flr(_sum_left(vg_frac) / torch.clamp(n_used, min=1.0)
                                            * 10.0), 0.0) if has_lvm else zero)
    dev_raw = (torch.where(dev_units > 0, _flr(dev_acc / torch.clamp(dev_units, min=1.0) * 10.0),
                           0.0) if has_dev else zero)
    has_storage = has_lvm or has_dev
    return {"ok": ok if has_storage else torch.ones_like(ok), "lvm_add": lvm_add,
            "dev_add": dev_add, "raw": lvm_raw + dev_raw, "has_storage": has_storage}


def _gpu_units(dev_total: torch.Tensor, dev_used: torch.Tensor, safe_mem) -> torch.Tensor:
    """Whole units of `safe_mem` each device still holds (0 off a device)."""
    idle = dev_total - dev_used
    return torch.clamp(torch.where(dev_total > 0, torch.floor(idle / safe_mem), 0.0), min=0.0)


def _gpu_take(dev_total: torch.Tensor, dev_used: torch.Tensor, gmem, gnum, safe_mem,
              single: bool) -> torch.Tensor:
    """AllocateGpuId (gpunodeinfo.go:232-290) on rows [..., MAXDEV]: units per
    device for one copy. One GPU: the tightest device that fits (lowest
    index on ties, index 0 when none fits); several: the first `gnum` units
    in device order, several units may share a device."""
    if single:
        idle = dev_total - dev_used
        fit_dev = (idle >= gmem) & (dev_total > 0)
        cand = torch.argmin(torch.where(fit_dev, idle, float("inf")), dim=-1)
        iota = torch.arange(dev_total.shape[-1], device=dev_total.device)
        return (iota == cand.unsqueeze(-1)).to(_F32)
    units = _gpu_units(dev_total, dev_used, safe_mem)
    cum = torch.cumsum(units, dim=-1)  # whole numbers: exact in any order
    return torch.minimum(torch.clamp(gnum - (cum - units), min=0.0), units)


STAGE_KEYS = ("static", "taint", "unsched", "affinity", "extra", "fit", "fit_each",
              "ports", "pod_affinity", "pod_anti", "spread", "gpu", "storage")
# the [N] stage masks in the order the CUDA kernel writes its [12, N] rows
STAGE_ROWS = tuple(k for k in STAGE_KEYS if k != "fit_each")


def feasibility(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                filters: FilterFlags = DEFAULT_FILTERS, include_dns: bool = True,
                include_interpod: bool = True, enable_gpu: bool = False,
                enable_storage: bool = False):
    """[N] feasibility mask for one pod, plus the named per-stage masks
    (STAGE_KEYS) for diagnostics. Plain version of `feasibility_kernel`.
    `include_dns=False` drops the DoNotSchedule filter: the group-serial scan
    evaluates it against its own live counter rows. `include_interpod=False`
    drops the InterPodAffinity filters likewise: the affinity wave evaluates
    them each epoch from its live rows. `enable_gpu` / `enable_storage` turn
    on the GPU-share and Open-Local filters (the engine passes
    `plugin_flags(bt)`: on for a batch with such demand); off, their stages
    are all true."""
    N, R = tb.alloc.shape
    dev = tb.alloc.device
    req = tb.grp_requests[g]
    smask = tb.static_mask[g]
    ones = torch.ones(N, dtype=torch.bool, device=dev)

    # NodeResourcesFit (noderesources/fit.go): only requested resources are checked.
    if filters.fit:
        eps = tb.alloc * 1e-6  # absorb f32 noise; never enough to overcommit
        new_req = cry.requested + req[None, :]
        fit_each = (new_req <= tb.alloc + eps) | (req[None, :] == 0)
        fit = torch.all(fit_each, dim=1) & ~tb.grp_unknown[g]
    else:
        fit_each = torch.ones((N, R), dtype=torch.bool, device=dev)
        fit = ones

    if filters.ports:
        pids = tb.grp_ports[g].long()
        conflict = torch.any(cry.port_used[:, pids] & (pids > 0)[None, :], dim=1)
    else:
        conflict = ~ones

    if include_interpod and filters.interpod:
        D = cry.counter.shape[1] - 1
        # required affinity (filtering.go satisfyPodAffinity)
        avalid, aids = _slot_ids(tb.req_aff_t[g])
        aff_rows, aff_at, aff_key, _ = counter_rows_at(tb, cry, aids)
        sat = (aff_key & (aff_at > 0)) | ~avalid[:, None]
        aff_all = torch.all(sat, dim=0)
        has_aff = torch.any(avalid)
        totals_aff = torch.sum(aff_rows[:, :D], dim=1)
        total_aff = torch.sum(torch.where(avalid, totals_aff, 0.0))
        bootstrap = has_aff & (total_aff == 0.0) & tb.grp_aff_self[g]
        aff_ok = torch.where(bootstrap, ones, aff_all)
        # incoming required anti-affinity (satisfyPodAntiAffinity)
        bvalid, bids = _slot_ids(tb.req_anti_t[g])
        _, anti_at, _, _ = counter_rows_at(tb, cry, bids)
        blocked_in = torch.any((anti_at > 0) & bvalid[:, None], dim=0)
        # existing pods' required anti-affinity (satisfyExistingPodsAntiAffinity)
        ca_valid, ca_ids = _slot_ids(tb.carr_anti_t[g])
        ca_at = carrier_rows_at(tb, cry, ca_ids)
        blocked_ex = torch.any((ca_at > 0) & ca_valid[:, None], dim=0)
    else:
        aff_ok, blocked_in, blocked_ex = ones, ~ones, ~ones

    # PodTopologySpread DoNotSchedule (filtering.go Filter)
    if include_dns and filters.spread:
        dvalid, dids = _slot_ids(tb.dns_t[g])
        edom = tb.dns_edom[g]
        cdom, dns_at, dns_key, _ = counter_rows_at(tb, cry, dids)
        min_cnt = torch.amin(torch.where(edom, cdom, float("inf")), dim=1)
        min_cnt = torch.where(torch.isfinite(min_cnt), min_cnt, 0.0)
        skew = dns_at + tb.dns_self[g][:, None] - min_cnt[:, None]
        dns_ok_each = dns_key & (skew <= tb.dns_maxskew[g][:, None])
        dns_ok = torch.all(dns_ok_each | ~dvalid[:, None], dim=0)
    else:
        dns_ok = ones

    # Open-Gpu-Share Filter (open-gpu-share.go:51-81): the node's total GPU
    # memory covers the per-GPU request and its devices hold the requested
    # units; a pre-assigned gpu-index skips the device fit
    # (gpunodeinfo.go:247-253)
    gpu_ok = ones
    if enable_gpu and bool(tb.grp_gpu_mem[g] > 0):
        gmem, gnum = tb.grp_gpu_mem[g], tb.grp_gpu_num[g]
        node_total = _sum_left(tb.dev_total)
        if bool(tb.grp_gpu_pre[g]):
            gpu_ok = (node_total >= gmem) & (gnum > 0) & torch.any(tb.dev_total > 0, dim=1)
        else:
            units = _gpu_units(tb.dev_total, cry.dev_used, torch.clamp(gmem, min=1.0))
            gpu_ok = (node_total >= gmem) & (_sum_left(units) >= gnum) & (gnum > 0)

    # Open-Local Filter (open-local.go:51-92)
    storage_ok = storage_alloc(tb, cry, g)["ok"] if enable_storage else ones

    feasible = (smask & fit & ~conflict & aff_ok & ~blocked_in & ~blocked_ex & dns_ok
                & gpu_ok & storage_ok)
    feasible = feasible & bool(valid)
    if forced >= 0:
        feasible = feasible & (torch.arange(N, device=dev) == forced)

    stages = {
        "static": smask,
        "taint": tb.mask_taint[g],
        "unsched": tb.mask_unsched[g],
        "affinity": tb.mask_aff[g],
        "extra": tb.mask_extra[g],
        "fit": fit,
        "fit_each": fit_each,
        "ports": ~conflict,
        "pod_affinity": aff_ok,
        "pod_anti": ~(blocked_in | blocked_ex),
        "spread": dns_ok,
        "gpu": gpu_ok,
        "storage": storage_ok,
    }
    return feasible, stages


# rows of the packed diagnostic before fit_each's R: feasible, then the stages
FEASIBILITY_ROWS = 1 + len(STAGE_ROWS)


def pack_feasibility(feasible: torch.Tensor, stages: dict) -> torch.Tensor:
    """`feasibility`'s pair as K1 writes it: ONE [FEASIBILITY_ROWS + R, N]
    uint8 buffer, row 0 the feasible mask, the STAGE_ROWS masks, then
    fit_each transposed ([R, N]); 1 / 0."""
    return torch.cat([feasible[None], torch.stack([stages[k] for k in STAGE_ROWS]),
                      stages["fit_each"].T]).to(torch.uint8)


def unpack_feasibility(rows: torch.Tensor):
    """(feasible [N], {STAGE_KEYS: mask}) as bool views of the packed rows
    (`pack_feasibility`'s layout), fit_each the transposed [N, R] view; no
    copy."""
    b = rows.view(torch.bool)
    stages = {k: b[1 + i] for i, k in enumerate(STAGE_ROWS)}
    stages["fit_each"] = b[FEASIBILITY_ROWS:].T
    return b[0], {k: stages[k] for k in STAGE_KEYS}


# Per-plugin score components in the summation order of the JAX package's
# fused total (left-associated adds of weighted terms).
COMPONENT_ORDER = (
    "least", "balanced", "openlocal", "simon", "nodeaff", "taint",
    "interpod", "selector_spread", "topology_spread", "avoid", "image",
    "extra",
)


def components_total(comp: dict) -> torch.Tensor:
    total = comp[COMPONENT_ORDER[0]]
    for key in COMPONENT_ORDER[1:]:
        total = total + comp[key]
    return total


# The score's normalizers and sums over the feasible set ride one f32 vector,
# so that a node-partitioned scan (schedule_batch_sharded_plain, K12) reduces
# them over the ranks in one collective: PART_HEAD values (the maxima of the
# Simon, NodeAffinity, TaintToleration, InterPodAffinity and SelectorSpread
# inputs; the Simon and InterPodAffinity minima negated; Open-Local's maximum
# and negated minimum; any feasible node; any zoned feasible node), then the
# [Z] SelectorSpread zone sums and, for a group with ScheduleAnyway terms,
# the [Ss, D+1] domain marks. Maxima and marks reduce by max (a minimum
# rides negated: -max(-x) == min(x)), the zone sums by an ordered sum.
PART_HEAD = 11
_P_ZONED = 10  # any zoned feasible node (9: any feasible node)


def _has_sa(tb: Tables, g: int) -> bool:
    """Whether group g has a ScheduleAnyway term."""
    return bool((tb.sa_t[g] >= 0).any())


def _score_locals(tb: Tables, cry: Carry, g: int, F, enable_storage: bool) -> dict:
    """The node-local inputs of group g's score terms on these tables' nodes."""
    dev = F.device
    alloc_cm = tb.alloc[:, (CPU_I, MEM_I)]
    used = cry.nonzero + tb.grp_nonzero[g][None, :]
    least, balanced = least_balanced(used[:, 0], used[:, 1], alloc_cm[:, 0], alloc_cm[:, 1])
    ss_id = int(tb.ss_t[g])
    pernode = counter_rows_at(tb, cry, torch.tensor([max(ss_id, 0)], device=dev))[1][0]
    svalid, sidx = _slot_ids(tb.sa_t[g])
    _, sa_at, sa_key, sa_dom = counter_rows_at(tb, cry, sidx)
    ignored = torch.any(svalid[:, None] & ~sa_key, dim=0)
    return {"F": F, "least": least, "balanced": balanced, "simon_s": _flr(100.0 * tb.simon_raw[g]),
            "na_raw": tb.nodeaff_raw[g], "t_raw": tb.taint_raw[g],
            "ip_raw": interpod_raw(tb, cry, g), "has_ss": ss_id >= 0, "pernode": pernode,
            "svalid": svalid, "sa_at": sa_at, "sa_dom": sa_dom, "relevantF": F & ~ignored,
            "st": storage_alloc(tb, cry, g) if enable_storage else None}


def _score_partials(tb: Tables, loc: dict, Z: int, D: int, marks: bool) -> torch.Tensor:
    """These nodes' part of the score's reductions over the feasible set
    (the layout of PART_HEAD); the domain marks only with `marks`."""
    F = loc["F"]
    ninf = float("-inf")
    st_raw = loc["st"]["raw"] if loc["st"] is not None else torch.zeros_like(loc["simon_s"])
    mx = torch.amax(torch.where(F[None, :], torch.stack(
        [loc["simon_s"], loc["na_raw"], loc["t_raw"], loc["ip_raw"], loc["pernode"], st_raw]),
        ninf), dim=1)
    nmn = torch.amax(torch.where(F[None, :], -torch.stack(
        [loc["simon_s"], loc["ip_raw"], st_raw]), ninf), dim=1)
    flags = torch.stack([torch.any(F), torch.any(F & (tb.node_zone > 0))]).to(_F32)
    parts = [mx[:5], nmn[:2], mx[5:], nmn[2:], flags,
             _zone_sums(loc["pernode"], F, tb.node_zone, Z)]
    if marks:
        parts.append(_sa_marks(loc["relevantF"], loc["sa_dom"], D).reshape(-1))
    return torch.cat(parts)


def _reduce_partials(rows: torch.Tensor, Z: int) -> torch.Tensor:
    """The reduction of every rank's `_score_partials` ([ranks, K], rank
    order): max, but the zone sums, which add in rank order. They are sums of
    integer-valued counts, so the ordered sum is exact (checked)."""
    red = torch.amax(rows, dim=0)
    zs = rows[0, PART_HEAD:PART_HEAD + Z]
    for r in range(1, rows.shape[0]):
        zs = zs + rows[r, PART_HEAD:PART_HEAD + Z]
    if rows.shape[0] > 1:
        if not torch.equal(zs, torch.floor(zs)):
            raise ValueError("SelectorSpread zone sums must be integer-valued to add exactly")
        red[PART_HEAD:PART_HEAD + Z] = zs
    return red


def _score_final(tb: Tables, g: int, loc: dict, red, sa_red, sa_raw, n_zones: int,
                 w: ScoreWeights, enable_storage: bool) -> dict:
    """The normalized, weighted score terms on these tables' nodes from the
    reduced partials `red` and ScheduleAnyway's reduced `sa_red`."""
    Z = max(2, n_zones)
    simon_s, na_raw, t_raw, ip_raw = loc["simon_s"], loc["na_raw"], loc["t_raw"], loc["ip_raw"]
    maxes, mins = red[:5], -red[5:7]

    # Simon max-share + min-max normalize (plugin/simon.go:45-101)
    hi, lo = maxes[0], mins[0]
    rng = hi - lo
    simon = torch.where((rng > 0) & torch.isfinite(rng), _flr((simon_s - lo) * 100.0 / rng), 0.0)

    # NodeAffinity preferred (helper.DefaultNormalizeScore, reverse=false)
    na_max = torch.clamp(maxes[1], min=0.0)
    nodeaff = torch.where(na_max > 0, _flr(na_raw * 100.0 / na_max), 0.0)

    # TaintToleration (DefaultNormalizeScore reverse=true: all-100 when max==0)
    t_max = torch.clamp(maxes[2], min=0.0)
    taint = torch.where(t_max > 0, 100.0 - _flr(t_raw * 100.0 / t_max), 100.0)

    # InterPodAffinity normalize: zero-initialized min/max (scoring.go)
    ip_max = torch.clamp(maxes[3], min=0.0)
    ip_min = torch.clamp(mins[1], max=0.0)
    ip_rng = ip_max - ip_min
    interpod = torch.where(ip_rng > 0, _flr(100.0 * (ip_raw - ip_min) / ip_rng), 0.0)

    blended = _selector_spread_blend(loc["pernode"], tb.node_zone,
                                     red[PART_HEAD:PART_HEAD + Z], red[_P_ZONED] > 0,
                                     maxN=torch.clamp(maxes[4], min=0.0))
    if bool(tb.ss_skip[g]):
        selector_spread = torch.zeros_like(blended)
    else:
        selector_spread = _flr(blended) if loc["has_ss"] else torch.full_like(blended, 100.0)

    # PodTopologySpread ScheduleAnyway scoring
    pts = _sa_normalized(sa_raw, loc["relevantF"], sa_red)

    # Open-Local Score (open-local.go:94-172): Binpack LVM + device ints, then
    # the plugin's own min-max normalization over F
    openlocal = 0.0
    if enable_storage:
        st = loc["st"]
        st_hi = torch.clamp(red[7], min=0.0)
        st_lo_raw = -red[8]
        st_lo = torch.where(torch.isfinite(st_lo_raw), st_lo_raw, 0.0)
        st_rng = st_hi - st_lo
        openlocal = torch.where(st["has_storage"] & (st_rng > 0),
                                _flr((st["raw"] - st_lo) * 100.0 / st_rng), 0.0)

    return {
        "least": w.least * loc["least"],
        "balanced": w.balanced * loc["balanced"],
        "openlocal": w.openlocal * openlocal,
        "simon": (w.simon + w.gpushare) * simon,  # Open-Gpu-Share Score ≡ Simon Score
        "nodeaff": w.nodeaff * nodeaff,
        "taint": w.taint * taint,
        "interpod": w.interpod * interpod,
        "selector_spread": w.ss * selector_spread,
        "topology_spread": w.pts * pts,
        "avoid": w.avoid * tb.avoid_raw[g],
        "image": w.image * tb.image_raw[g],
        "extra": tb.extra_raw[g],  # out-of-tree plugins, pre-weighted at encode time
    }


def score_components(tb: Tables, cry: Carry, g: int, feasible, n_zones: int,
                     w: ScoreWeights = DEFAULT_WEIGHTS, enable_storage: bool = False,
                     mesh=None) -> dict:
    """All normalized, weighted plugin score terms over the feasible set —
    {name: [N] f32} in COMPONENT_ORDER (Open-Local is the constant 0 without
    `enable_storage`). On a node `mesh` with more than one shard the tables,
    the carry and `feasible` are this rank's node block, and the sets the
    terms normalize over are the union of every rank's: the partials ride
    one `all_gather_rows`, and ScheduleAnyway's extrema, which need the
    global topology sizes first, one `pmax` (only for a group with such
    terms). Returns this block's terms."""
    from ..parallel.collectives import all_gather_rows, pmax

    D = cry.counter.shape[1] - 1
    Z = max(2, n_zones)
    sa = _has_sa(tb, g)
    loc = _score_locals(tb, cry, g, feasible, enable_storage)
    part = _score_partials(tb, loc, Z, D, sa)
    red = _reduce_partials((all_gather_rows(part[None], mesh) if _partitioned(mesh)
                            else part[None]), Z)
    marks = (red[PART_HEAD + Z:].view(-1, D + 1) if sa
             else torch.zeros((tb.sa_t.shape[1], D + 1), dtype=_F32, device=feasible.device))
    sa_raw = _sa_raw(loc["sa_at"], marks, loc["svalid"], tb.sa_maxskew[g])
    sa_part = _sa_partials(sa_raw, loc["relevantF"])
    # without a ScheduleAnyway term every raw score is 0 and every block's
    # clamped maximum 0: the block's own partials normalize alike
    sa_red = pmax(sa_part, mesh) if sa and _partitioned(mesh) else sa_part
    return _score_final(tb, g, loc, red, sa_red, sa_raw, n_zones, w, enable_storage)


def _partitioned(mesh) -> bool:
    """Whether `mesh` partitions the node axis over more than one rank (the
    tables and carry handed over with it are then this rank's block)."""
    return mesh is not None and mesh.shards > 1 and len(mesh.axis_names) == 1


def global_nodes(tb: Tables, mesh) -> int:
    """The node count of the whole table: the block's NL times the shard
    count on a partitioned `mesh`, else the table's own N."""
    NL = tb.alloc.shape[0]
    return NL * mesh.shards if _partitioned(mesh) else NL


def block_forced(forced: int, lo: int, NL: int) -> int:
    """A pod's forced node (global, -1 for none) as a node of the block
    [lo, lo + NL): its local index, or NL, which no node of the block
    matches, when it lies in another block."""
    if forced < 0:
        return -1
    return forced - lo if lo <= forced < lo + NL else NL


# The stage masks of an xray decision set, in the order of the JAX package's
# obs/xray.py STAGE_NAMES (the engine's diagnosis order plus the static
# root). K7 writes them as rows in this order, mapped by name from its stage
# bits (STAGE_ROWS order).
EXPLAIN_STAGES = ("static", "unsched", "taint", "affinity", "extra", "ports", "fit",
                  "spread", "pod_affinity", "pod_anti", "gpu", "storage")
# K7's [26, N] f32 output: the rows of the JAX engine's packed xray fetch
# (simulator/engine.py `_xray_set`)
EXPLAIN_ROWS = ("feasible", "total") + EXPLAIN_STAGES + COMPONENT_ORDER


def explain_pod(tb: Tables, cry: Carry, g: int, forced: int, valid: bool, n_zones: int,
                enable_gpu: bool = False, enable_storage: bool = False,
                w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                mesh=None):
    """The xray flight recorder's diagnostic for one group against a carry
    (JAX `explain_pod`): `feasibility`, then `score_components` over the
    feasible mask. Plain version of `explain_kernel`. Returns (feasible [N]
    bool, stages {EXPLAIN_STAGES: [N] bool}, total [N] f32, components
    {COMPONENT_ORDER: [N] f32}); every component is computed on every node,
    only the normalizers and the zone sums are taken over the feasible set.
    On a partitioned node `mesh` (the tables and carry this rank's block,
    `forced` a global node) the same for the block's nodes, normalized over
    every rank's feasible set (`score_components`)."""
    if _partitioned(mesh):
        NL = tb.alloc.shape[0]
        forced = block_forced(forced, mesh.rank * NL, NL)
    feasible, stages = feasibility(tb, cry, g, forced, valid, filters, enable_gpu=enable_gpu,
                                   enable_storage=enable_storage)
    comp = score_components(tb, cry, g, feasible, n_zones, w, enable_storage, mesh)
    N = feasible.shape[0]
    comp = {k: torch.as_tensor(v, dtype=_F32, device=feasible.device).expand(N)
            for k, v in comp.items()}  # openlocal is a python 0.0 without storage
    return feasible, {k: stages[k] for k in EXPLAIN_STAGES}, components_total(comp), comp


def pack_explain(feasible, stages: dict, total, comp: dict) -> torch.Tensor:
    """The [EXPLAIN_ROWS, N] f32 rows of an `explain_pod` result (masks as
    1.0 / 0.0)."""
    rows = [feasible, total] + [stages[k] for k in EXPLAIN_STAGES] + [comp[k] for k in
                                                                     COMPONENT_ORDER]
    return torch.stack([r.to(_F32) for r in rows])


def unpack_explain(packed: torch.Tensor):
    """`explain_pod`'s four-tuple from packed rows (views, no copy)."""
    ns = len(EXPLAIN_STAGES)
    stages = {k: packed[2 + i] > 0.5 for i, k in enumerate(EXPLAIN_STAGES)}
    comp = {k: packed[2 + ns + i] for i, k in enumerate(COMPONENT_ORDER)}
    return packed[0] > 0.5, stages, packed[1], comp


def scores(tb: Tables, cry: Carry, g: int, feasible, n_zones: int,
           w: ScoreWeights = DEFAULT_WEIGHTS, enable_storage: bool = False) -> torch.Tensor:
    """Weighted sum of all normalized plugin scores over the feasible set."""
    return components_total(score_components(tb, cry, g, feasible, n_zones, w, enable_storage))


def commit(tb: Tables, cry: Carry, g: int, choice, do, enable_gpu: bool = False,
           enable_storage: bool = False) -> Carry:
    """Apply one placement to the carry (the Reserve+Bind of the cycle);
    functional: returns a new Carry. `choice`/`do` may be 0-dim tensors, so a
    scan on the card never waits for the host. With the flags, the GPU
    device ledger and the Open-Local VG/device state too; the storage take
    is computed from the carry before this commit."""
    dev = tb.alloc.device
    c = torch.as_tensor(choice, device=dev).long().clamp(min=0).reshape(1)
    do_t = torch.as_tensor(do, device=dev).bool()
    counter, carrier = _commit_domains(tb, cry, g, tb.counter_dom[:, c[0]].long(),
                                       tb.carr_dom[:, c[0]].long(), do_t.to(_F32))
    return _commit_node(tb, cry, g, c, do_t, enable_gpu, enable_storage)._replace(
        counter=counter, carrier=carrier)


def _commit_domains(tb: Tables, cry: Carry, g: int, dom_col, cdom_col, dof):
    """The placement's (counter, carrier): every counter and carrier row
    counts group g in the chosen node's domain (its columns `dom_col` [T]
    and `cdom_col` [Tc]), the sentinel column never; `dof` is 1.0 or 0.0."""
    dev = tb.alloc.device
    D = cry.counter.shape[1] - 1
    inc = tb.counter_sel_match_g[:, g].to(_F32) * (dom_col < D) * dof
    counter = cry.counter.index_put((torch.arange(cry.counter.shape[0], device=dev), dom_col),
                                    inc, accumulate=True)
    cinc = tb.grp_carries[g] * (cdom_col < D) * dof
    carrier = cry.carrier.index_put((torch.arange(cry.carrier.shape[0], device=dev), cdom_col),
                                    cinc, accumulate=True)
    return counter, carrier


def _commit_node(tb: Tables, cry: Carry, g: int, c, do_t, enable_gpu: bool,
                 enable_storage: bool) -> Carry:
    """The placement's node rows at node c ([1] long) when `do_t`: requested,
    nonzero, ports and, with the flags, the GPU and storage ledgers; the
    counter and carrier are `cry`'s."""
    dof = do_t.to(_F32)
    requested = cry.requested.index_add(0, c, (tb.grp_requests[g] * dof)[None])
    nonzero = cry.nonzero.index_add(0, c, (tb.grp_nonzero[g] * dof)[None])
    pids = tb.grp_ports[g].long()
    port_used = cry.port_used.clone()
    port_used[c, pids] = port_used[c, pids] | ((pids > 0) & do_t)

    # GPU device allocation (AllocateGpuId): pre-assigned ids charge exactly
    # the annotated devices (the host's add_pod), without a fit check
    dev_used = cry.dev_used
    if enable_gpu:
        gmem, gnum = tb.grp_gpu_mem[g], tb.grp_gpu_num[g]
        if bool(tb.grp_gpu_pre[g]):
            take = tb.grp_gpu_take[g]
        else:
            take = _gpu_take(tb.dev_total[c[0]], cry.dev_used[c[0]], gmem, gnum,
                             torch.clamp(gmem, min=1.0), bool(gnum == 1))
        gdo = dof * (gmem > 0).to(_F32)
        dev_used = cry.dev_used.index_add(0, c, (take * gmem * gdo)[None])

    # Open-Local Bind: bump the VGs' requested bytes, mark devices allocated
    vg_req, sdev_alloc = cry.vg_req, cry.sdev_alloc
    if enable_storage:
        st = storage_alloc(tb, cry, g)
        sdo = dof * float(st["has_storage"])
        vg_req = cry.vg_req.index_add(0, c, (st["lvm_add"][c[0]] * sdo)[None])
        sdev_alloc = cry.sdev_alloc.index_add(0, c, (st["dev_add"][c[0]] * sdo)[None])
    return Carry(requested, nonzero, port_used, cry.counter, cry.carrier, dev_used, vg_req,
                 sdev_alloc)


def step(tb: Tables, cry: Carry, g: int, forced: int, valid: bool, n_zones: int,
         w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
         enable_gpu: bool = False, enable_storage: bool = False):
    """One scheduleOne cycle: (new carry, choice as a 0-dim i32 tensor, -1 =
    unschedulable)."""
    feasible, _ = feasibility(tb, cry, g, forced, valid, filters, enable_gpu=enable_gpu,
                              enable_storage=enable_storage)
    any_f = torch.any(feasible)
    sc = scores(tb, cry, g, feasible, n_zones, w, enable_storage)
    masked = torch.where(feasible, sc, float("-inf"))
    choice = torch.argmax(masked).to(torch.int32)  # first max → lowest node index
    choice = torch.where(any_f, choice, torch.tensor(-1, dtype=torch.int32, device=sc.device))
    return commit(tb, cry, g, choice, any_f, enable_gpu, enable_storage), choice


@torch.inference_mode()
def schedule_batch_plain(tb: Tables, cry: Carry, pod_group, forced_node, valid,
                         n_zones: int, w: ScoreWeights = DEFAULT_WEIGHTS,
                         filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                         enable_storage: bool = False):
    """Plain version of `schedule_batch_kernel`: the scan as a Python loop of
    `step`; returns (final carry, choices [P] i32)."""
    choices = []
    dev = tb.alloc.device
    none = torch.tensor(-1, dtype=torch.int32, device=dev)
    pods = zip(torch.as_tensor(pod_group).tolist(), torch.as_tensor(forced_node).tolist(),
               torch.as_tensor(valid).tolist())
    for g, f, v in pods:
        if not v:  # padded pod: feasible nowhere, commits nothing (as in the kernel)
            choices.append(none)
            continue
        cry, ch = step(tb, cry, g, f, v, n_zones, w, filters, enable_gpu, enable_storage)
        choices.append(ch)
    if not choices:
        return cry, torch.zeros(0, dtype=torch.int32, device=tb.alloc.device)
    return cry, torch.stack(choices)


@torch.inference_mode()
def schedule_batch_sharded_plain(tb: Tables, cry: Carry, pod_group, forced_node, valid,
                                 n_zones: int, mesh, w: ScoreWeights = DEFAULT_WEIGHTS,
                                 filters: FilterFlags = DEFAULT_FILTERS,
                                 enable_gpu: bool = False, enable_storage: bool = False):
    """Plain version of `schedule_batch_sharded_kernel` (K12): the serial scan
    on a partitioned node `mesh`, where `tb` and `cry` are this rank's block
    of NL nodes (parallel/mesh.py `to_device_sharded`) and the pods, their
    forced nodes and the choices are global. Per valid pod, as K12's stages:

    A. feasibility on the block (a forced node in another block leaves the
       block none), the node-local score inputs and the block's partials
       (`_score_partials`); all_gather_rows #1, reduced in rank order;
    A2. for a group with ScheduleAnyway terms, the raw scores with the
       global topology sizes and their block extrema; pmax #1b;
    B. the total in COMPONENT_ORDER and the block's first max as (score,
       global node, -inf without a feasible node) with the node's counter
       and carrier domain columns; all_gather_rows #2;
    C. on every rank, the global first max (largest score, then lowest
       global node; -1 when no rank has a feasible node), the replicated
       counter / carrier update from the winner's columns, and on the owning
       rank alone the commit of the node's rows.

    Returns (this block's final carry, choices [P] i32 as global node
    indices, equal on every rank)."""
    from ..parallel.collectives import all_gather_rows

    dev = tb.alloc.device
    NL = tb.alloc.shape[0]
    lo = mesh.rank * NL
    choices = []
    pods = zip(torch.as_tensor(pod_group).tolist(), torch.as_tensor(forced_node).tolist(),
               torch.as_tensor(valid).tolist())
    for g, f, v in pods:
        if not v:
            choices.append(-1)
            continue
        F, _ = feasibility(tb, cry, g, block_forced(f, lo, NL), True, filters,
                           enable_gpu=enable_gpu, enable_storage=enable_storage)
        total = components_total(score_components(tb, cry, g, F, n_zones, w, enable_storage,
                                                  mesh))
        masked = torch.where(F, total, float("-inf"))
        i = int(torch.argmax(masked))  # the block's first max
        row = torch.cat([torch.stack([masked[i].double(), torch.tensor(lo + i, dtype=torch.float64,
                                                                       device=dev)]),
                         tb.counter_dom[:, i].double(), tb.carr_dom[:, i].double()])
        rows = all_gather_rows(row[None], mesh)
        score, c = _first_max([(r[0], r[1]) for r in rows[:, :2].tolist()])
        if score == float("-inf"):
            choices.append(-1)
            continue
        c = int(c)
        win = rows[c // NL]
        T = tb.counter_dom.shape[0]
        counter, carrier = _commit_domains(tb, cry, g, win[2:2 + T].long(), win[2 + T:].long(),
                                           torch.tensor(1.0, device=dev))
        cry = cry._replace(counter=counter, carrier=carrier)
        if c // NL == mesh.rank:
            cry = _commit_node(tb, cry, g, torch.tensor([c - lo], device=dev),
                               torch.tensor(True, device=dev), enable_gpu, enable_storage)
        choices.append(c)
    return cry, torch.tensor(choices, dtype=torch.int32, device=dev)


# ------------------------------------------------------------------ wave route ----
#
# Port of the JAX package's wave kernels (ops/kernels.py :800-1310, :2102-2262).
# A wave places m interchangeable pods of one group at once: it builds the
# [N, B+1] table of the score each node would give its next B+1 copies, takes
# the best entries in serial's pick order (score desc, node asc, copy asc)
# under a guard that defers any entry a hidden (deeper or non-monotone) entry
# could beat, and stops early where a node leaving the feasible set would move
# a normalizer. The per-node counts then equal m serial steps exactly.

WAVE_BLOCK = 64  # B: max score-table depth = max copies per node per wave iteration
# Score-table entries (N*B) above which wave_block_for halves the depth.
_WAVE_TABLE_BUDGET = 1 << 21
# `capacity` of a node when NodeResourcesFit is off or nothing is requested
_CAP_UNBOUNDED_F = 2_147_483_000.0
_CAP_UNBOUNDED_I = 2_147_483_000
WAVE_STATS = ("iterations", "head_fallbacks", "guarded")
# K3's stats row per lane (csrc/wave.cu K3_STATS, i32)
WAVE_CLUSTER_STATS = ("placed",) + WAVE_STATS + ("rounds",)


def wave_block_for(m: int, n: int) -> int:
    """Score-table depth for an m-pod wave over n nodes: a pow2 in [8,
    WAVE_BLOCK] covering ~8x the mean per-node take, halved toward 8 while
    n*B exceeds _WAVE_TABLE_BUDGET. Correctness never depends on it (hidden
    entries defer to later iterations), only the iteration count does."""
    b = 8
    target = (8 * m + max(n, 1) - 1) // max(n, 1)
    while b < min(WAVE_BLOCK, target):
        b *= 2
    while b > 8 and n * b > _WAVE_TABLE_BUDGET:
        b //= 2
    return b


def wave_kmax(m: int, n: int, block: int) -> int:
    """Top-k width of one wave iteration: a pow2 >= the segment length (from
    256), capped at the table size. Entries past it defer to later
    iterations, so it bounds one iteration's take, never the result."""
    cap = max(1, n * block)
    k = 256
    while k < min(m, cap):
        k *= 2
    return min(k, cap)


def _wave_statics(tb: Tables, cry: Carry, g: int, w: ScoreWeights = DEFAULT_WEIGHTS) -> dict:
    """Per-segment constants of the score, exactly as scores() computes them
    (counters cannot change inside a wave)."""
    ip_raw = interpod_raw(tb, cry, g)
    simon_s = _flr(100.0 * tb.simon_raw[g])
    na_raw = tb.nodeaff_raw[g]
    t_raw = tb.taint_raw[g]
    return {
        "ip_raw": ip_raw,
        "simon_s": simon_s,
        "na_raw": na_raw,
        "t_raw": t_raw,
        "max_stack": torch.stack([simon_s, na_raw, t_raw, ip_raw]),
        "min_stack": torch.stack([simon_s, ip_raw]),
        "static": w.avoid * tb.avoid_raw[g] + w.image * tb.image_raw[g] + tb.extra_raw[g],
    }


def _wave_norms(st: dict, F: torch.Tensor) -> tuple:
    """(simon_hi, simon_lo, na_max, t_max, ip_max, ip_min) over the feasible
    set F, as 0-dim tensors (the same floats scores() normalizes with)."""
    inf = torch.tensor(float("inf"), device=F.device)
    maxes = torch.amax(torch.where(F[None, :], st["max_stack"], -inf), dim=1)
    mins = torch.amin(torch.where(F[None, :], st["min_stack"], inf), dim=1)
    return (maxes[0], mins[0], torch.clamp(maxes[1], min=0.0), torch.clamp(maxes[2], min=0.0),
            torch.clamp(maxes[3], min=0.0), torch.clamp(mins[1], max=0.0))


def _normalized_terms(st: dict, norms: tuple) -> tuple:
    """Simon, NodeAffinity, TaintToleration and InterPodAffinity over the
    normalizers `norms`, unweighted (as scores() normalizes them)."""
    simon_hi, simon_lo, na_max, t_max, ip_max, ip_min = norms
    rng = simon_hi - simon_lo
    simon = torch.where((rng > 0) & torch.isfinite(rng),
                        _flr((st["simon_s"] - simon_lo) * 100.0 / rng), 0.0)
    nodeaff = torch.where(na_max > 0, _flr(st["na_raw"] * 100.0 / na_max), 0.0)
    taint = torch.where(t_max > 0, 100.0 - _flr(st["t_raw"] * 100.0 / t_max), 100.0)
    ip_rng = ip_max - ip_min
    interpod = torch.where(ip_rng > 0, _flr(100.0 * (st["ip_raw"] - ip_min) / ip_rng), 0.0)
    return simon, nodeaff, taint, interpod


def _wave_score_table_rows(a_c, a_m, nonzero, grp_nz, st: dict, norms: tuple, j: torch.Tensor,
                           w: ScoreWeights = DEFAULT_WEIGHTS,
                           block: int = WAVE_BLOCK) -> torch.Tensor:
    """[n, B+1] table from per-node rows (JAX :904): entry (n, k) is the
    score of the (j_n+k+1)-th copy on node n. Every operation is per node,
    so the rows may be the full [N] arrays or one mesh shard's block: the
    floats are the same either way. Term by term the formulas of scores();
    the terms that are constant on F (SelectorSpread, PodTopologySpread,
    Open-Local) are dropped, since a uniform shift never changes the order
    the wave takes."""
    dev = j.device
    copies = (j.to(_F32)[:, None, None]
              + torch.arange(1, block + 2, dtype=_F32, device=dev)[None, :, None])
    used = nonzero[:, None, :] + grp_nz[None, None, :] * copies  # [n, B+1, 2]
    least, balanced = least_balanced(used[:, :, 0], used[:, :, 1], a_c[:, None], a_m[:, None])
    simon, nodeaff, taint, interpod = _normalized_terms(st, norms)
    static_n = ((w.simon + w.gpushare) * simon + w.nodeaff * nodeaff + w.taint * taint
                + w.interpod * interpod + st["static"])
    return w.least * least + w.balanced * balanced + static_n[:, None]


def _wave_score_table(tb: Tables, cry: Carry, st: dict, norms: tuple, g: int, j: torch.Tensor,
                      w: ScoreWeights = DEFAULT_WEIGHTS, block: int = WAVE_BLOCK) -> torch.Tensor:
    """[N, B+1] score table over the full node set."""
    return _wave_score_table_rows(tb.alloc[:, CPU_I], tb.alloc[:, MEM_I], cry.nonzero,
                                  tb.grp_nonzero[g], st, norms, j, w, block)


def _wave_capacity(tb: Tables, cry: Carry, g: int, cap1: bool) -> torch.Tensor:
    """[N] i32: how many more copies of group g each node can take, from the
    closed-form NodeResourcesFit bound (the eps slack of feasibility())."""
    req = tb.grp_requests[g]
    eps = tb.alloc * 1e-6
    room = tb.alloc + eps - cry.requested
    per_res = torch.where(req[None, :] > 0,
                          torch.floor(room / torch.clamp(req[None, :], min=1e-30)),
                          float("inf"))
    cap = torch.clamp(torch.amin(per_res, dim=1), 0.0, _CAP_UNBOUNDED_F).to(torch.int32)
    return torch.clamp(cap, max=1) if cap1 else cap


def _wave_gpu_params(tb: Tables, g: int):
    """(gmem, gnum, safe_mem) of a shared-GPU group (JAX :956)."""
    gmem = tb.grp_gpu_mem[g]
    return gmem, torch.clamp(tb.grp_gpu_num[g], min=1.0), torch.clamp(gmem, min=1.0)


def _gpu_capacity(tb: Tables, cry: Carry, g: int, capacity: torch.Tensor) -> torch.Tensor:
    """Clamp each node's copy capacity by its GPU units (JAX :963): every copy
    takes `num` whole units and a take never changes another device's
    units, so the capacity is floor(total units / num)."""
    gmem, gnum, safe_mem = _wave_gpu_params(tb, g)
    units = _sum_left(_gpu_units(tb.dev_total, cry.dev_used, safe_mem))
    gpu_cap = torch.floor(units / gnum).to(torch.int32)
    return torch.where(gmem > 0, torch.minimum(capacity, gpu_cap), capacity)


def _base_capacity(tb: Tables, cry: Carry, g: int, cap1: bool, base_feas: torch.Tensor,
                   filters: FilterFlags) -> torch.Tensor:
    """Copies each node can take in this segment (0 off the base feasible set)."""
    zero = torch.zeros((), dtype=torch.int32, device=base_feas.device)
    if filters.fit:
        return torch.where(base_feas, _wave_capacity(tb, cry, g, cap1), zero)
    # resources unbounded, but cap1 (ports / self-anti-affinity) survives
    cap = torch.where(base_feas, torch.full_like(zero, _CAP_UNBOUNDED_I), zero)
    return torch.clamp(cap, max=1) if cap1 else cap


def _top_k(flat: torch.Tensor, k: int):
    """lax.top_k: the k largest values, ties by ascending index (a stable
    descending sort keeps equal values in index order)."""
    vals, pos = torch.sort(flat, descending=True, stable=True)
    return vals[:k], pos[:k]


def _usable_and_bound(table_ext, avail, F, B: int):
    """The unguarded half of the selection on n nodes' [n, B+1] rows:
    (table [n, B], ks [1, B], the usable-entry mask (capacity, monotone
    prefix, feasible) and each node's first hidden entry `bound` (past
    depth B or past a monotonicity break; -inf where there is none))."""
    n = table_ext.shape[0]
    dev = table_ext.device
    table = table_ext[:, :B]
    ks = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    in_cap = ks < avail[:, None]
    step_ok = torch.cat([torch.ones((n, 1), dtype=torch.int32, device=dev),
                         (table[:, 1:] <= table[:, :-1]).to(torch.int32)], dim=1)
    mono = torch.cumprod(step_ok, dim=1) > 0
    usable = in_cap & mono & F[:, None]
    first_bad = torch.amin(torch.where(mono, B, ks), dim=1)
    k_hid = torch.clamp(first_bad, max=B)
    has_hidden = (k_hid < avail) & F
    bound = torch.where(has_hidden, torch.gather(table_ext, 1, k_hid.long()[:, None])[:, 0],
                        torch.tensor(float("-inf"), device=dev))
    return table, ks, usable, bound


def _guarded(table, usable, iota, cut_s, cut_i):
    """The guard: an entry is takeable only if its key (score desc, index
    asc) strictly beats every OTHER node's first hidden entry, (cut_s,
    cut_i) per node. Returns (the usable mask that beats it, the entries it
    deferred)."""
    beats = (table > cut_s[:, None]) | ((table == cut_s[:, None])
                                        & (iota[:, None] < cut_i[:, None]))
    return usable & beats, int((usable & ~beats).sum())


def _wave_candidates_from(table_ext, avail, F, B: int, iota_n, kmax: int):
    """The usable-entry mask (capacity, monotone prefix, hidden-continuation
    guard) and the top-kmax candidates in serial's pick order. Returns
    (table [N, B], idx_srt, ex_srt, vals, guarded): idx_srt, ex_srt and vals
    are [kmax]; guarded counts the entries the guard deferred."""
    ninf = torch.tensor(float("-inf"), device=table_ext.device)
    table, ks, usable, bound = _usable_and_bound(table_ext, avail, F, B)
    b1 = torch.amax(bound)
    i1 = torch.argmax(bound)  # first max = lowest index among ties
    bound2 = bound.clone()
    bound2[i1] = ninf
    b2 = torch.amax(bound2)
    i2 = torch.argmax(bound2)
    cut_s = torch.where(iota_n == i1, b2, b1)
    cut_i = torch.where(iota_n == i1, i2, i1).to(torch.int32)
    usable, guarded = _guarded(table, usable, iota_n, cut_s, cut_i)

    flat_s = torch.where(usable, table, ninf).reshape(-1)
    exhaust = (ks == (avail[:, None] - 1)) & usable  # the entry that empties node n
    vals, flat_pos = _top_k(flat_s, kmax)
    idx_srt = torch.div(flat_pos, B, rounding_mode="floor").to(torch.int32)
    ex_srt = exhaust.reshape(-1)[flat_pos].to(torch.int32)
    return table, idx_srt, ex_srt, vals, guarded


def _wave_iteration(st: dict, norms: tuple, table_ext, F, avail, j, placed: int, m: int,
                    B: int, K: int):
    """Selection half of one wave iteration (JAX body_tail): returns (new j,
    placed, this iteration's take, {"head_fallbacks": 0 or 1, "guarded": n})."""
    N = table_ext.shape[0]
    dev = table_ext.device
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)
    table, idx_srt, ex_srt, vals, guarded = _wave_candidates_from(table_ext, avail, F, B,
                                                                   iota_n, K)
    pos = torch.arange(K, dtype=torch.int32, device=dev)
    n_finite = int(torch.isfinite(vals).sum())
    m_rem = m - placed
    m_cand = min(m_rem, n_finite)

    def counts_of(take: int) -> torch.Tensor:
        return torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
            0, idx_srt.long(), (pos < take).to(torch.int32))

    # exhausted nodes inside the candidate range may stay mid-wave only when
    # every normalizer provably survives their removal
    counts0 = counts_of(m_cand)
    leaves = counts0 >= torch.clamp(avail, min=1)
    norms_end = _wave_norms(st, F & ~leaves)
    same = all(bool(a == b) for a, b in zip(norms, norms_end))  # ±inf equal themselves
    p_ex = int(torch.amin(torch.where((ex_srt > 0) & (pos < m_cand), pos, N * B)))
    m_take = m_cand if same else min(m_cand, p_ex + 1)
    counts = counts_of(m_take)

    # guaranteed progress: serial's next pick is always the best head
    # (each node's k=0 entry), so placing exactly that pod is exact
    head = m_take == 0 and bool(torch.any(F)) and m_rem > 0
    if head:
        heads = torch.where(F, table[:, 0], float("-inf"))
        counts = torch.zeros(N, dtype=torch.int32, device=dev)
        counts[torch.argmax(heads)] = 1
        m_take = 1
    return j + counts, placed + m_take, m_take, {"head_fallbacks": int(head), "guarded": guarded}


def _epoch_shards(mesh, N: int) -> int:
    """Shards of the mesh's epoch path for N nodes; 1 runs unsharded."""
    if mesh is None:
        return 1
    from ..parallel.mesh import epoch_shards

    return epoch_shards(mesh, N)


def _round_shards(mesh, N: int) -> int:
    """Shards of the wave's per-round path for N nodes (above the epoch
    limit); 1 where it does not apply."""
    if mesh is None:
        return 1
    from ..parallel.mesh import round_shards

    return round_shards(mesh, N)


def _block_of(mesh, N: int) -> slice:
    """This rank's contiguous node block (the shard_map in_specs slice)."""
    NL = N // mesh.shards
    return slice(mesh.rank * NL, (mesh.rank + 1) * NL)


def _reduced_norms(red: torch.Tensor) -> tuple:
    """The six normalizers from a reduced [max simon, nodeaff, taint, ip,
    max -simon, max -ip] vector (JAX :1233-1235)."""
    return (red[0], -red[4], torch.clamp(red[1], min=0.0), torch.clamp(red[2], min=0.0),
            torch.clamp(red[3], min=0.0), torch.clamp(-red[5], max=0.0))


def _block_norm_partials(st: dict, F_l: torch.Tensor) -> torch.Tensor:
    """This rank's six maxima over its feasible block F_l (`st` the block's
    statics): [simon, nodeaff, taint, ip] and, negated, [simon, ip] (mins
    ride negated)."""
    ninf = float("-inf")
    mx = torch.amax(torch.where(F_l[None, :], st["max_stack"], ninf), dim=1)
    mn = torch.amax(torch.where(F_l[None, :], -st["min_stack"], ninf), dim=1)
    return torch.cat([mx, mn])


def _wave_block_front(tb: Tables, cry: Carry, g: int, st: dict, capacity, base_feas, j,
                      w: ScoreWeights, B: int, mesh):
    """The front of one sharded iteration on this rank's node block (`tb`,
    `cry`, `st`, `capacity` and `base_feas` the block's; `j` global): the
    block's feasible set, ONE pmax of the stacked normalizers and the
    block's [NL, B+1] score rows. Returns (norms, table_l, F_l, avail_l)."""
    from ..parallel.collectives import pmax

    j_l = j[_block_of(mesh, j.shape[0])]
    avail_l = capacity - j_l
    F_l = base_feas & (avail_l > 0)
    norms = _reduced_norms(pmax(_block_norm_partials(st, F_l), mesh))
    table_l = _wave_score_table_rows(tb.alloc[:, CPU_I], tb.alloc[:, MEM_I], cry.nonzero,
                                     tb.grp_nonzero[g], st, norms, j_l, w, B)
    return norms, table_l, F_l, avail_l


def _wave_front_sharded(tb: Tables, cry: Carry, g: int, st: dict, capacity, base_feas, j,
                        w: ScoreWeights, B: int, mesh):
    """The sharded epoch front of the wave (JAX :1220-1246): the block's
    front (`_wave_block_front`, one pmax) and ONE tiled all-gather of
    [table.T; F; min(avail, B+1); simon_s; nodeaff; taint; ip]. Returns
    (norms, table_ext [N, B+1], F, avail, statics) at full width: the same
    floats as the unsharded front, avail clamped to B+1 (every comparison
    the selection makes against it has a left side <= B), and the
    normalizer inputs the selection's end normalizers read."""
    from ..parallel.collectives import all_gather_tiled

    norms, table_l, F_l, avail_l = _wave_block_front(tb, cry, g, st, capacity, base_feas, j,
                                                     w, B, mesh)
    pay = torch.cat([table_l.T, F_l[None].to(_F32),
                     torch.clamp(avail_l, max=B + 1)[None].to(_F32), st["max_stack"]], dim=0)
    full = all_gather_tiled(pay, mesh, axis=1)
    ins = full[B + 3:B + 7]  # simon_s, nodeaff, taint, ip
    st_full = {"max_stack": ins, "min_stack": torch.stack([ins[0], ins[3]])}
    return norms, full[:B + 1].T, full[B + 1] > 0, full[B + 2].to(torch.int32), st_full


def _first_max(pairs) -> tuple:
    """The (value, index) pair of the largest value, the lowest index among
    ties: the first max, as argmax takes it."""
    return min(pairs, key=lambda p: (-p[0], p[1]))


def _wave_round_sharded(tb: Tables, cry: Carry, g: int, st: dict, capacity, base_feas, j,
                        placed: int, m: int, w: ScoreWeights, B: int, K: int, mesh):
    """One round of the wave's per-round sharded path (the plain version of
    K10, csrc/wave_rounds.cu): `_wave_iteration` with every stage on this
    rank's node block but the merge and j, and four collectives.

    1. the block's front and table (`_wave_block_front`): pmax #1;
    2. the block's summary: its first two maxima of the hidden-entry bound
       and its best head, as (value, global index), and its feasible count:
       all_gather_rows #1;
    3. the guard from the global pairs, then the block's top
       c = min(K, m - placed, NL*B) usable entries in pick order (score
       desc, global flat index n*B+k asc), padded with -inf, with their
       exhaust flags and the block's guarded count: all_gather_rows #2;
    4. the merge: the top min(K, m - placed) of the gathered entries, which
       are the unsharded top (the keys are distinct and every block offers
       its own top), then the nodes they exhaust on the block and the
       block's maxima without them: pmax #2;
    5. the stop at the first exhausting pick, the head fallback from the
       gathered heads and j += the counts, the same on every rank.
    Returns what `_wave_iteration` returns."""
    from ..parallel.collectives import all_gather_rows, pmax

    N = j.shape[0]
    dev = j.device
    sl = _block_of(mesh, N)
    lo, NL = sl.start, sl.stop - sl.start
    ninf = float("-inf")
    norms, table_ext, F_l, avail_l = _wave_block_front(tb, cry, g, st, capacity, base_feas, j,
                                                       w, B, mesh)
    # ---- the block's summary
    table, ks, usable, bound = _usable_and_bound(table_ext, avail_l, F_l, B)
    i1 = int(torch.argmax(bound))
    bound2 = bound.clone()
    bound2[i1] = ninf
    i2 = int(torch.argmax(bound2))
    heads = torch.where(F_l, table[:, 0], ninf)
    ih = int(torch.argmax(heads))
    summary = torch.tensor([[float(bound[i1]), lo + i1, float(bound2[i2]), lo + i2,
                             float(heads[ih]), lo + ih, int(F_l.sum())]],
                           dtype=torch.float64, device=dev)
    rows = all_gather_rows(summary, mesh).tolist()
    # ---- the guard from the global pairs, the block's top c
    firsts = [(r[0], r[1]) for r in rows]
    b1, g1 = _first_max(firsts)
    win = firsts.index((b1, g1))
    b2, g2 = _first_max(firsts[:win] + firsts[win + 1:] + [(rows[win][2], rows[win][3])])
    iota_l = torch.arange(lo, lo + NL, dtype=torch.int32, device=dev)
    is1 = iota_l == int(g1)
    cut_s = torch.where(is1, torch.tensor(b2, dtype=_F32, device=dev),
                        torch.tensor(b1, dtype=_F32, device=dev))
    cut_i = torch.where(is1, int(g2), int(g1)).to(torch.int32)
    usable, guarded_l = _guarded(table, usable, iota_l, cut_s, cut_i)
    m_rem = m - placed
    c = min(K, m_rem, NL * B)
    vals_l, pos_l = _top_k(torch.where(usable, table, ninf).reshape(-1), c)
    exhaust = ((ks == (avail_l[:, None] - 1)) & usable).reshape(-1)
    cand = torch.stack([vals_l.double(), (pos_l + lo * B).double(),
                        exhaust[pos_l].double()], dim=1)
    tail = torch.tensor([[guarded_l, 0.0, 0.0]], dtype=torch.float64, device=dev)
    got = all_gather_rows(torch.cat([cand, tail]), mesh).view(mesh.shards, c + 1, 3)
    guarded = int(got[:, c, 0].sum())
    ent = got[:, :c].reshape(-1, 3)
    # ---- the merge: (score desc, flat asc) over every rank's entries
    flat = ent[:, 1].long()
    o1 = torch.argsort(flat, stable=True)
    o2 = torch.argsort(ent[o1, 0].to(_F32), descending=True, stable=True)
    top = o1[o2][:min(K, m_rem)]
    vals, idx_srt, ex_srt = ent[top, 0].to(_F32), flat[top] // B, ent[top, 2] > 0
    pos = torch.arange(top.shape[0], dtype=torch.int64, device=dev)
    n_finite = int(torch.isfinite(vals).sum())
    m_cand = min(m_rem, n_finite)

    def counts_of(take: int) -> torch.Tensor:
        return torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
            0, idx_srt, (pos < take).to(torch.int32))

    leaves_l = counts_of(m_cand)[sl] >= torch.clamp(avail_l, min=1)
    norms_end = _reduced_norms(pmax(_block_norm_partials(st, F_l & ~leaves_l), mesh))
    # ---- finish: the same on every rank
    same = all(bool(a == b) for a, b in zip(norms, norms_end))  # ±inf equal themselves
    p_ex = int(torch.amin(torch.where(ex_srt & (pos < m_cand), pos, N * B)))
    m_take = m_cand if same else min(m_cand, p_ex + 1)
    counts = counts_of(m_take)
    n_feasible = sum(int(r[6]) for r in rows)
    head = m_take == 0 and n_feasible > 0 and m_rem > 0
    if head:
        counts = torch.zeros(N, dtype=torch.int32, device=dev)
        counts[int(_first_max([(r[4], r[5]) for r in rows])[1])] = 1
        m_take = 1
    return j + counts, placed + m_take, m_take, {"head_fallbacks": int(head), "guarded": guarded}


@torch.inference_mode()
def schedule_wave_plain(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                        w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                        block: int = WAVE_BLOCK, kmax: int = 0, gpu_live: bool = False,
                        mesh=None):
    """Plain version of `schedule_wave_kernel`: place up to m pods of the
    wave-eligible group g, reproducing m serial steps. Returns (per-node
    counts [N] i32, placed, stats); the carry is not touched (the aggregate
    commit applies the counts). stats counts the loop's iterations, its
    head-fallback iterations and the entries the hidden-continuation guard
    deferred, summed over iterations. `gpu_live`: the group asks for shared
    GPU memory (no pre-assigned gpu-index): the GPU filter joins the base
    feasibility and GPU units clamp the capacity; the scores do not move.
    `mesh`: a partitioned node mesh (parallel/mesh.py): `tb` and `cry` are
    this rank's node block, the counts global. Where its epoch path applies,
    each iteration's front runs on the block with one `pmax` and one
    `all_gather_tiled` per iteration (JAX `loop_sharded` :1215-1260), and
    the selection on the gathered full-width rows; above the epoch limit its
    per-round path runs every stage on the block but the merge, with two
    `pmax` and two `all_gather_rows` per iteration (`_wave_round_sharded`).
    The result is the same."""
    N = global_nodes(tb, mesh)
    shards = _epoch_shards(mesh, N)
    rounds = _round_shards(mesh, N) > 1
    K = kmax if kmax else N * block
    base_feas, _ = feasibility(tb, cry, g, -1, True, filters, enable_gpu=gpu_live)
    st = _wave_statics(tb, cry, g, w)
    capacity = _base_capacity(tb, cry, g, cap1, base_feas, filters)
    if gpu_live:
        capacity = _gpu_capacity(tb, cry, g, capacity)
    j = torch.zeros(N, dtype=torch.int32, device=tb.alloc.device)
    placed, last_w = 0, 1
    stats = dict.fromkeys(WAVE_STATS, 0)
    while last_w > 0 and placed < m:
        if rounds:
            j, placed, last_w, it = _wave_round_sharded(tb, cry, g, st, capacity, base_feas, j,
                                                        placed, m, w, block, K, mesh)
        else:
            st_sel = st
            if shards > 1:
                norms, table_ext, F, avail, st_sel = _wave_front_sharded(
                    tb, cry, g, st, capacity, base_feas, j, w, block, mesh)
            else:
                avail = capacity - j  # copies left per node
                F = base_feas & (avail > 0)
                norms = _wave_norms(st, F)
                table_ext = _wave_score_table(tb, cry, st, norms, g, j, w, block)
            j, placed, last_w, it = _wave_iteration(st_sel, norms, table_ext, F, avail, j, placed,
                                                    m, block, K)
        stats["iterations"] += 1
        for k, v in it.items():
            stats[k] += v
    return j, placed, stats


def _commit_rows(tb: Tables, cry: Carry, g: int, j: torch.Tensor, gpu_live: bool) -> Carry:
    """The [N, *] carry rows after j[n] commits of group g on every node n
    (requested, nonzero, ports and, with `gpu_live`, the device ledger
    replayed one copy at a time on every node, JAX :1007-1031); the domain
    counters are `cry`'s. Node-local: the rows of a block need only the
    block's j."""
    jf = j.to(_F32)
    requested = cry.requested + tb.grp_requests[g][None, :] * jf[:, None]
    nonzero = cry.nonzero + tb.grp_nonzero[g][None, :] * jf[:, None]
    # a placed copy claims the group's host ports on its node (idempotent bits)
    pids = tb.grp_ports[g].long()
    port_used = cry.port_used.clone()
    port_used[:, pids] = port_used[:, pids] | ((pids > 0)[None, :] & (j > 0)[:, None])
    dev_used = cry.dev_used
    if gpu_live:
        gmem, gnum, safe_mem = _wave_gpu_params(tb, g)
        single = bool(tb.grp_gpu_num[g] == 1)
        rem = torch.where(gmem > 0, j, torch.zeros_like(j))
        while bool(torch.any(rem > 0)):
            take = _gpu_take(tb.dev_total, dev_used, gmem, gnum, safe_mem, single)
            dev_used = dev_used + take * gmem * (rem > 0).to(_F32)[:, None]
            rem = rem - (rem > 0).to(rem.dtype)
    return cry._replace(requested=requested, nonzero=nonzero, port_used=port_used,
                        dev_used=dev_used)


def _topo_seg(tb: Tables, cry: Carry, j: torch.Tensor) -> torch.Tensor:
    """[U, D+1]: per unique topology key, the copies j puts in each domain
    (the sentinel column never counts). Integer-valued, exact in any order."""
    D = cry.counter.shape[1] - 1
    dom = tb.topo_dom.long()
    return torch.zeros((tb.topo_dom.shape[0], D + 1), dtype=_F32, device=j.device).scatter_add_(
        1, dom, j.to(_F32)[None, :] * (dom < D))


def _commit_counters(tb: Tables, cry: Carry, g: int, seg: torch.Tensor) -> tuple:
    """(counter, carrier) after the per-topology domain counts `seg`:
    counter/carrier rows of one topology key share their domain row."""
    counter = (cry.counter + tb.counter_sel_match_g[:, g, None].to(_F32)
               * seg[tb.counter_topo.long()])
    carrier = cry.carrier + tb.grp_carries[g][:, None] * seg[tb.carr_topo.long()]
    return counter, carrier


@torch.inference_mode()
def aggregate_commit_plain(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                           gpu_live: bool = False) -> Carry:
    """The sum of sum(j) serial commit() calls for group g (j = per-node
    counts), as one update of the carry; returns a new Carry. Plain version
    of `aggregate_commit_kernel`. With `gpu_live`, the device ledger replays
    the allocator one copy at a time on every node (JAX :1007-1031), so it
    equals the serial commits' ledger bit for bit."""
    counter, carrier = _commit_counters(tb, cry, g, _topo_seg(tb, cry, j))
    return _commit_rows(tb, cry, g, j, gpu_live)._replace(counter=counter, carrier=carrier)


@torch.inference_mode()
def aggregate_commit_sharded_plain(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                                   gpu_live: bool = False, mesh=None) -> Carry:
    """Plain version of `aggregate_commit_sharded_kernel` (K14): the commit
    on a partitioned node `mesh`, `tb`, `cry` and the counts `j` [NL] this
    rank's block. The block's [NL, *] rows take their copies as
    `aggregate_commit_plain` does (node-local, the device ledger included);
    the replicated `counter` / `carrier` take the per-domain counts of every
    block: each block's [U, D+1] partial rides ONE all_gather_rows and the
    partials add in rank order (integer-valued: exact). Returns the block's
    new carry."""
    from ..parallel.collectives import all_gather_rows

    rows = all_gather_rows(_topo_seg(tb, cry, j)[None], mesh)
    seg = rows[0]
    for r in range(1, rows.shape[0]):
        seg = seg + rows[r]
    counter, carrier = _commit_counters(tb, cry, g, seg)
    return _commit_rows(tb, cry, g, j, gpu_live)._replace(counter=counter, carrier=carrier)


@torch.inference_mode()
def schedule_group_serial_plain(tb: Tables, cry: Carry, g: int, valid, cap1: bool,
                                w: ScoreWeights = DEFAULT_WEIGHTS,
                                filters: FilterFlags = DEFAULT_FILTERS,
                                ss_live: bool = False, sa_live: bool = False, n_zones: int = 2):
    """Plain version of `schedule_group_serial_kernel`: the serial scan of one
    group whose placements feed its own DoNotSchedule filter (live [Sd, D+1]
    counter rows), SelectorSpread score (ss_live: per-node counts base + j
    with the zone blend) and ScheduleAnyway score (sa_live: live [Ss, D+1]
    rows). Everything else a step reads is constant within the run and
    hoisted. `valid` [P] bool marks real pods. Returns (per-node counts [N]
    i32, placed); the carry is not touched."""
    N = tb.alloc.shape[0]
    D = cry.counter.shape[1] - 1
    dev = tb.alloc.device
    ninf = torch.tensor(float("-inf"), device=dev)
    base_feas, _ = feasibility(tb, cry, g, -1, True, filters, include_dns=False)
    st = _wave_statics(tb, cry, g, w)
    capacity = _base_capacity(tb, cry, g, cap1, base_feas, filters)

    dvalid, dids = _slot_ids(tb.dns_t[g])
    dom_rows = tb.counter_dom[dids].long()  # [Sd, N]
    key_present = dom_rows < D
    edom = tb.dns_edom[g]
    dself = tb.dns_self[g][:, None]
    dskew = tb.dns_maxskew[g][:, None]
    dmatch = (tb.counter_sel_match_g[dids, g] & dvalid).to(_F32)
    Sd = dids.shape[0]
    a_c, a_m = tb.alloc[:, CPU_I], tb.alloc[:, MEM_I]
    gnz = tb.grp_nonzero[g]
    if ss_live:
        # the group's own SelectorSpread counter is hostname-topology, so the
        # per-node counts are exactly base + j
        ss_id = torch.clamp(tb.ss_t[g], min=0).reshape(1).long()
        base_pernode = counter_rows_at(tb, cry, ss_id)[1][0]
        Z = max(2, n_zones)
    if sa_live:
        svalid, sidx = _slot_ids(tb.sa_t[g])
        sa_dom_rows = tb.counter_dom[sidx].long()  # [Ss, N]
        sa_ignored = torch.any(svalid[:, None] & (sa_dom_rows >= D), dim=0)
        sa_match = (tb.counter_sel_match_g[sidx, g] & svalid).to(_F32)
        sa_maxskew = tb.sa_maxskew[g]
        Ss = sidx.shape[0]

    state = SerialState(j=torch.zeros(N, dtype=torch.int32, device=dev),
                        cnt=cry.counter[dids].clone(),
                        cnt_sa=(cry.counter[sidx].clone() if sa_live
                                else torch.zeros((1, D + 1), dtype=_F32, device=dev)))
    j, cnt, cnt_sa = state
    placed = 0
    for ok in torch.as_tensor(valid).tolist():
        if not ok:  # padded pod: commits nothing
            continue
        # live DoNotSchedule filter, term for term as in feasibility()
        cnt_at = torch.gather(cnt, 1, dom_rows)
        min_c = torch.amin(torch.where(edom, cnt, float("inf")), dim=1)
        min_c = torch.where(torch.isfinite(min_c), min_c, 0.0)
        dns_ok_each = key_present & (cnt_at + dself - min_c[:, None] <= dskew)
        dns_ok = torch.all(dns_ok_each | ~dvalid[:, None], dim=0)
        F = base_feas & (capacity - j > 0) & dns_ok
        if not torch.any(F):  # nothing feasible: no commit, and F stays empty
            continue
        # the candidate pod counts toward its own usage, hence j + 1
        used = cry.nonzero + gnz[None, :] * (j + 1).to(_F32)[:, None]
        least, balanced = least_balanced(used[:, 0], used[:, 1], a_c, a_m)
        lb = w.least * least + w.balanced * balanced
        simon, nodeaff, taint, interpod = _normalized_terms(st, _wave_norms(st, F))
        score = (lb + (w.simon + w.gpushare) * simon + w.nodeaff * nodeaff + w.taint * taint
                 + w.interpod * interpod + st["static"])
        if ss_live:
            pernode = base_pernode + j.to(_F32)
            maxN = torch.clamp(torch.amax(torch.where(F, pernode, ninf)), min=0.0)
            score = score + w.ss * _flr(selector_spread_score(pernode, F, tb.node_zone, Z, maxN))
        if sa_live:
            cnt_at_sa = torch.gather(cnt_sa, 1, sa_dom_rows)
            score = score + w.pts * schedule_anyway_score(
                cnt_at_sa, F & ~sa_ignored, sa_dom_rows, svalid, sa_maxskew, D)
        choice = int(torch.argmax(torch.where(F, score, ninf)))
        j[choice] += 1
        placed += 1
        cnt[torch.arange(Sd, device=dev), dom_rows[:, choice]] += dmatch
        if sa_live:
            # sentinel-masked like commit(): a pod may land on a node missing
            # the ScheduleAnyway topology key (a score-only plugin)
            sa_dom_c = sa_dom_rows[:, choice]
            cnt_sa[torch.arange(Ss, device=dev), sa_dom_c] += sa_match * (sa_dom_c < D)
    return j, placed


# The partial vector of one group-serial pod on a block (K13's stage A):
# GS_HEAD maxima in max space, [simon, nodeaff, taint, ip, pernode, -simon,
# -ip, any feasible, any zoned feasible], then with ss_live the [Z] zone
# sums of the per-node counts and with sa_live the [Ss, D+1] domain marks.
GS_HEAD = 9


def _gs_reduce(rows: torch.Tensor, Z: int, ss_live: bool) -> torch.Tensor:
    """Every rank's group-serial partials ([ranks, K], rank order) reduced:
    max, but the zone sums, which add in rank order (integer-valued: exact)."""
    red = torch.amax(rows, dim=0)
    if ss_live:
        zs = rows[0, GS_HEAD:GS_HEAD + Z]
        for r in range(1, rows.shape[0]):
            zs = zs + rows[r, GS_HEAD:GS_HEAD + Z]
        red[GS_HEAD:GS_HEAD + Z] = zs
    return red


@torch.inference_mode()
def schedule_group_serial_sharded_plain(tb: Tables, cry: Carry, g: int, valid, cap1: bool,
                                        mesh, w: ScoreWeights = DEFAULT_WEIGHTS,
                                        filters: FilterFlags = DEFAULT_FILTERS,
                                        ss_live: bool = False, sa_live: bool = False,
                                        n_zones: int = 2):
    """Plain version of `schedule_group_serial_sharded_kernel` (K13): the
    group-serial scan on a partitioned node `mesh`, `tb` and `cry` this
    rank's block of NL nodes. K4's hoisted per-run state (the base
    feasibility without DoNotSchedule, the capacity, the constant score
    terms, the SelectorSpread base counts) is the block's; the live
    DoNotSchedule and ScheduleAnyway rows are replicated. Per valid pod, as
    K13's stages:

    A. the live DoNotSchedule filter on the block and the block's partials
       (GS_HEAD maxima, the zone sums, the ScheduleAnyway domain marks):
       all_gather_rows #1, reduced in rank order;
    A2. with sa_live, the raw ScheduleAnyway scores with the global
       topology sizes and their block extrema: pmax #1b;
    B. the score and the block's first max as (score, global node, -inf
       without a feasible node) with the node's DoNotSchedule and
       ScheduleAnyway domain columns: all_gather_rows #2;
    C. on every rank the global first max and the live rows' update; on the
       owning rank j += 1 at the node.

    A pod with no feasible node anywhere places nothing and changes nothing
    (every later pod finds none either), so every valid pod makes the same
    collectives. Returns (the block's per-node counts [NL] i32, placed,
    equal on every rank)."""
    from ..parallel.collectives import all_gather_rows, pmax

    NL = tb.alloc.shape[0]
    D = cry.counter.shape[1] - 1
    dev = tb.alloc.device
    lo = mesh.rank * NL
    ninf = torch.tensor(float("-inf"), device=dev)
    base_feas, _ = feasibility(tb, cry, g, -1, True, filters, include_dns=False)
    st = _wave_statics(tb, cry, g, w)
    capacity = _base_capacity(tb, cry, g, cap1, base_feas, filters)
    Z = max(2, n_zones)

    dvalid, dids = _slot_ids(tb.dns_t[g])
    dom_rows = tb.counter_dom[dids].long()  # [Sd, NL]
    key_present = dom_rows < D
    edom = tb.dns_edom[g]
    dself = tb.dns_self[g][:, None]
    dskew = tb.dns_maxskew[g][:, None]
    dmatch = (tb.counter_sel_match_g[dids, g] & dvalid).to(_F32)
    Sd = dids.shape[0]
    a_c, a_m = tb.alloc[:, CPU_I], tb.alloc[:, MEM_I]
    gnz = tb.grp_nonzero[g]
    ss_id = torch.clamp(tb.ss_t[g], min=0).reshape(1).long()
    base_pernode = counter_rows_at(tb, cry, ss_id)[1][0]
    svalid, sidx = _slot_ids(tb.sa_t[g])
    sa_dom_rows = tb.counter_dom[sidx].long()  # [Ss, NL]
    sa_ignored = torch.any(svalid[:, None] & (sa_dom_rows >= D), dim=0)
    sa_match = (tb.counter_sel_match_g[sidx, g] & svalid).to(_F32)
    Ss = sidx.shape[0]

    j = torch.zeros(NL, dtype=torch.int32, device=dev)
    cnt = cry.counter[dids].clone()
    cnt_sa = cry.counter[sidx].clone()
    placed = 0
    for ok in torch.as_tensor(valid).tolist():
        if not ok:  # padded pod: commits nothing
            continue
        # ---- A: the live DoNotSchedule filter, the block's partials
        cnt_at = torch.gather(cnt, 1, dom_rows)
        min_c = torch.amin(torch.where(edom, cnt, float("inf")), dim=1)
        min_c = torch.where(torch.isfinite(min_c), min_c, 0.0)
        dns_ok_each = key_present & (cnt_at + dself - min_c[:, None] <= dskew)
        dns_ok = torch.all(dns_ok_each | ~dvalid[:, None], dim=0)
        F = base_feas & (capacity - j > 0) & dns_ok
        pernode = base_pernode + j.to(_F32)
        relF = F & ~sa_ignored
        heads = torch.stack([st["simon_s"], st["na_raw"], st["t_raw"], st["ip_raw"], pernode,
                             -st["simon_s"], -st["ip_raw"]])
        part = [torch.amax(torch.where(F[None, :], heads, ninf), dim=1),
                torch.stack([torch.any(F), torch.any(F & (tb.node_zone > 0))]).to(_F32)]
        if ss_live:
            part.append(_zone_sums(pernode, F, tb.node_zone, Z))
        if sa_live:
            part.append(_sa_marks(relF, sa_dom_rows, D).reshape(-1))
        red = _gs_reduce(all_gather_rows(torch.cat(part)[None], mesh), Z, ss_live)
        # ---- A2, B: the score on the block, its first max
        norms = _reduced_norms(torch.cat([red[:4], red[5:7]]))
        used = cry.nonzero + gnz[None, :] * (j + 1).to(_F32)[:, None]
        least, balanced = least_balanced(used[:, 0], used[:, 1], a_c, a_m)
        lb = w.least * least + w.balanced * balanced
        simon, nodeaff, taint, interpod = _normalized_terms(st, norms)
        score = (lb + (w.simon + w.gpushare) * simon + w.nodeaff * nodeaff + w.taint * taint
                 + w.interpod * interpod + st["static"])
        if ss_live:
            maxN = torch.clamp(red[4], min=0.0)
            zs = red[GS_HEAD:GS_HEAD + Z]
            score = score + w.ss * _flr(_selector_spread_blend(pernode, tb.node_zone, zs,
                                                               red[8] > 0, maxN))
        if sa_live:
            o = GS_HEAD + (Z if ss_live else 0)
            marks = red[o:].view(Ss, D + 1)
            sa_raw = _sa_raw(torch.gather(cnt_sa, 1, sa_dom_rows), marks, svalid,
                             tb.sa_maxskew[g])
            sa_red = pmax(_sa_partials(sa_raw, relF), mesh)
            score = score + w.pts * _sa_normalized(sa_raw, relF, sa_red)
        masked = torch.where(F, score, ninf)
        i = int(torch.argmax(masked))
        row = torch.cat([torch.stack([masked[i].double(),
                                      torch.tensor(lo + i, dtype=torch.float64, device=dev)]),
                         dom_rows[:, i].double(), sa_dom_rows[:, i].double()])
        rows = all_gather_rows(row[None], mesh)
        # ---- C: the winner, the live rows
        best, c = _first_max([(r[0], r[1]) for r in rows[:, :2].tolist()])
        if best == float("-inf"):
            continue
        win = rows[int(c) // NL]
        cnt[torch.arange(Sd, device=dev), win[2:2 + Sd].long()] += dmatch
        if sa_live:
            # sentinel-masked like commit(): a pod may land on a node missing
            # the ScheduleAnyway topology key (a score-only plugin)
            sa_dom_c = win[2 + Sd:].long()
            cnt_sa[torch.arange(Ss, device=dev), sa_dom_c] += sa_match * (sa_dom_c < D)
        if int(c) // NL == mesh.rank:
            j[int(c) - lo] += 1
        placed += 1
    return j, placed


# -------------------------------------------------------------- affinity route ----
#
# Port of the JAX package's `schedule_affinity_wave` (ops/kernels.py
# :1287-2099, without the sharded branch): groups whose hard predicates read
# their own running placements (self-matching DoNotSchedule spread, required
# self-affinity, non-hostname required self-anti-affinity in either
# direction, live SelectorSpread). Each epoch builds one [N, B+1] table under
# the normalizers of the current feasible set, takes its top K_EP entries in
# serial's pick order and consumes them over multi-level rounds against
# per-domain budgets, accepted only when a normalizer sandwich proves the
# normalizers fixed; otherwise the epoch places serial's single next pick
# (the head fallback).

AFFINITY_STATS = ("epochs", "head_fallbacks", "multi_rounds")
# K5's stats row per lane (csrc/affinity_wave.cu K5_STATS, i32)
AFFINITY_CLUSTER_STATS = ("placed",) + AFFINITY_STATS + ("rounds",)
K_EP_MAX = 2048  # width of one epoch's candidate order (JAX K_EP = min(N*B, 2048))
LMAX = 32        # min-rise levels one multi-level round may take
# The default build of K5, K9 and K11 keys a candidate by (domain, position)
# in 32 bits, 11 of them the position: a wider domain axis takes the wide
# build (`_view`), whose key is 64-bit
AFFINITY_MAX_D1 = 1 << 21


class AffinityWaveState(NamedTuple):
    """The epoch loop's carry (the JAX `AffinityWaveState`): the only state an
    epoch changes. The plain loop keeps the scalars as Python ints."""

    j: torch.Tensor         # [N] i32: per-node copies placed so far
    cnt_dns: torch.Tensor   # [Sd, D+1] f32: DoNotSchedule counter rows
    cnt_aff: torch.Tensor   # [A, D+1] f32: required-affinity counter rows
    cnt_anti: torch.Tensor  # [Ba, D+1] f32: incoming anti-affinity counter rows
    cnt_car: torch.Tensor   # [Ca, D+1] f32: existing-pods-anti carrier rows
    cnt_cw: torch.Tensor    # [Cw, D+1] f32: weighted (hard) carrier rows
    cnt_ss: torch.Tensor    # [1, D+1] f32: SelectorSpread counter row
    placed: int
    last: int               # the last epoch's take (progress flag)
    ep_stats: tuple         # AFFINITY_STATS


def _sel(live: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Sum of per-slot rows over the live slots (integer-valued: exact)."""
    return torch.sum(torch.where(live[:, None], rows, torch.zeros_like(rows)), dim=0)


def _norm_vals(max_stack, min_stack, F):
    """Maxima of max_stack's rows and minima of min_stack's over F."""
    maxes = torch.amax(torch.where(F[None, :], max_stack, float("-inf")), dim=1)
    mins = torch.amin(torch.where(F[None, :], min_stack, float("inf")), dim=1)
    return maxes, mins


def _norms_eq(pairs) -> bool:
    # +-inf compare equal; no NaN can arise
    return all(bool(torch.all(a == b)) for a, b in pairs)


def _affinity_round(rs: dict, ep: dict) -> dict:
    """One multi-level round (JAX round_body): takes along the candidate
    order against the per-domain budgets at the current minimum."""
    D, INF_P = ep["D"], ep["INF_P"]
    dev = rs["taken_d"].device
    pos_k, cand, dom_srt, occ_all = ep["pos_k"], ep["cand"], ep["dom_srt"], ep["occ_all"]
    edom_live = ep["edom_live"]
    taken_d = rs["taken_d"]
    cnt_now = ep["cnt_live"] + taken_d * ep["inc_live"]
    min_c = torch.amin(torch.where(edom_live, cnt_now, float("inf")))
    min_c = torch.where(torch.isfinite(min_c), min_c, 0.0)
    q_dns = torch.clamp(ep["skew_live"] - ep["self_live"] + min_c - cnt_now + 1.0, min=0.0)
    q = q_dns if ep["dns_live"] else torch.where(cnt_now > 0, 0.0, 1.0)
    if not ep["has_budget"]:
        q = torch.full_like(q, float("inf"))
    q[D] = float("inf")  # absent-key nodes are never metered
    dl = dom_srt.long()
    t_e = taken_d[dl]
    q_e = q[dl]
    r_e = occ_all - t_e
    remaining = cand & (r_e >= 0)
    consumable = remaining & (r_e < q_e)
    m_left = ep["m_rem"] - rs["got"]

    # multi-level take: up to LMAX min-rises at once
    dom_cnt_e = cnt_now[dl]
    l_e = torch.clamp(r_e - q_e + 2.0, min=1.0)
    lc_e = dom_cnt_e + r_e + 1.0 - min_c
    elig_e = edom_live[dl]
    lc_ok = remaining & elig_e & (lc_e >= 1.0) & (lc_e <= float(LMAX))
    lc_i = torch.clamp(lc_e, 0.0, float(LMAX + 1)).to(torch.int32).long()
    minus1 = torch.full((LMAX + 2,), -1, dtype=torch.int32, device=dev)
    prise = minus1.scatter_reduce(0, lc_i, torch.where(lc_ok, pos_k, -1), reduce="amax")
    provided = torch.zeros(LMAX + 2, dtype=_F32, device=dev).index_add_(0, lc_i, lc_ok.to(_F32))
    delta = torch.where(edom_live, cnt_now - min_c, float("inf"))
    hist = torch.zeros(LMAX + 2, dtype=_F32, device=dev).index_add_(
        0, torch.clamp(delta, 0.0, float(LMAX + 1)).to(torch.int32).long(), edom_live.to(_F32))
    needed = torch.cumsum(hist, dim=0)
    lvl = torch.arange(LMAX + 2, device=dev)
    inner = (lvl >= 1) & (lvl <= LMAX)
    ok_l = torch.where(inner, (provided == needed[torch.clamp(lvl - 1, min=0)]).to(_F32), 1.0)
    L_used = int(torch.sum((torch.cumprod(ok_l, dim=0) > 0) & inner))
    P_L = int(torch.cummax(prise, dim=0).values[L_used])
    take_full = remaining & (l_e <= float(L_used)) & (pos_k <= P_L)
    n_full = int(torch.sum(take_full))
    use_full = ep["dns_live"] and L_used >= 1 and 0 < n_full <= m_left

    # single-rise take (the chronological tail, and the anti path)
    at_min = edom_live & (cnt_now == min_c) & ep["dns_live"]
    first_pos = torch.full((D + 1,), INF_P, dtype=torch.int32, device=dev).scatter_reduce(
        0, dl, torch.where(consumable, pos_k, INF_P), reduce="amin")
    rise = int(torch.amax(torch.where(at_min, first_pos, -1)))
    unreached = bool(torch.any(at_min & (first_pos >= INF_P)))
    p_rise = rise if bool(torch.any(at_min)) and not unreached else INF_P
    take_pre = consumable & (pos_k <= p_rise)
    rank = torch.cumsum(take_pre.to(torch.int32), dim=0)
    take_one = take_pre & (rank <= m_left)
    n_one = min(m_left, int(rank[-1]))

    take = take_full if use_full else take_one
    n_take = n_full if use_full else n_one
    N = rs["counts"].shape[0]
    counts_r = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
        0, ep["idx_srt"].long(), take.to(torch.int32))
    consumed_d = torch.zeros(D + 1, dtype=_F32, device=dev).index_add_(0, dl, take.to(_F32))
    # sandwich bookkeeping: domains blocked at the round start or consumed
    # to their budget (a multi-level round marks every eligible or touched
    # one), kept per domain: JAX ORs blocked_d[dom_live] into a per-node
    # mask, and dom_live is fixed within the epoch, so the node's bit is its
    # domain's (the sandwich expands it)
    blocked_d = (q < 1.0) | ((consumed_d >= q) & torch.isfinite(q))
    if use_full:
        blocked_d = blocked_d | edom_live | (consumed_d > 0)
    everb_d = rs["everb_d"] | (blocked_d & ep["has_budget"])
    real = torch.arange(D + 1, device=dev) < D
    return {"taken_d": taken_d + consumed_d * real, "counts": rs["counts"] + counts_r,
            "got": rs["got"] + n_take, "last": n_take, "everb_d": everb_d,
            "rounds": rs["rounds"] + int(n_take > 0),
            "full": rs["full"] + int(use_full and n_take > 0)}


def _zone_sums(pernode0, F, zn, Z: int) -> torch.Tensor:
    """The [Z] sums of the SelectorSpread counts over F by zone
    (integer-valued: exact in any order)."""
    return torch.zeros(Z, dtype=_F32, device=pernode0.device).index_add_(
        0, zn, torch.where(F, pernode0, 0.0))


def _affinity_usable_bound(table_ext, avail, k_cap, F_hi, B: int):
    """The candidates of n nodes' [n, B+1] rows: capacity, depth cap and
    the monotone prefix over F_hi (the usable-entry mask [n, B]), and each
    node's first hidden entry `bound` (-inf where none)."""
    n, dev = table_ext.shape[0], table_ext.device
    table = table_ext[:, :B]
    ks = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    in_cap = ks < torch.minimum(avail, k_cap)[:, None]
    step_ok = torch.cat([torch.ones((n, 1), dtype=torch.int32, device=dev),
                         (table[:, 1:] <= table[:, :-1]).to(torch.int32)], dim=1)
    mono = torch.cumprod(step_ok, dim=1) > 0
    usable = in_cap & mono & F_hi[:, None]
    first_bad = torch.amin(torch.where(mono, B, ks), dim=1)
    k_hid = torch.minimum(torch.clamp(first_bad, max=B), k_cap)
    has_hidden = (k_hid < avail) & F_hi
    bound = torch.where(has_hidden, torch.gather(table_ext, 1, k_hid.long()[:, None])[:, 0],
                        float("-inf"))
    return usable, bound


def _first_head(vals, F) -> int:
    """Serial's single next pick: the first maximum of vals over F."""
    return int(torch.argmax(torch.where(F, vals, float("-inf"))))


@torch.inference_mode()
def schedule_affinity_wave_plain(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                 ss_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                                 filters: FilterFlags = DEFAULT_FILTERS,
                                 block: int = WAVE_BLOCK, n_zones: int = 2, mesh=None):
    """Plain version of `schedule_affinity_wave_kernel`: place up to m pods
    of the affinity-route group g, exactly as m serial steps would. Returns
    (per-node counts [N] i32, placed, stats) with stats the AFFINITY_STATS
    dict (epochs, head-fallback epochs, productive multi-rounds); the carry is
    not touched (the aggregate commit applies the counts). `mesh`: a
    partitioned node mesh (`tb` and `cry` this rank's node block, the counts
    global). Where its epoch path applies, each epoch's front runs on the
    block, with one `pmax` and one `all_gather_tiled` per epoch (JAX
    `loop_sharded` :2068-2078), whose payload also carries the per-node
    values the tail reads (the normalizer inputs, the zone, the budget
    domain and every term's domain), and the tail on the gathered
    full-width rows; above the epoch limit its sharded tail runs every
    stage on the block but the rounds, with two to four collectives per
    epoch (`epoch_rounds`; JAX partitions the plain loop with GSPMD there,
    :2095). The result is the same."""
    N = global_nodes(tb, mesh)
    dev = tb.alloc.device
    B = block
    K_EP = min(N * B, K_EP_MAX)
    D = cry.counter.shape[1] - 1
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)
    pos_k = torch.arange(K_EP, dtype=torch.int32, device=dev)
    INF_P = N * B + 1
    ninf = torch.tensor(float("-inf"), device=dev)
    base_feas, _ = feasibility(tb, cry, g, -1, True, filters, include_dns=False,
                               include_interpod=False)
    st0 = _wave_statics(tb, cry, g, w)
    capacity = _base_capacity(tb, cry, g, cap1, base_feas, filters)
    match_g = tb.counter_sel_match_g[:, g]
    grp_carries = tb.grp_carries[g]

    # ---- term slots: ids, domain maps, live flags, seed rows
    dvalid, dids = _slot_ids(tb.dns_t[g])
    dom_dns = tb.counter_dom[dids].long()                   # [Sd, N]
    edom = tb.dns_edom[g]                                   # [Sd, D+1]
    dself, dskew = tb.dns_self[g], tb.dns_maxskew[g]
    live_dns = dvalid & match_g[dids] & (dself > 0)
    if not filters.spread:
        dvalid = torch.zeros_like(dvalid)
        live_dns = torch.zeros_like(live_dns)
    avalid, aids = _slot_ids(tb.req_aff_t[g])
    dom_aff = tb.counter_dom[aids].long()
    bvalid, bids = _slot_ids(tb.req_anti_t[g])
    dom_anti = tb.counter_dom[bids].long()
    live_anti = bvalid & match_g[bids]
    cavalid, ca_ids = _slot_ids(tb.carr_anti_t[g])
    dom_car = tb.carr_dom[ca_ids].long()
    car_inc = grp_carries[ca_ids]
    live_car = cavalid & (car_inc > 0)
    cwvalid, cw_ids = _slot_ids(tb.carr_w_t[g])
    dom_cw = tb.carr_dom[cw_ids].long()
    cw_w = tb.carr_w_w[g]
    cw_inc = grp_carries[cw_ids]
    live_cw = cwvalid & (cw_inc > 0)
    if not filters.interpod:
        avalid = torch.zeros_like(avalid)
        bvalid, live_anti = torch.zeros_like(bvalid), torch.zeros_like(live_anti)
        cavalid, live_car = torch.zeros_like(cavalid), torch.zeros_like(live_car)

    # static ip part: the preferred terms (their rows never move here)
    pvalid, pids = _slot_ids(tb.pref_t[g])
    _, pref_at, _, _ = counter_rows_at(tb, cry, pids)
    ip_pref = _masked_sum(pvalid, tb.pref_w[g][:, None] * pref_at)

    ss_idx = torch.clamp(tb.ss_t[g], min=0).reshape(1).long()
    dom_ss = tb.counter_dom[ss_idx].long()                  # [1, N]
    ss_match = (match_g[ss_idx] & (tb.ss_t[g] >= 0)).to(_F32)  # [1]
    zones = tb.node_zone.long()
    Z = max(2, n_zones)

    # counter increments of one placement (commit() semantics)
    inc_dns = (match_g[dids] & dvalid).to(_F32)
    inc_aff = (match_g[aids] & avalid).to(_F32)
    inc_anti = (match_g[bids] & bvalid).to(_F32)
    inc_car = car_inc * cavalid.to(_F32)
    inc_cw = cw_inc * cwvalid.to(_F32)

    # the composed budget meter: one live DNS term, or live anti terms that
    # share one topology (identical domain rows)
    n_dns = int(live_dns.sum())
    n_budget = n_dns + int(live_anti.sum()) + int(live_car.sum())
    has_budget = n_budget >= 1
    dom_sum = _sel(live_dns, dom_dns) + _sel(live_anti, dom_anti) + _sel(live_car, dom_car)
    dom_live = torch.div(dom_sum, max(n_budget, 1), rounding_mode="floor").to(torch.int32)
    # per node: every live budget term's domain is the composed one (the
    # budget composes when that holds on every node, over every block)
    same_n = torch.ones_like(dom_live, dtype=torch.bool)
    for live, dom in ((live_dns, dom_dns), (live_anti, dom_anti), (live_car, dom_car)):
        same_n &= torch.all(~live[:, None] | (dom == dom_live[None, :].long()), dim=0)

    def composes(doms_same: bool) -> bool:
        return n_budget <= 1 or (n_dns == 0 and doms_same)
    edom_live = _sel(live_dns, edom.to(_F32)) > 0           # [D+1]
    ep = {
        "D": D, "INF_P": INF_P, "pos_k": pos_k, "edom_live": edom_live,
        "skew_live": torch.sum(torch.where(live_dns, dskew, 0.0)),
        "self_live": torch.sum(torch.where(live_dns, dself, 0.0)),
        "dns_live": n_dns > 0, "has_budget": has_budget,
        "inc_live": (torch.sum(torch.where(live_dns, inc_dns, 0.0))
                     + torch.sum(torch.where(live_anti, inc_anti, 0.0))
                     + torch.sum(torch.where(live_car, inc_car, 0.0))),
    }
    dns_key_live_ok = torch.all((dom_dns < D) | ~live_dns[:, None], dim=0)
    aff_self = bool(tb.grp_aff_self[g])
    has_aff = bool(torch.any(avalid))
    has_live_cw = bool(torch.any(live_cw))

    # the node-axis inputs of the epoch front: the full [N] (or [slots, N])
    # arrays, or this rank's block of each on a partitioned mesh (every
    # operation of `head` is per node or reads the replicated [slots, D+1]
    # rows: the same floats)
    nd = {"feas": base_feas, "cap": capacity, "dom_dns": dom_dns, "dom_aff": dom_aff,
          "dom_anti": dom_anti, "dom_car": dom_car, "dom_cw": dom_cw, "dom_ss": dom_ss,
          "ip_pref": ip_pref, "key_ok": dns_key_live_ok, "simon_s": st0["simon_s"],
          "na_raw": st0["na_raw"], "t_raw": st0["t_raw"], "static": st0["static"]}
    # every term's domain rows, in the fold's order (`finish`)
    fold_keys = ("dom_dns", "dom_aff", "dom_anti", "dom_car", "dom_cw", "dom_ss")
    fold_sizes = [nd[k].shape[0] for k in fold_keys]
    fold_nd = torch.cat([nd[k] for k in fold_keys])
    lo_blk = _block_of(mesh, N).start if _partitioned(mesh) else 0

    def norm_stacks(nd, ip_raw, pernode0):
        rows = [nd["simon_s"], nd["na_raw"], nd["t_raw"], ip_raw]
        if ss_live:
            rows.append(pernode0)
        return torch.stack(rows), torch.stack([nd["simon_s"], ip_raw])

    def head(j_w, cnts, nd):
        """The epoch's live gates, feasible sets and live-score stacks from
        the epoch-start rows (JAX epoch_head :1586)."""
        cnt_dns, cnt_aff, cnt_anti, cnt_car, cnt_cw, cnt_ss = cnts
        dom_dns, dom_aff, dom_cw = nd["dom_dns"], nd["dom_aff"], nd["dom_cw"]
        avail = nd["cap"] - j_w

        # ---- live gates from the epoch-start rows (feasibility() term for term)
        cnt_at_d = torch.gather(cnt_dns, 1, dom_dns)
        min_d = torch.amin(torch.where(edom, cnt_dns, float("inf")), dim=1)
        min_d = torch.where(torch.isfinite(min_d), min_d, 0.0)
        skew_ok = (dom_dns < D) & (cnt_at_d + dself[:, None] - min_d[:, None] <= dskew[:, None])
        dns_ok = torch.all(skew_ok | ~dvalid[:, None], dim=0)
        dns_ok_static = torch.all(skew_ok | ~dvalid[:, None] | live_dns[:, None], dim=0)
        at_a = torch.gather(cnt_aff, 1, dom_aff)
        aff_all = torch.all(((dom_aff < D) & (at_a > 0)) | ~avalid[:, None], dim=0)
        totals_a = torch.sum(cnt_aff[:, :D], dim=1)
        total_aff = torch.sum(torch.where(avalid, totals_a, 0.0))
        bootstrap = has_aff and bool(total_aff == 0.0) and aff_self
        aff_ok = torch.ones_like(aff_all) if bootstrap else aff_all
        at_b = torch.gather(cnt_anti, 1, nd["dom_anti"]) > 0
        blocked_in = torch.any(at_b & bvalid[:, None], dim=0)
        blocked_in_st = torch.any(at_b & bvalid[:, None] & ~live_anti[:, None], dim=0)
        at_c = torch.gather(cnt_car, 1, nd["dom_car"]) > 0
        blocked_ex = torch.any(at_c & cavalid[:, None], dim=0)
        blocked_ex_st = torch.any(at_c & cavalid[:, None] & ~live_car[:, None], dim=0)
        # F_start: serial's current feasible set; F_hi: live budget gates
        # lifted (the sandwich's upper set)
        room = nd["feas"] & (avail > 0) & aff_ok
        F_start = room & dns_ok & ~blocked_in & ~blocked_ex
        F_hi = room & dns_ok_static & ~blocked_in_st & ~blocked_ex_st & nd["key_ok"]

        # ---- live scores: ip_raw from the live carrier rows, ss per node
        cw_at = torch.gather(cnt_cw, 1, dom_cw)
        ip_raw = nd["ip_pref"] + _masked_sum(cwvalid, cw_w[:, None] * cw_at)
        pernode0 = torch.gather(cnt_ss, 1, nd["dom_ss"])[0]
        max_stack, min_stack = norm_stacks(nd, ip_raw, pernode0)
        return avail, F_start, F_hi, bootstrap, ip_raw, pernode0, max_stack, min_stack

    def apply_zone(table_ext, maxes_s, pernode0, zn, zone_sums, have_zones):
        """The live SelectorSpread blend and depth caps (JAX apply_zone
        :1680) on the rows of the nodes whose zones are zn, term for term:
        maxN and the zone sums frozen at the epoch start; column c = c
        earlier takes on the node. Returns (table_ext, k_cap)."""
        n = table_ext.shape[0]
        if not ss_live:
            return table_ext, torch.full((n,), B, dtype=torch.int32, device=dev)
        maxN = torch.clamp(maxes_s[4], min=0.0)
        pernode_k = pernode0[:, None] + torch.arange(B + 1, dtype=_F32, device=dev)[None, :]
        node_score = torch.where(maxN > 0, 100.0 * (maxN - pernode_k) / maxN, 100.0)
        maxZ = torch.amax(torch.cat([zone_sums.new_zeros(1), zone_sums[1:]]))
        zscore = torch.where(maxZ > 0, 100.0 * (maxZ - zone_sums[zn]) / maxZ, 100.0)
        blended = torch.where((have_zones & (zn > 0))[:, None],
                              node_score * (1.0 / 3.0) + zscore[:, None] * (2.0 / 3.0),
                              node_score)
        table_ext = table_ext + w.ss * _flr(blended)
        # depth cap: a take past the frozen maxN would move it
        k_cap = torch.clamp(maxN - pernode0, 0.0, float(B)).to(torch.int32)
        return table_ext, k_cap

    def norms_of(maxes_s, mins_s):
        """Serial's six normalizers over F_start."""
        return (maxes_s[0], mins_s[0], torch.clamp(maxes_s[1], min=0.0),
                torch.clamp(maxes_s[2], min=0.0), torch.clamp(maxes_s[3], min=0.0),
                torch.clamp(mins_s[1], max=0.0))

    def block_table(nd_l, ip_raw_l, maxes_s, mins_s, j_l):
        """The [NL, B+1] score rows of this rank's node block under serial's
        normalizers, without the SelectorSpread blend."""
        st_l = {"simon_s": nd_l["simon_s"], "na_raw": nd_l["na_raw"], "t_raw": nd_l["t_raw"],
                "static": nd_l["static"], "ip_raw": ip_raw_l}
        return _wave_score_table_rows(tb.alloc[:, CPU_I], tb.alloc[:, MEM_I], cry.nonzero,
                                      tb.grp_nonzero[g], st_l, norms_of(maxes_s, mins_s), j_l,
                                      w, B)

    def block_partials(max_stack, min_stack, F_start, F_hi, dom_cw_n):
        """One stacked vector of maxima over a node block, every normalizer
        reduction of the epoch in max space (mins negated): over F_start and
        F_hi the maxima of max_stack and of -min_stack, over F_hi those of
        -max_stack[:4] and of each weighted carrier's domain and its
        negation (JAX front_sharded :1996-2010)."""
        def mred(stack, Fm):
            return torch.amax(torch.where(Fm[None, :], stack, float("-inf")), dim=1)

        dom_cw_f = dom_cw_n.to(_F32)  # exact: domain ids < 2**24
        return torch.cat([
            mred(max_stack, F_start), mred(-min_stack, F_start),
            mred(max_stack, F_hi), mred(-min_stack, F_hi), mred(-max_stack[:4], F_hi),
            torch.amax(torch.where(F_hi[None, :], dom_cw_f, -1.0), dim=1),
            torch.amax(torch.where(F_hi[None, :], -dom_cw_f, -float(D + 2)), dim=1)])

    def reduced_vals(red):
        """The epoch's reductions from a reduced `block_partials` vector:
        (maxes_s, mins_s, maxes_h, mins_h, base_hi_min, dmax, dmin)."""
        ns = 5 if ss_live else 4
        Cw = dom_cw.shape[0]
        o = 2 * ns + 4
        return (red[:ns], -red[ns:ns + 2], red[ns + 2:o - 2], -red[o - 2:o], -red[o:o + 4],
                red[o + 4:o + 4 + Cw], -red[o + 4 + Cw:])

    def gates(maxes_h, mins_h, base_hi_min, dmax, dmin, any_hi: bool):
        """(uniform_base, ip_safe): uniform normalizer inputs over F_hi pin
        every normalizer; the frozen table is exact only while ip_raw is
        uniform over F_hi (ip_hi / ip_lo are maxes_h[3] / mins_h[1]) and
        each live carrier's domain is single-valued there."""
        uniform_base = bool(torch.all(maxes_h[:4] == base_hi_min)) and any_hi
        dom_same = bool(torch.all(~live_cw | (dmax == dmin)))
        ip_safe = not has_live_cw or not any_hi or (dom_same and bool(maxes_h[3] == mins_h[1]))
        return uniform_base, ip_safe

    def front_full(j, cnts):
        """The unsharded epoch front (JAX front_full :1628)."""
        (avail, F_start, F_hi, bootstrap, ip_raw, pernode0, max_stack,
         min_stack) = head(j, cnts, nd)
        maxes_s, mins_s = _norm_vals(max_stack, min_stack, F_start)
        maxes_h, mins_h = _norm_vals(max_stack, min_stack, F_hi)
        base_hi_min = torch.amin(torch.where(F_hi[None, :], max_stack[:4], float("inf")), dim=1)
        dmax = torch.amax(torch.where(F_hi[None, :], dom_cw, -1), dim=1)
        dmin = torch.amin(torch.where(F_hi[None, :], dom_cw, D + 2), dim=1)
        uniform_base, ip_safe = gates(maxes_h, mins_h, base_hi_min, dmax, dmin,
                                      bool(torch.any(F_hi)))
        # ---- the score table under serial's current normalizers
        table_ext = _wave_score_table(tb, cry, dict(st0, ip_raw=ip_raw),
                                      norms_of(maxes_s, mins_s), g, j, w, B)
        have_zones = bool(torch.any(F_start & (zones > 0)))
        zone_sums = _zone_sums(pernode0, F_start, zones, Z) if ss_live else None
        table_ext, k_cap = apply_zone(table_ext, maxes_s, pernode0, zones, zone_sums, have_zones)
        # the zone sums move with every zoned take
        return (avail, F_start, F_hi, table_ext, k_cap, not (ss_live and have_zones), max_stack,
                min_stack, maxes_s, mins_s, maxes_h, mins_h, uniform_base, bootstrap, ip_safe,
                dom_live, fold_nd, composes(bool(torch.all(same_n))))

    def front_sharded(j, cnts):
        """The sharded epoch front (JAX front_sharded :1982-2066): `head` on
        this rank's node block, ONE pmax of every normalizer reduction in
        max space (`block_partials`), the table block, ONE tiled all-gather
        of [table.T; F_start; F_hi; min(avail, B+1); ip_raw (; pernode0)]
        and the per-node values the tail reads: [simon_s; nodeaff; taint;
        zone; dom_live; same_n] and every term's domain; then the
        full-width values of `front_full`."""
        from ..parallel.collectives import all_gather_tiled, pmax

        sl = _block_of(mesh, N)
        (avail_l, F_start_l, F_hi_l, bootstrap, ip_raw_l, pernode0_l, max_stack_l,
         min_stack_l) = head(j[sl], cnts, nd)
        red = pmax(block_partials(max_stack_l, min_stack_l, F_start_l, F_hi_l, nd["dom_cw"]),
                   mesh)
        maxes_s, mins_s, maxes_h, mins_h, base_hi_min, dmax, dmin = reduced_vals(red)
        table_l = block_table(nd, ip_raw_l, maxes_s, mins_s, j[sl])
        rows = [table_l.T, F_start_l[None].to(_F32), F_hi_l[None].to(_F32),
                torch.clamp(avail_l, max=B + 1)[None].to(_F32), ip_raw_l[None]]
        if ss_live:
            rows.append(pernode0_l[None])
        o = B + 4 + (2 if ss_live else 1)
        rows += [torch.stack([nd["simon_s"], nd["na_raw"], nd["t_raw"]]),
                 torch.stack([zones, dom_live.long(), same_n.long()]).to(_F32), fold_nd.to(_F32)]
        full = all_gather_tiled(torch.cat(rows), mesh, axis=1)  # ids < 2**24: exact
        F_start, F_hi = full[B + 1] > 0, full[B + 2] > 0
        ip_raw, pernode0 = full[B + 4], (full[B + 5] if ss_live else None)
        nd_g = {"simon_s": full[o], "na_raw": full[o + 1], "t_raw": full[o + 2]}
        zones_g, dom_live_g = full[o + 3].long(), full[o + 4].to(torch.int32)
        doms_same = bool(torch.all(full[o + 5] > 0))
        fold_g = full[o + 6:].long()
        max_stack, min_stack = norm_stacks(nd_g, ip_raw, pernode0)
        uniform_base, ip_safe = gates(maxes_h, mins_h, base_hi_min, dmax, dmin,
                                      bool(torch.any(F_hi)))
        have_zones = bool(torch.any(F_start & (zones_g > 0)))
        zone_sums = _zone_sums(pernode0, F_start, zones_g, Z) if ss_live else None
        table_ext, k_cap = apply_zone(full[:B + 1].T, maxes_s, pernode0, zones_g, zone_sums,
                                      have_zones)
        return (full[B + 3].to(torch.int32), F_start, F_hi, table_ext, k_cap,
                not (ss_live and have_zones), max_stack, min_stack, maxes_s, mins_s, maxes_h,
                mins_h, uniform_base, bootstrap, ip_safe, dom_live_g, fold_g, composes(doms_same))

    front = front_sharded if _epoch_shards(mesh, N) > 1 else front_full

    def multi_pre(maxes_s, mins_s, maxes_h, mins_h, uniform_base, bootstrap, ip_safe,
                  ss_multi_ok, budget_composes: bool) -> bool:
        """Whether the epoch may take several pods: the budget composes, no
        bootstrap, ip and the zone sums frozen, and the normalizers of
        F_start equal those of F_hi."""
        pre_norms_ok = uniform_base or _norms_eq(zip((maxes_s[:4], mins_s),
                                                     (maxes_h[:4], mins_h)))
        if ss_live:
            pre_norms_ok = pre_norms_ok and bool(maxes_s[4] == maxes_h[4])
        return budget_composes and not bootstrap and ip_safe and ss_multi_ok and pre_norms_ok

    def run_rounds(vals_k, idx_srt, dom_srt, cnts, m_rem: int) -> dict:
        """The epoch's rounds over one candidate order (vals_k, the node
        idx_srt and its budget domain dom_srt at each of K_EP positions; the
        candidates are the finite values): each entry's rank among its
        domain's candidates, then rounds until one takes nothing or m_rem
        are taken, the condition read once per chain of four, as in JAX."""
        cand = torch.isfinite(vals_k)
        dkey = torch.where(cand, dom_srt, D + 1)
        d2, p2 = torch.sort(dkey, stable=True)
        run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), d2[1:] != d2[:-1]])
        seg_start = torch.cummax(torch.where(run_start, pos_k, 0), dim=0).values
        occ_all = torch.zeros(K_EP, dtype=_F32, device=dev)
        occ_all[p2] = (pos_k - seg_start).to(_F32)
        cnt_dns, _, cnt_anti, cnt_car = cnts[:4]
        cnt_live = _sel(live_dns, cnt_dns) + _sel(live_anti, cnt_anti) + _sel(live_car, cnt_car)
        ep.update(cand=cand, dom_srt=dom_srt, occ_all=occ_all, idx_srt=idx_srt,
                  cnt_live=cnt_live, m_rem=m_rem)
        rs = {"counts": torch.zeros(N, dtype=torch.int32, device=dev), "got": 0, "last": 1,
              "rounds": 0, "full": 0, "everb_d": torch.zeros(D + 1, dtype=torch.bool, device=dev),
              "taken_d": torch.zeros(D + 1, dtype=_F32, device=dev)}
        while rs["last"] > 0 and rs["got"] < m_rem:
            for _ in range(4):
                rs = _affinity_round(rs, ep)
        return rs

    def lo_ok(uniform_base, maxes_h, mins_h, maxes_l, mins_l) -> bool:
        """The sandwich's lower side: the normalizers of F_lo equal F_hi's."""
        ok = uniform_base or _norms_eq(zip((maxes_h[:4], mins_h), (maxes_l[:4], mins_l)))
        if ss_live:
            ok = ok and bool(maxes_h[4] == maxes_l[4])
        return ok

    def finish(state: AffinityWaveState, counts, m_take: int, use_head: bool,
               rounds: int, fold) -> AffinityWaveState:
        """Fold the epoch's takes into j and every counter/carrier row (the
        sentinel column never counts, as in commit()); `fold` holds every
        term's domain rows [slots, N] (`fold_nd`'s order) at least where
        counts is nonzero."""
        cf = counts.to(_F32)
        col_real = (torch.arange(D + 1, device=dev) < D).to(_F32)
        doms = torch.split(fold, fold_sizes)

        def upd(rows, k, incs):
            add = torch.zeros_like(rows).scatter_add_(1, doms[k], cf[None, :] * incs[:, None])
            return rows + add * col_real

        cnt_dns, cnt_aff, cnt_anti, cnt_car, cnt_cw, cnt_ss = state[1:7]
        e, h, r = state.ep_stats
        return AffinityWaveState(
            state.j + counts, upd(cnt_dns, 0, inc_dns), upd(cnt_aff, 1, inc_aff),
            upd(cnt_anti, 2, inc_anti), upd(cnt_car, 3, inc_car),
            upd(cnt_cw, 4, inc_cw), upd(cnt_ss, 5, ss_match),
            state.placed + m_take, m_take, (e + 1, h + int(use_head), r + rounds))

    def epoch(state: AffinityWaveState) -> AffinityWaveState:
        """One epoch on the full-width front (unsharded, or the sharded
        epoch path's gathered rows): JAX epoch_tail :1714-1964."""
        cnts = state[1:7]
        (avail, F_start, F_hi, table_ext, k_cap, ss_multi_ok, max_stack, min_stack, maxes_s,
         mins_s, maxes_h, mins_h, uniform_base, bootstrap, ip_safe, dom_live_f,
         fold, budget_composes) = front(state.j, cnts)
        table = table_ext[:, :B]
        m_rem = m - state.placed
        rs = None
        if multi_pre(maxes_s, mins_s, maxes_h, mins_h, uniform_base, bootstrap, ip_safe,
                     ss_multi_ok, budget_composes):
            # the hidden-continuation cut (the rounds never run when
            # use_multi_pre is off, so neither does this), then the top K_EP
            # entries in lax.top_k order (score desc, flat index asc)
            usable, bound = _affinity_usable_bound(table_ext, avail, k_cap, F_hi, B)
            b1, i1 = torch.amax(bound), torch.argmax(bound)
            bound2 = bound.clone()
            bound2[i1] = ninf
            b2, i2 = torch.amax(bound2), torch.argmax(bound2)
            cut_s = torch.where(iota_n == i1, b2, b1)
            cut_i = torch.where(iota_n == i1, i2, i1).to(torch.int32)
            usable = _guarded(table, usable, iota_n, cut_s, cut_i)[0]
            vals_k, flat_pos = _top_k(torch.where(usable, table, ninf).reshape(-1), K_EP)
            idx_srt = torch.div(flat_pos, B, rounding_mode="floor").to(torch.int32)
            rs = run_rounds(vals_k, idx_srt, dom_live_f[idx_srt.long()], cnts, m_rem)

        # ---- the normalizer sandwich: S_lo <= every F_t <= F_hi
        use_multi = False
        if rs is not None and rs["got"] > 0:
            F_lo = F_hi & ~rs["everb_d"][dom_live_f.long()] & ~(rs["counts"] >= avail)
            maxes_l, mins_l = _norm_vals(max_stack, min_stack, F_lo)
            use_multi = lo_ok(uniform_base, maxes_h, mins_h, maxes_l, mins_l)
        # the head fallback: serial's single next pick is always exact
        use_head = not use_multi and bool(torch.any(F_start)) and m_rem > 0
        if use_multi:
            return finish(state, rs["counts"], rs["got"], False, rs["rounds"], fold)
        counts = torch.zeros(N, dtype=torch.int32, device=dev)
        if use_head:
            counts[_first_head(table[:, 0], F_start)] = 1
        return finish(state, counts, int(use_head), use_head, 0, fold)

    def epoch_rounds(state: AffinityWaveState) -> AffinityWaveState:
        """One epoch of the sharded tail above the epoch limit (the plain
        version of K11, csrc/affinity_rounds.cu): every stage on this rank's
        node block [lo, hi) but the rounds, which run on every rank on the
        merged candidate order, with two, three or four collectives
        (parallel/mesh.py), each counted in `mesh.tail_branches`:
        1. `head` on the block, then all_gather_rows #1 of one row: the
           block's `block_partials`, the flags any(F_hi), any(F_start),
           any(F_start on a zone) and whether a block node's live budget
           terms leave its composed domain, and, with ss_live, the block's
           zone sums;
           every rank reduces the rows in rank order (the maxima by max, the
           integer-valued zone sums by a left-to-right sum);
        2. the table block with the SelectorSpread blend, and the block's
           summary: its first two maxima of the hidden-entry bound and its
           best head as (value, global node), and its usable count:
           all_gather_rows #2. Without use_multi_pre the epoch ends in the
           head fallback ("head");
        3. the guard from the global pairs, then the block's top c =
           min(K_EP, NL*B) entries in pick order (score desc, global flat
           index asc), padded with -inf, each with its node's dom_live and
           every term's domain there (the fold's): all_gather_rows #3; the
           top K_EP of the gathered entries is the unsharded top, and the
           rounds run on it with no collective ("select" when they take
           nothing);
        4. when they took pods, the block's maxima over F_lo (the domains
           ever blocked, expanded to the block): pmax #4 ("sandwich").
        The head fallback and the fold are the same on every rank: the
        summary row of #2 carries the domains of the block's best head too."""
        from ..parallel.collectives import all_gather_rows, pmax

        sl = _block_of(mesh, N)
        lo, NL = sl.start, sl.stop - sl.start
        cnts = state[1:7]
        m_rem = m - state.placed
        nd_l = nd
        (avail_l, F_start_l, F_hi_l, bootstrap, ip_raw_l, pernode0_l, max_stack_l,
         min_stack_l) = head(state.j[sl], cnts, nd_l)
        zn_l = zones
        # ---- #1: the block's reductions, reduced on every rank
        part = [block_partials(max_stack_l, min_stack_l, F_start_l, F_hi_l, nd_l["dom_cw"]),
                torch.stack([torch.any(F_hi_l), torch.any(F_start_l),
                             torch.any(F_start_l & (zn_l > 0)), torch.any(~same_n)]).to(_F32)]
        nv = part[0].shape[0] + 4
        if ss_live:
            part.append(_zone_sums(pernode0_l, F_start_l, zn_l, Z))
        rows1 = all_gather_rows(torch.cat(part)[None], mesh)
        red = torch.amax(rows1[:, :nv], dim=0)
        zone_sums = rows1[0, nv:]
        for r in range(1, mesh.shards):
            zone_sums = zone_sums + rows1[r, nv:]
        any_hi, any_start, have_zones, not_same = (bool(x) for x in red[nv - 4:] > 0)
        maxes_s, mins_s, maxes_h, mins_h, base_hi_min, dmax, dmin = reduced_vals(red[:nv - 4])
        uniform_base, ip_safe = gates(maxes_h, mins_h, base_hi_min, dmax, dmin, any_hi)
        use_multi_pre = multi_pre(maxes_s, mins_s, maxes_h, mins_h, uniform_base, bootstrap,
                                  ip_safe, not (ss_live and have_zones), composes(not not_same))
        # ---- #2: the table block and its summary
        table_l = block_table(nd_l, ip_raw_l, maxes_s, mins_s, state.j[sl])
        table_l, k_cap_l = apply_zone(table_l, maxes_s, pernode0_l, zn_l, zone_sums, have_zones)
        table = table_l[:, :B]
        heads = torch.where(F_start_l, table[:, 0], ninf)
        ih = int(torch.argmax(heads))
        summary = [float("-inf"), lo, float("-inf"), lo, float(heads[ih]), lo + ih, 0, 0]
        if use_multi_pre:
            usable_l, bound_l = _affinity_usable_bound(table_l, avail_l, k_cap_l, F_hi_l, B)
            i1 = int(torch.argmax(bound_l))
            bound2 = bound_l.clone()
            bound2[i1] = ninf
            i2 = int(torch.argmax(bound2))
            summary[:4] = [float(bound_l[i1]), lo + i1, float(bound2[i2]), lo + i2]
            summary[6] = int(usable_l.sum())
        summary = torch.cat([torch.tensor(summary, dtype=torch.float64, device=dev),
                             fold_nd[:, ih].double()])
        rows2 = all_gather_rows(summary[None], mesh).tolist()
        rs, branch = None, "head"
        if use_multi_pre:
            # ---- #3: the guard, the block's top c, the merge, the rounds
            branch = "select"
            firsts = [(r[0], r[1]) for r in rows2]
            b1, g1 = _first_max(firsts)
            win = firsts.index((b1, g1))
            b2, g2 = _first_max(firsts[:win] + firsts[win + 1:] + [(rows2[win][2], rows2[win][3])])
            iota_l = torch.arange(lo, lo + NL, dtype=torch.int32, device=dev)
            is1 = iota_l == int(g1)
            cut_s = torch.where(is1, torch.tensor(b2, dtype=_F32, device=dev),
                                torch.tensor(b1, dtype=_F32, device=dev))
            cut_i = torch.where(is1, int(g2), int(g1)).to(torch.int32)
            usable_l = _guarded(table, usable_l, iota_l, cut_s, cut_i)[0]
            vals_l, pos_l = _top_k(torch.where(usable_l, table, ninf).reshape(-1),
                                   min(K_EP, NL * B))
            ent = all_gather_rows(torch.cat([
                torch.stack([vals_l.double(), (pos_l + lo * B).double(),
                             dom_live[pos_l // B].double()], dim=1),
                fold_nd[:, pos_l // B].T.double()], dim=1), mesh)
            flat = ent[:, 1].long()
            o1 = torch.argsort(flat, stable=True)
            top = o1[torch.argsort(ent[o1, 0].to(_F32), descending=True, stable=True)][:K_EP]
            rs = run_rounds(ent[top, 0].to(_F32), (flat[top] // B).to(torch.int32),
                            ent[top, 2].to(torch.int32), cnts, m_rem)
        use_multi = False
        if rs is not None and rs["got"] > 0:
            # ---- #4: the sandwich's maxima over the block's F_lo
            branch = "sandwich"
            F_lo_l = (F_hi_l & ~rs["everb_d"][dom_live.long()]
                      & ~(rs["counts"][sl] >= avail_l))
            mx, mn = _norm_vals(max_stack_l, min_stack_l, F_lo_l)
            red4 = pmax(torch.cat([mx, -mn]), mesh)
            use_multi = lo_ok(uniform_base, maxes_h, mins_h, red4[:mx.shape[0]],
                              -red4[mx.shape[0]:])
        mesh.tail_branches[branch] += 1
        if branch == "sandwich":
            # the sandwich's verdict, and the accepted rounds by their take
            # (the multi-level one, or the single rise)
            if use_multi:
                mesh.tail_branches["full_rounds"] += rs["full"]
                mesh.tail_branches["rise_rounds"] += rs["rounds"] - rs["full"]
            else:
                mesh.tail_branches["rejected"] += 1
        use_head = not use_multi and any_start and m_rem > 0
        # every term's domain at the nodes the epoch may take: the merged
        # candidates' and the best head's
        fold = torch.zeros((fold_nd.shape[0], N), dtype=torch.long, device=dev)
        if use_multi:
            fold[:, (flat[top] // B)] = ent[top, 3:].T.long()
            return finish(state, rs["counts"], rs["got"], False, rs["rounds"], fold)
        counts = torch.zeros(N, dtype=torch.int32, device=dev)
        if use_head:
            heads_g = [(r[4], r[5]) for r in rows2]
            best = _first_max(heads_g)
            counts[int(best[1])] = 1
            fold[:, int(best[1])] = torch.tensor(rows2[heads_g.index(best)][8:],
                                                 dtype=torch.long, device=dev)
        return finish(state, counts, int(use_head), use_head, 0, fold)

    step = epoch_rounds if _round_shards(mesh, N) > 1 else epoch
    state = AffinityWaveState(
        torch.zeros(N, dtype=torch.int32, device=dev), cry.counter[dids], cry.counter[aids],
        cry.counter[bids], cry.carrier[ca_ids], cry.carrier[cw_ids], cry.counter[ss_idx],
        0, 1, (0, 0, 0))
    while state.last > 0 and state.placed < m:
        state = step(state)
    return state.j, state.placed, dict(zip(AFFINITY_STATS, state.ep_stats))


# ------------------------------------------------------------------ CUDA route ----
#
# csrc/schedule.cu holds both kernels; ops/build.py compiles it with nvcc for
# sm_90a into a shared library with a plain C interface, loaded with ctypes.
# The kernels read the tables through one `TablesView` struct of pointers and
# sizes, filled below from the tensors (field order must match the struct in
# schedule.cu; the library reports sizeof(TablesView) and the wrapper checks it).

_PTR_FIELDS = (
    # tables
    ("alloc", "alloc"), ("node_zone", "node_zone"), ("static_mask", "static_mask"),
    ("mask_taint", "mask_taint"), ("mask_unsched", "mask_unsched"),
    ("mask_aff", "mask_aff"), ("mask_extra", "mask_extra"),
    ("simon_raw", "simon_raw"), ("nodeaff_raw", "nodeaff_raw"),
    ("taint_raw", "taint_raw"), ("avoid_raw", "avoid_raw"), ("image_raw", "image_raw"),
    ("extra_raw", "extra_raw"), ("grp_requests", "grp_requests"),
    ("grp_nonzero", "grp_nonzero"), ("grp_unknown", "grp_unknown"),
    ("grp_ports", "grp_ports"), ("counter_dom", "counter_dom"),
    ("counter_sel_match_g", "counter_sel_match_g"), ("req_aff_t", "req_aff_t"),
    ("grp_aff_self", "grp_aff_self"), ("req_anti_t", "req_anti_t"),
    ("pref_t", "pref_t"), ("pref_w", "pref_w"), ("dns_t", "dns_t"),
    ("dns_maxskew", "dns_maxskew"), ("dns_self", "dns_self"), ("dns_edom", "dns_edom"),
    ("sa_t", "sa_t"), ("sa_maxskew", "sa_maxskew"), ("ss_t", "ss_t"),
    ("ss_skip", "ss_skip"), ("carr_dom", "carr_dom"), ("carr_anti_t", "carr_anti_t"),
    ("carr_w_t", "carr_w_t"), ("carr_w_w", "carr_w_w"), ("grp_carries", "grp_carries"),
    ("grp_gpu_mem", "grp_gpu_mem"), ("grp_gpu_num", "grp_gpu_num"),
    ("grp_gpu_pre", "grp_gpu_pre"), ("grp_gpu_take", "grp_gpu_take"),
    ("dev_total", "dev_total"), ("grp_lvm_size", "grp_lvm_size"),
    ("grp_lvm_vg", "grp_lvm_vg"), ("grp_sdev_size", "grp_sdev_size"),
    ("grp_sdev_media", "grp_sdev_media"), ("vg_cap", "vg_cap"), ("vg_nameid", "vg_nameid"),
    ("sdev_cap", "sdev_cap"), ("sdev_media", "sdev_media"),
    # carry
    ("requested", "requested"), ("nonzero", "nonzero"), ("port_used", "port_used"),
    ("counter", "counter"), ("carrier", "carrier"), ("dev_used", "dev_used"),
    ("vg_req", "vg_req"), ("sdev_alloc", "sdev_alloc"),
    # the lane kernels' [S, N] node-active masks (null for the single-lane kernels)
    ("active", "active"),
)
_DIM_FIELDS = ("N", "R", "G", "T", "Tc", "D1", "PORT1", "PP", "A", "B", "Cp", "Sd",
               "Ss", "Ca", "Cw", "Z", "MAXDEV", "MAXVG", "MAXSD", "SL", "SD",
               "f_fit", "f_ports", "f_interpod", "f_spread", "f_gpu", "f_storage")
N_WEIGHTS = 12  # least balanced openlocal simon nodeaff taint interpod ss pts avoid image extra(unused)
# The default build holds a group's term slots in arrays of MAX_SLOTS (shared
# memory) and a node's GPU devices, volume groups and storage devices in
# arrays of MAX_NODE_DEVS (a thread's): a table past one of them, or an
# affinity kernel's domain axis past AFFINITY_MAX_D1, takes the wide build
# (csrc/common.cuh OSIM_WIDE), which sizes them by the table's own axes
MAX_SLOTS = 64
SLOT_AXES = ("A", "B", "Cp", "Sd", "Ss", "Ca", "Cw", "PP", "SL", "SD")
MAX_NODE_DEVS = 32


class TablesView(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name, _ in _PTR_FIELDS]
                + [(name, ctypes.c_int) for name in _DIM_FIELDS]
                + [("w", ctypes.c_float * N_WEIGHTS)])


class WideTablesView(TablesView):
    """The wide build's view: TablesView and the launch's scratch, which the
    library fills in (csrc/common.cuh wide_open)."""
    _fields_ = [("wide_cta", ctypes.c_void_p), ("wide_thr", ctypes.c_void_p),
                ("wide_cta_words", ctypes.c_longlong), ("wide_thr_words", ctypes.c_longlong),
                ("wide_slots", ctypes.c_int)]


def wide_axes(dims: dict, enable_gpu: bool, enable_storage: bool,
              domains_capped: bool = False) -> Tuple[str, ...]:
    """The axes of a view's `dims` that pass the default build's caps: the
    slot axes past MAX_SLOTS, the node-device axes of a branch that is on
    past MAX_NODE_DEVS and, for the affinity kernels (`domains_capped`), D1
    past AFFINITY_MAX_D1. A kernel takes the wide build exactly when this
    is not empty."""
    devs = ("MAXDEV",) * bool(enable_gpu) + ("MAXVG", "MAXSD") * bool(enable_storage)
    return (tuple(k for k in SLOT_AXES if dims[k] > MAX_SLOTS)
            + tuple(k for k in devs if dims[k] > MAX_NODE_DEVS)
            + (("D1",) if domains_capped and dims["D1"] > AFFINITY_MAX_D1 else ()))


def _is_wide(v: TablesView) -> bool:
    return isinstance(v, WideTablesView)


def _lib(v: TablesView):
    """The library whose build takes the view: the wide one for a
    WideTablesView (built on its first use)."""
    from . import build

    return build.library(wide=_is_wide(v))


def _count(wrapper, n: int, v: TablesView) -> None:
    """Add n launches to the wrapper's count, and to its wide count when
    they ran in the wide build."""
    wrapper.launches += n
    if _is_wide(v):
        wrapper.wide_launches += n


class CarryOut(ctypes.Structure):
    """The new carry an out-of-place K3c writes (csrc/commit.cuh CarryOut):
    the Carry fields, in order."""
    _fields_ = [(name, ctypes.c_void_p) for name in Carry._fields]


def _carry_out(out: Carry) -> CarryOut:
    o = CarryOut()
    for name, t in zip(Carry._fields, out):
        setattr(o, name, t.data_ptr())
    return o


_EXPECT = {  # dtype each pointer field must have
    "node_zone": torch.int32, "grp_ports": torch.int32, "counter_dom": torch.int32,
    "req_aff_t": torch.int32, "req_anti_t": torch.int32, "pref_t": torch.int32,
    "dns_t": torch.int32, "sa_t": torch.int32, "ss_t": torch.int32,
    "carr_dom": torch.int32, "carr_anti_t": torch.int32, "carr_w_t": torch.int32,
    "static_mask": torch.bool, "mask_taint": torch.bool, "mask_unsched": torch.bool,
    "mask_aff": torch.bool, "mask_extra": torch.bool, "grp_unknown": torch.bool,
    "counter_sel_match_g": torch.bool, "grp_aff_self": torch.bool,
    "dns_edom": torch.bool, "ss_skip": torch.bool, "port_used": torch.bool,
    "grp_gpu_pre": torch.bool, "grp_lvm_vg": torch.int32, "grp_sdev_media": torch.int32,
    "vg_nameid": torch.int32, "sdev_media": torch.int32, "active": torch.bool,
}


def _view(tb: Tables, cry: Carry, n_zones: int, w: ScoreWeights,
          filters: FilterFlags, enable_gpu: bool = False,
          enable_storage: bool = False, active=None,
          domains_capped: bool = False) -> TablesView:
    """Check every tensor (device, dtype, contiguity) and fill the struct.
    `enable_gpu` / `enable_storage` switch the kernels' GPU-share and
    Open-Local branches on. A lane kernel passes lane 0 of its [S, ...]
    carry (`carry_lane(cry_s, 0, copy=False)`) and its [S, N] `active`.
    The view is a WideTablesView, which takes the wide build, exactly when
    `wide_axes` names an axis (`domains_capped`: the affinity kernels)."""
    dev = tb.alloc.device
    src = {**tb._asdict(), **cry._asdict(), "active": active}
    G = tb.static_mask.shape[0]
    dims = dict(
        N=tb.alloc.shape[0], R=tb.alloc.shape[1], G=G, T=tb.counter_dom.shape[0],
        Tc=tb.carr_dom.shape[0], D1=cry.counter.shape[1], PORT1=cry.port_used.shape[1],
        PP=tb.grp_ports.shape[1], A=tb.req_aff_t.shape[1], B=tb.req_anti_t.shape[1],
        Cp=tb.pref_t.shape[1], Sd=tb.dns_t.shape[1], Ss=tb.sa_t.shape[1],
        Ca=tb.carr_anti_t.shape[1], Cw=tb.carr_w_t.shape[1], Z=max(2, n_zones),
        MAXDEV=tb.dev_total.shape[1], MAXVG=tb.vg_cap.shape[1], MAXSD=tb.sdev_cap.shape[1],
        SL=tb.grp_lvm_size.shape[1], SD=tb.grp_sdev_size.shape[1],
        f_fit=int(filters.fit), f_ports=int(filters.ports),
        f_interpod=int(filters.interpod), f_spread=int(filters.spread),
        f_gpu=int(bool(enable_gpu)), f_storage=int(bool(enable_storage)))
    wide = wide_axes(dims, enable_gpu, enable_storage, domains_capped)
    v = WideTablesView() if wide else TablesView()
    for name, field in _PTR_FIELDS:
        t = src[field]
        if t is None and name == "active":
            continue
        want = _EXPECT.get(name, torch.float32)
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {want} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
        setattr(v, name, t.data_ptr())
    if tb.alloc.shape[1] <= max(CPU_I, MEM_I):
        raise ValueError("alloc needs the cpu and memory columns")
    for k, val in dims.items():
        setattr(v, k, int(val))
    weights = (w.least, w.balanced, w.openlocal, w.simon + w.gpushare, w.nodeaff,
               w.taint, w.interpod, w.ss, w.pts, w.avoid, w.image, 1.0)
    for i, x in enumerate(weights):
        v.w[i] = float(x)
    return v


# The view's node-axis fields: [N, *] rows and [*, N] columns (the leaves
# parallel/mesh.py partitions; the view holds no topo_dom).
_NODE_ROW_FIELDS = ("alloc", "node_zone", "dev_total", "vg_cap", "vg_nameid", "sdev_cap",
                    "sdev_media", "requested", "nonzero", "port_used", "dev_used", "vg_req",
                    "sdev_alloc")
_NODE_COL_FIELDS = ("static_mask", "mask_taint", "mask_unsched", "mask_aff", "mask_extra",
                    "simon_raw", "nodeaff_raw", "taint_raw", "avoid_raw", "image_raw",
                    "extra_raw", "counter_dom", "carr_dom")


def _rebased_view(tb: Tables, cry: Carry, lo: int, *args, **kwargs) -> TablesView:
    """`_view` of a rank's node block whose node-axis pointers are moved back
    by `lo` rows or columns: a kernel that indexes node n of the block
    [lo, lo + NL) by its global number reads the block's entry n - lo (the
    view's N stays NL, the stride of the [*, N] columns). The K8 - K11
    kernels read the block so (csrc/wave_sharded.cuh)."""
    v = _view(tb, cry, *args, **kwargs)
    src = {**tb._asdict(), **cry._asdict()}
    for name in _NODE_ROW_FIELDS + _NODE_COL_FIELDS:
        t = src[name]
        row = t.numel() // max(t.shape[0], 1) if name in _NODE_ROW_FIELDS else 1
        setattr(v, name, t.data_ptr() - lo * row * t.element_size())
    return v


def _check(rc: int, what: str) -> None:
    if rc != 0:
        from . import build

        raise RuntimeError(f"{what} failed: {build.error_string(rc)} (cudaError {rc})")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _feasibility_rows(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                      filters: FilterFlags, include_dns: bool, enable_gpu: bool,
                      enable_storage: bool) -> torch.Tensor:
    """Launch K1 (csrc/feasibility.cu feasibility_kernel): one thread-block
    cluster over the N nodes writes the packed [FEASIBILITY_ROWS + R, N]
    uint8 rows (`unpack_feasibility`) into one allocation. The cluster shape
    is recorded in `feasibility_jit.last_shape`."""

    N, R = tb.alloc.shape
    v = _view(tb, cry, 2, DEFAULT_WEIGHTS, filters, enable_gpu, enable_storage)
    lib = _lib(v)
    vr = ctypes.byref(v)
    ext = bool(enable_gpu or enable_storage)
    shape = _cluster_shape(lib, "k1", False, ext, v, 1)
    out = torch.empty((FEASIBILITY_ROWS + R, N), dtype=torch.uint8, device=tb.alloc.device)
    _check(lib.feasibility_launch(vr, int(g), int(forced), int(bool(valid)),
                                  int(bool(include_dns)), _ptr(out), shape.C, shape.smem,
                                  _stream()),
           "feasibility_kernel launch")
    _count(feasibility_jit, 1, v)
    feasibility_jit.last_shape = shape
    if ext:
        BRANCH_LAUNCHES["feasibility/gpu_storage"] += 1
    return out


def feasibility_kernel(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                       filters: FilterFlags = DEFAULT_FILTERS, include_dns: bool = True,
                       enable_gpu: bool = False, enable_storage: bool = False):
    """Launch K1 (`_feasibility_rows`). Returns (feasible [N] bool, stages
    {STAGE_KEYS: tensor}), bool views of the one packed buffer (fit_each
    its transposed [N, R] view)."""
    return unpack_feasibility(_feasibility_rows(tb, cry, g, forced, valid, filters, include_dns,
                                                enable_gpu, enable_storage))


# the (device, library) pairs on which the cluster kernels' attributes are set
_CLUSTER_READY: set = set()
# K3c's, K7's, K1's and K14's cluster shapes by their inputs (ops/cluster.py
# choose_cached)
_SHAPES: dict = {}
# K14's rows stage is one launch whose CTAs share its bytes: among the shapes
# with the fewest nodes a thread it takes the most CTAs that keep this many
# nodes each (a warp's)
K14_MIN_CHUNK = 32


def _cluster_init(lib) -> None:
    """Allow the cluster kernels (K1 - K5, K3c, K7, K8 - K14's rows stage,
    the round probe) clusters of 16 and csrc/cluster.cuh CLUSTER_SMEM_MAX
    bytes of shared memory (K1, K7, K8, K9, K11, K12 and K13 their own
    bounds, feasibility_smem_max, explain_smem_max, wave_sharded_smem_max,
    affinity_sharded_smem_max, affinity_rounds_smem_max,
    batch_sharded_smem_max and gs_sharded_smem_max) on the current device,
    once per device and library (the default and the wide build)."""
    dev = torch.cuda.current_device()
    if (dev, lib._name) not in _CLUSTER_READY:
        _check(lib.cluster_kernels_init(), "cluster kernel attributes")
        _check(lib.wave_rounds_init(), "K10 cluster kernel attributes")
        _check(lib.affinity_rounds_init(), "K11 cluster kernel attributes")
        _check(lib.wave_sharded_init(), "K8 cluster kernel attributes")
        _check(lib.affinity_sharded_init(), "K9 cluster kernel attributes")
        _check(lib.batch_sharded_init(), "K12 cluster kernel attributes")
        _check(lib.gs_sharded_init(), "K13 cluster kernel attributes")
        _check(lib.aggregate_commit_init(), "K3c cluster kernel attributes")
        _check(lib.explain_init(), "K7 cluster kernel attributes")
        _check(lib.feasibility_init(), "K1 cluster kernel attributes")
        _check(lib.commit_sharded_init(), "K14 cluster kernel attributes")
        _CLUSTER_READY.add((dev, lib._name))


def _cluster_shape(lib, kernel: str, lanes: bool, ext: bool, v: TablesView, S: int,
                   block: int = 0):
    """The cluster shape (ops/cluster.py `choose`) of a K2 ("k2"), K3
    ("k3", table depth `block`), K4 ("k4"), K5 ("k5", table depth
    `block`), K3c ("k3c"), K7 ("k7"), K1 ("k1") or K14's rows stage ("k14")
    launch of S lanes on the view `v`: the shared memory of each candidate C
    from the library (schedule_batch_smem, schedule_wave_smem,
    group_serial_smem, affinity_wave_smem, aggregate_commit_smem,
    explain_smem, feasibility_smem, commit_sharded_smem: the one formula of
    each; K7 bounded by explain_smem_max, K1 by feasibility_smem_max), and
    the card's cudaOccupancyMaxActiveClusters answer for it. K1 sizes its
    EXT build over 3N items (a node's three checks on three threads); K14's
    one-shot rows stage breaks ties toward more CTAs (K14_MIN_CHUNK). The
    shapes of K3c, K7, K1 and K14 are cached per their inputs
    (`choose_cached`: the device, N, S, the lane form or EXT, and the axes
    that size their shared memory), so only their first call asks the
    card."""
    _cluster_init(lib)
    vr = ctypes.byref(v)
    smem_of = {"k2": lambda C: lib.schedule_batch_smem(vr, C),
               "k3": lambda C: lib.schedule_wave_smem(int(v.N), int(block), C),
               "k4": lambda C: lib.group_serial_smem(vr, C),
               "k5": lambda C: lib.affinity_wave_smem(vr, int(block), C),
               "k3c": lambda C: lib.aggregate_commit_smem(),
               "k7": lambda C: lib.explain_smem(vr, C),
               "k1": lambda C: lib.feasibility_smem(vr, C, int(ext)),
               "k14": lambda C: lib.commit_sharded_smem()}[kernel]

    def occupancy(C: int, smem: int) -> int:
        out = ctypes.c_int(0)
        if kernel == "k2":
            rc = lib.schedule_batch_occupancy(int(lanes), int(ext), C, smem, ctypes.byref(out))
        elif kernel == "k3":
            rc = lib.schedule_wave_occupancy(int(lanes), int(ext), C, smem, ctypes.byref(out))
        elif kernel == "k4":
            rc = lib.group_serial_occupancy(int(lanes), C, smem, ctypes.byref(out))
        elif kernel == "k5":
            rc = lib.affinity_wave_occupancy(int(lanes), C, smem, ctypes.byref(out))
        elif kernel == "k3c":
            rc = lib.aggregate_commit_occupancy(int(lanes), C, smem, ctypes.byref(out))
        elif kernel == "k7":
            rc = lib.explain_occupancy(int(ext), C, smem, ctypes.byref(out))
        elif kernel == "k1":
            rc = lib.feasibility_occupancy(int(ext), C, smem, ctypes.byref(out))
        else:
            rc = lib.commit_sharded_occupancy(C, smem, ctypes.byref(out))
        _check(rc, f"{kernel} cluster occupancy query (C {C}, {smem} bytes)")
        return out.value

    if kernel == "k3c":
        key = (kernel, lib._name, torch.cuda.current_device(), int(v.N), S, bool(lanes))
        return choose_cached(_SHAPES, key, int(v.N), S, lambda C: int(smem_of(C)), occupancy)
    if kernel == "k7":
        key = (kernel, lib._name, torch.cuda.current_device(), int(v.N), bool(ext), int(v.Z),
               int(v.Ss))
        return choose_cached(_SHAPES, key, int(v.N), S, lambda C: int(smem_of(C)), occupancy,
                             smem_max=int(lib.explain_smem_max()))
    if kernel == "k1":
        key = (kernel, lib._name, torch.cuda.current_device(), int(v.N), bool(ext), int(v.Sd),
               int(v.R))
        items = (3 if ext else 1) * int(v.N)
        return choose_cached(_SHAPES, key, items, S, lambda C: int(smem_of(C)), occupancy,
                             smem_max=int(lib.feasibility_smem_max()))
    if kernel == "k14":  # one-shot: ties to the most CTAs that keep a warp's nodes
        key = (kernel, lib._name, torch.cuda.current_device(), int(v.N))
        return choose_cached(_SHAPES, key, int(v.N), S, lambda C: int(smem_of(C)), occupancy,
                             min_chunk=K14_MIN_CHUNK)
    return choose(int(v.N), S, lambda C: int(smem_of(C)), occupancy)


def schedule_batch_kernel(tb: Tables, cry: Carry, pod_group, forced_node, valid,
                          n_zones: int, w: ScoreWeights = DEFAULT_WEIGHTS,
                          filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                          enable_storage: bool = False):
    """Launch K2 (csrc/schedule.cu schedule_batch_kernel): one persistent
    thread-block cluster that loops over the P pods, its shape from
    ops/cluster.py (recorded with the launch's stats row, ops/cluster.py
    STATS_WORDS, in `schedule_batch.last_shape` / `.last_stats`). The
    returned carry is a CLONE of `cry` that the kernel updates in place;
    `cry` itself is left untouched."""

    dev = tb.alloc.device
    out = Carry(*(t.clone() for t in cry))
    pg = torch.as_tensor(pod_group, dtype=torch.int32, device=dev).contiguous()
    fn = torch.as_tensor(forced_node, dtype=torch.int32, device=dev).contiguous()
    vd = torch.as_tensor(valid, dtype=torch.bool, device=dev).contiguous()
    P = pg.shape[0]
    if fn.shape[0] != P or vd.shape[0] != P:
        raise ValueError("pod_group, forced_node and valid must have one length")
    v = _view(tb, out, n_zones, w, filters, enable_gpu, enable_storage)
    lib = _lib(v)
    shape = _cluster_shape(lib, "k2", False, bool(enable_gpu or enable_storage), v, 1)
    choices = torch.empty(P, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, int(lib.schedule_scratch_floats(ctypes.byref(v), shape.C))),
                          dtype=torch.float32, device=dev)
    stats = torch.zeros(STATS_WORDS, dtype=torch.int64, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _check(lib.schedule_batch_launch(ctypes.byref(v), _ptr(pg), _ptr(fn), _ptr(vd), int(P),
                                     _ptr(choices), _ptr(scratch), _ptr(stats), shape.C,
                                     shape.smem, _stream()),
           "schedule_batch_kernel launch")
    end.record()
    _count(schedule_batch, 1, v)
    if enable_gpu or enable_storage:
        BRANCH_LAUNCHES["schedule_batch/gpu_storage"] += 1
    # the launch's CUDA events: elapsed_time() once the caller has synchronized
    schedule_batch.last_events = (start, end)
    schedule_batch.last_shape, schedule_batch.last_stats = shape, stats
    return out, choices


def cluster_round_probe_kernel(C: int, rounds: int, n_zones: int = 2,
                               mode: int = 0) -> torch.Tensor:
    """Launch csrc/schedule.cu cluster_round_probe_kernel on one cluster of
    C CTAs, no node work: mode 0 `rounds` times a fused round of K2's
    phase-B shape (with max(2, n_zones) zone sums) and an argmax round (a
    pod step's pair, the latency floor of its rounds), mode 1 `rounds` times
    two cluster barriers. Measurement only; no main path launches it."""
    from . import build

    lib = build.library()
    _cluster_init(lib)
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    _check(lib.cluster_round_probe_launch(int(C), int(rounds), max(2, int(n_zones)), int(mode),
                                          _ptr(out), _stream()),
           "cluster_round_probe_kernel launch")
    return out


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _i32_on(t, dev, n: int, what: str) -> torch.Tensor:
    """`t` as a contiguous i32 tensor of length n on `dev` (raises otherwise)."""
    out = torch.as_tensor(t, dtype=torch.int32, device=dev).contiguous()
    if out.shape != (n,):
        raise ValueError(f"{what}: need shape ({n},), got {tuple(out.shape)}")
    return out


def schedule_wave_kernel(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                         w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                         block: int = WAVE_BLOCK, kmax: int = 0, gpu_live: bool = False):
    """Launch K3 (csrc/wave.cu schedule_wave_kernel): one persistent
    thread-block cluster runs the whole wave loop, its shape from
    ops/cluster.py (recorded with the launch's stats row, WAVE_CLUSTER_STATS,
    in `schedule_wave.last_shape` / `.last_cluster_stats`). Returns
    (per-node counts [N] i32, placed as a 0-dim i32 tensor, [iterations,
    head_fallbacks, guarded] i32), all on the card; `cry` is only read."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    K = kmax if kmax else N * block
    if N * block >= 2 ** 31 or not 1 <= K <= N * block:
        raise ValueError(f"wave table {N}x{block} with kmax {K} is out of the kernel's range")
    v = _view(tb, cry, 2, w, filters, enable_gpu=gpu_live)
    lib = _lib(v)
    shape = _cluster_shape(lib, "k3", False, bool(gpu_live), v, 1, block)
    j = torch.empty(N, dtype=torch.int32, device=dev)
    stats = torch.empty(len(WAVE_CLUSTER_STATS), dtype=torch.int32, device=dev)
    fs = torch.empty(max(1, int(lib.wave_scratch_floats(N, int(block), shape.C))), dtype=_F32,
                     device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _check(lib.schedule_wave_launch(ctypes.byref(v), int(g), int(m), int(bool(cap1)),
                                    int(block), int(K), _ptr(j), _ptr(stats), _ptr(fs), shape.C,
                                    shape.smem, _stream()),
           "schedule_wave_kernel launch")
    end.record()
    _count(schedule_wave, 1, v)
    schedule_wave.last_events = (start, end)
    schedule_wave.last_shape, schedule_wave.last_cluster_stats = shape, stats
    if gpu_live:
        BRANCH_LAUNCHES["schedule_wave/gpu_live"] += 1
    return j, stats[0], stats[1:4]


def _commit_inputs(tb: Tables, cry: Carry) -> Tuple[int, int]:
    """(U, D+1) of a commit, after checking its int32 topology tables."""
    dev = tb.alloc.device
    for name in ("topo_dom", "counter_topo", "carr_topo"):
        t = getattr(tb, name)
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous int32 tensor on {dev}")
    return tb.topo_dom.shape[0], cry.counter.shape[-1]


def aggregate_commit_kernel(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                            gpu_live: bool = False) -> Carry:
    """Launch K3c (csrc/aggregate_commit.cu aggregate_commit_kernel): one
    thread-block cluster over the N nodes reads `cry` and writes the new
    carry, which it returns, into fresh tensors (`cry` is left untouched and
    nothing is cloned). The cluster shape is recorded in
    `aggregate_commit.last_shape`."""

    dev = tb.alloc.device
    v = _view(tb, cry, 2, DEFAULT_WEIGHTS, DEFAULT_FILTERS, enable_gpu=gpu_live)
    lib = _lib(v)
    jj = _i32_on(j, dev, tb.alloc.shape[0], "j")
    U, D1 = _commit_inputs(tb, cry)
    shape = _cluster_shape(lib, "k3c", False, False, v, 1)
    out = Carry(*(torch.empty_like(t) for t in cry))
    seg = torch.empty(max(1, U * D1), dtype=_F32, device=dev)
    _check(lib.aggregate_commit_launch(ctypes.byref(v), ctypes.byref(_carry_out(out)), int(g),
                                       _ptr(jj), _ptr(tb.topo_dom), _ptr(tb.counter_topo),
                                       _ptr(tb.carr_topo), int(U), int(bool(gpu_live)), _ptr(seg),
                                       shape.C, shape.smem, _stream()),
           "aggregate_commit_kernel launch")
    _count(aggregate_commit, 1, v)
    aggregate_commit.last_shape = shape
    if gpu_live:
        BRANCH_LAUNCHES["aggregate_commit/gpu_live"] += 1
    return out


def schedule_group_serial_kernel(tb: Tables, cry: Carry, g: int, valid, cap1: bool,
                                 w: ScoreWeights = DEFAULT_WEIGHTS,
                                 filters: FilterFlags = DEFAULT_FILTERS,
                                 ss_live: bool = False, sa_live: bool = False, n_zones: int = 2):
    """Launch K4 (csrc/group_serial.cu schedule_group_serial_kernel): one
    persistent thread-block cluster loops over the pods, its shape from
    ops/cluster.py (recorded with the launch's stats row, ops/cluster.py
    STATS_WORDS, in `schedule_group_serial.last_shape` / `.last_stats`).
    Returns (per-node counts [N] i32, placed as a 0-dim i32 tensor), on the
    card; `cry` is only read."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    vd = torch.as_tensor(valid, dtype=torch.bool, device=dev).contiguous()
    v = _view(tb, cry, n_zones, w, filters)
    lib = _lib(v)
    shape = _cluster_shape(lib, "k4", False, False, v, 1)
    j = torch.empty(N, dtype=torch.int32, device=dev)
    placed = torch.empty(1, dtype=torch.int32, device=dev)
    fs = torch.empty(max(1, int(lib.group_serial_scratch_floats(ctypes.byref(v), shape.C))),
                     dtype=_F32, device=dev)
    stats = torch.zeros(STATS_WORDS, dtype=torch.int64, device=dev)
    _check(lib.schedule_group_serial_launch(ctypes.byref(v), int(g), _ptr(vd), int(vd.shape[0]),
                                            int(bool(cap1)), int(bool(ss_live)),
                                            int(bool(sa_live)), _ptr(j), _ptr(placed),
                                            _ptr(fs), _ptr(stats), shape.C, shape.smem,
                                            _stream()),
           "schedule_group_serial_kernel launch")
    _count(schedule_group_serial, 1, v)
    schedule_group_serial.last_shape, schedule_group_serial.last_stats = shape, stats
    return j, placed[0]


def schedule_affinity_wave_kernel(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                  ss_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                                  filters: FilterFlags = DEFAULT_FILTERS,
                                  block: int = WAVE_BLOCK, n_zones: int = 2):
    """Launch K5 (csrc/affinity_wave.cu schedule_affinity_wave_kernel): one
    persistent thread-block cluster runs the whole epoch loop, its shape
    from ops/cluster.py (recorded with the launch's stats row,
    AFFINITY_CLUSTER_STATS, in `schedule_affinity_wave.last_shape` /
    `.last_cluster_stats`). Returns (per-node counts [N] i32, placed as a
    0-dim i32 tensor, [epochs, head_fallbacks, multi_rounds] i32), all on
    the card; `cry` is only read."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    if N * block >= 2 ** 31 or block < 1:
        raise ValueError(f"affinity table {N}x{block} is out of the kernel's range")
    v = _view(tb, cry, n_zones, w, filters, domains_capped=True)
    lib = _lib(v)
    shape = _cluster_shape(lib, "k5", False, False, v, 1, block)
    j = torch.empty(N, dtype=torch.int32, device=dev)
    stats = torch.empty(len(AFFINITY_CLUSTER_STATS), dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.affinity_scratch_floats(ctypes.byref(v), int(block), shape.C)),
                     dtype=_F32, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _check(lib.schedule_affinity_wave_launch(ctypes.byref(v), int(g), int(m), int(bool(cap1)),
                                             int(bool(ss_live)), int(block), _ptr(j),
                                             _ptr(stats), _ptr(fs), shape.C, shape.smem,
                                             _stream()),
           "schedule_affinity_wave_kernel launch")
    end.record()
    _count(schedule_affinity_wave, 1, v)
    schedule_affinity_wave.last_events = (start, end)
    if ss_live:
        BRANCH_LAUNCHES["schedule_affinity_wave/ss_live"] += 1
    schedule_affinity_wave.last_shape = shape
    schedule_affinity_wave.last_cluster_stats = stats
    return j, stats[0], stats[1:4]


# A timing hook for the K8 - K11 stages: when it is a dict, each of their
# launches is recorded between two CUDA events, appended to the list under
# its C entry point's name (chip_smoke.py sets it while it times them).
SHARDED_STAGE_EVENTS: Optional[Dict[str, list]] = None


def _sharded_launch(launch, *args) -> None:
    """One launch of a K8 - K11 stage (see SHARDED_STAGE_EVENTS)."""
    ev = SHARDED_STAGE_EVENTS
    if ev is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    _check(launch(*args, _stream()), launch.__name__)
    if ev is not None:
        end.record()
        ev.setdefault(launch.__name__, []).append((start, end))


def _sharded_loop(front, table, tail, v, g: int, m: int, block: int, mesh, dims: tuple, state,
                  j, fs, iscr, part, pay, front_args: tuple, tail_args: tuple, wrapper,
                  table_args: tuple = (), tail_post: tuple = (), front_lead: tuple = ()) -> None:
    """The host's epoch loop of K8 / K9: `front` on the block, one pmax,
    `table` on the block, one tiled all-gather of the payload rows, `tail`
    at full width; one read of (placed, last) per epoch. `dims`: (the
    mesh's N, the block's lo, hi). `front_lead` (before N), `front_args`,
    `table_args`, `tail_args` and `tail_post` are the launch arguments that
    differ between the two families (their shapes among them). Every launch
    adds one to `wrapper.launches`."""
    from ..parallel.collectives import all_gather_tiled, pmax

    N, lo, hi = dims
    placed, last = 0, 1
    while last > 0 and placed < m:
        _sharded_launch(front, ctypes.byref(v), int(g), *front_lead, N, lo, hi, _ptr(j), _ptr(fs),
                        _ptr(iscr), _ptr(part), *front_args)
        red = pmax(part, mesh)
        _sharded_launch(table, ctypes.byref(v), int(g), int(block), N, lo, hi, _ptr(j), _ptr(fs),
                        _ptr(iscr), _ptr(red), _ptr(pay), *table_args)
        full = all_gather_tiled(pay, mesh, axis=0)
        _sharded_launch(tail, ctypes.byref(v), int(g), int(m), *tail_args, _ptr(j), _ptr(fs),
                        _ptr(iscr), _ptr(red), _ptr(full), _ptr(state), *tail_post)
        _count(wrapper, 3, v)
        placed, last = state[:2].tolist()
        wrapper.host_reads += 1


def schedule_wave_sharded_kernel(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                 w: ScoreWeights = DEFAULT_WEIGHTS,
                                 filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                                 kmax: int = 0, gpu_live: bool = False, mesh=None):
    """Launch K8 (csrc/wave_sharded.cu) on this rank of a partitioned node
    `mesh` whose epoch path applies: `tb` and `cry` are the rank's block.
    Setup once on the block, then per epoch the front and the table on the
    block and the tail at full width on the gathered rows, with one `pmax`
    and one `all_gather_tiled` between them (parallel/collectives.py). The
    setup and the front are K10's stages (csrc/wave_rounds.cu); the setup,
    front and table are each one thread-block cluster over the block, the
    tail one over the mesh's N nodes, their shapes from ops/cluster.py
    (recorded in `last_shape`: {"block": ..., "tail": ...}). Every rank
    returns the same (per-node counts [N] i32 of every node, placed as a
    0-dim i32 tensor, [iterations, head_fallbacks, guarded] i32), on the
    card; `cry` is only read."""

    dev = tb.alloc.device
    N = global_nodes(tb, mesh)
    K = kmax if kmax else N * block
    if N * block >= 2 ** 31 or not 1 <= K <= N * block:
        raise ValueError(f"wave table {N}x{block} with kmax {K} is out of the kernel's range")
    if _epoch_shards(mesh, N) <= 1 or not _partitioned(mesh):
        raise ValueError(f"the mesh's epoch path does not apply to {N} nodes")
    sl = _block_of(mesh, N)
    v = _rebased_view(tb, cry, sl.start, 2, w, filters, enable_gpu=gpu_live)
    lib = _lib(v)
    fn = schedule_wave_sharded_kernel
    shape_b = _rounds_shape(lib, "k8", sl.stop - sl.start, v)
    shape_t = _rounds_shape(lib, "k8_tail", N, v)
    fn.last_shape = {"block": shape_b, "tail": shape_t}
    Cb, smem_b, Ct, smem_t = shape_b.C, shape_b.smem, shape_t.C, shape_t.smem
    j = torch.empty(N, dtype=torch.int32, device=dev)
    state = torch.empty(5, dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.wave_sharded_scratch_floats(N)), dtype=_F32, device=dev)
    iscr = torch.empty(int(lib.wave_sharded_scratch_ints(N)), dtype=torch.int32, device=dev)
    part = torch.empty(6, dtype=_F32, device=dev)
    pay = torch.empty((sl.stop - sl.start, int(lib.wave_sharded_pay_floats(block))), dtype=_F32,
                      device=dev)
    _sharded_launch(lib.wave_rounds_setup_launch, ctypes.byref(v), int(g), int(bool(cap1)), N,
                    sl.start, sl.stop, _ptr(j), _ptr(fs), _ptr(iscr), _ptr(state), Cb, smem_b)
    _count(fn, 1, v)
    _sharded_loop(lib.wave_rounds_front_launch, lib.wave_sharded_table_launch,
                  lib.wave_sharded_tail_launch, v, g, m, block, mesh, (N, sl.start, sl.stop),
                  state, j, fs, iscr, part, pay, (Cb, smem_b), (int(block), int(K), N), fn,
                  table_args=(Cb, smem_b), tail_post=(Ct, smem_t))
    if gpu_live:
        BRANCH_LAUNCHES["schedule_wave_sharded/gpu_live"] += 1
    return j, state[0], state[2:5]


def _rounds_shape(lib, kernel: str, NL: int, v: TablesView):
    """The cluster shape (ops/cluster.py `choose`) of every K10 ("k10"),
    K11 ("k11"), K8 block ("k8"), K9 block ("k9"), K12 ("k12") or K13
    ("k13") stage over a block of NL nodes, or of K8's or K9's tail
    ("k8_tail", "k9_tail") over the mesh's NL = N nodes: the shared memory
    of each candidate C from the library (wave_rounds_smem,
    affinity_rounds_smem, wave_sharded_smem (K8's stages and tail alike),
    affinity_sharded_smem, affinity_sharded_tail_smem, batch_sharded_smem,
    gs_sharded_smem; K8's, K9's, K11's, K12's and K13's bounded by their
    smem_max) and the card's cudaOccupancyMaxActiveClusters answer for it."""
    _cluster_init(lib)
    vr = ctypes.byref(v)
    smem_max = SMEM_MAX
    if kernel == "k10":
        smem_of, occ_of = (lambda C: lib.wave_rounds_smem(C)), lib.wave_rounds_occupancy
    elif kernel == "k11":
        smem_of = lambda C: lib.affinity_rounds_smem(vr, C)  # noqa: E731
        occ_of, smem_max = lib.affinity_rounds_occupancy, int(lib.affinity_rounds_smem_max())
    elif kernel in ("k8", "k8_tail"):
        tail = int(kernel == "k8_tail")
        smem_of = lambda C: lib.wave_sharded_smem(C)  # noqa: E731
        occ_of = lambda C, smem, out: lib.wave_sharded_occupancy(tail, C, smem, out)  # noqa: E731
        smem_max = int(lib.wave_sharded_smem_max())
    elif kernel in ("k9", "k9_tail"):
        tail = int(kernel == "k9_tail")
        smem_of = ((lambda C: lib.affinity_sharded_tail_smem(vr, C)) if tail  # noqa: E731
                   else (lambda C: lib.affinity_sharded_smem(vr, C)))
        occ_of = lambda C, smem, out: lib.affinity_sharded_occupancy(tail, C, smem, out)  # noqa: E731
        smem_max = int(lib.affinity_sharded_smem_max())
    elif kernel == "k12":
        smem_of, occ_of = (lambda C: lib.batch_sharded_smem(vr, C)), lib.batch_sharded_occupancy
        smem_max = int(lib.batch_sharded_smem_max())
    elif kernel == "k13":
        smem_of, occ_of = (lambda C: lib.gs_sharded_smem(vr, C)), lib.gs_sharded_occupancy
        smem_max = int(lib.gs_sharded_smem_max())
    else:
        raise ValueError(f"no cluster stages of {kernel!r}")

    def occupancy(C: int, smem: int) -> int:
        out = ctypes.c_int(0)
        _check(occ_of(C, smem, ctypes.byref(out)),
               f"{kernel} cluster occupancy query (C {C}, {smem} bytes)")
        return out.value

    return choose(NL, 1, lambda C: int(smem_of(C)), occupancy, smem_max=smem_max)


def schedule_wave_rounds_kernel(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                w: ScoreWeights = DEFAULT_WEIGHTS,
                                filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                                kmax: int = 0, gpu_live: bool = False, mesh=None):
    """Launch K10 (csrc/wave_rounds.cu) on this rank of a partitioned node
    `mesh` (`tb` and `cry` the rank's block) whose per-round path applies
    (N above the epoch limit): setup once on the block, then per round the
    front, table, select, merge and finish, each one thread-block cluster
    over the block (its shape from ops/cluster.py, recorded in `last_shape`),
    with two `pmax` and two `all_gather_rows` between them
    (parallel/collectives.py) and one read of (placed, last). Every rank
    returns the same (per-node counts [N] i32, placed as a 0-dim i32 tensor,
    [iterations, head_fallbacks, guarded] i32), on the card; `cry` is only
    read."""
    from ..parallel.collectives import all_gather_rows, pmax

    dev = tb.alloc.device
    N = global_nodes(tb, mesh)
    K = kmax if kmax else N * block
    if N * block >= 2 ** 31 or not 1 <= K <= N * block:
        raise ValueError(f"wave table {N}x{block} with kmax {K} is out of the kernel's range")
    if _round_shards(mesh, N) <= 1 or not _partitioned(mesh):
        raise ValueError(f"the mesh's per-round path does not apply to {N} nodes")
    R = mesh.shards
    sl = _block_of(mesh, N)
    lo, hi, NL = sl.start, sl.stop, sl.stop - sl.start
    v = _rebased_view(tb, cry, lo, 2, w, filters, enable_gpu=gpu_live)
    lib = _lib(v)
    vr = ctypes.byref(v)
    fn = schedule_wave_rounds_kernel
    shape = fn.last_shape = _rounds_shape(lib, "k10", NL, v)
    C, smem = shape.C, shape.smem
    j = torch.empty(N, dtype=torch.int32, device=dev)
    state = torch.empty(5, dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.wave_sharded_scratch_floats(N)), dtype=_F32, device=dev)
    iscr = torch.empty(int(lib.wave_sharded_scratch_ints(N)), dtype=torch.int32, device=dev)
    part = torch.empty(6, dtype=_F32, device=dev)
    part2 = torch.empty(6, dtype=_F32, device=dev)
    pay = torch.empty((NL, int(lib.wave_sharded_pay_floats(block))), dtype=_F32, device=dev)
    summ = torch.empty((1, 8), dtype=torch.float64, device=dev)
    cand = torch.empty((min(K, m, NL * block) + 1, 2), dtype=torch.int64, device=dev)
    ms = torch.empty(int(lib.wave_rounds_merge_state_bytes()) // 8, dtype=torch.int64,
                     device=dev)
    _sharded_launch(lib.wave_rounds_setup_launch, vr, int(g), int(bool(cap1)), N, lo, hi,
                    _ptr(j), _ptr(fs), _ptr(iscr), _ptr(state), C, smem)
    _count(fn, 1, v)
    placed, last = 0, 1
    while last > 0 and placed < m:
        c = min(K, m - placed, NL * block)
        _sharded_launch(lib.wave_rounds_front_launch, vr, int(g), N, lo, hi, _ptr(j), _ptr(fs),
                        _ptr(iscr), _ptr(part), C, smem)
        red = pmax(part, mesh)
        _sharded_launch(lib.wave_rounds_table_launch, vr, int(g), int(block), N, lo, hi, _ptr(j),
                        _ptr(fs), _ptr(iscr), _ptr(red), _ptr(pay), _ptr(summ), C, smem)
        summ_all = all_gather_rows(summ, mesh)
        _sharded_launch(lib.wave_rounds_select_launch, N, int(block), lo, hi, c, R, _ptr(fs),
                        _ptr(iscr), _ptr(pay), _ptr(summ_all), _ptr(cand), C, smem)
        rows = all_gather_rows(cand[:c + 1], mesh)
        _sharded_launch(lib.wave_rounds_merge_launch, vr, int(g), int(m), int(K), int(block), N,
                        lo, hi, c, R, _ptr(fs), _ptr(iscr), _ptr(pay), _ptr(rows), _ptr(state),
                        _ptr(ms), _ptr(part2), C, smem)
        red2 = pmax(part2, mesh)
        _sharded_launch(lib.wave_rounds_finish_launch, int(m), int(block), c, R, _ptr(j),
                        _ptr(red), _ptr(red2), _ptr(summ_all), _ptr(rows), _ptr(ms),
                        _ptr(state), C, smem)
        _count(fn, 5, v)
        placed, last = state[:2].tolist()
        fn.host_reads += 1
    if gpu_live:
        BRANCH_LAUNCHES["schedule_wave_rounds/gpu_live"] += 1
    return j, state[0], state[2:5]


def schedule_affinity_wave_sharded_kernel(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                          ss_live: bool = False,
                                          w: ScoreWeights = DEFAULT_WEIGHTS,
                                          filters: FilterFlags = DEFAULT_FILTERS,
                                          block: int = WAVE_BLOCK, n_zones: int = 2, mesh=None):
    """Launch K9 (csrc/affinity_sharded.cu) on this rank of a partitioned
    node `mesh` whose epoch path applies: `tb` and `cry` are the rank's
    block. Setup once on the block, then per epoch the front and the table
    on the block and the tail at full width on the gathered rows, with one
    `pmax` and one `all_gather_tiled` between them. The setup, front and
    table are each one thread-block cluster over the block, the tail one
    over the mesh's N nodes, their shapes from ops/cluster.py (recorded in
    `last_shape`: {"block": ..., "tail": ...}). Every rank returns the
    same (per-node counts [N] i32 of every node, placed as a 0-dim i32
    tensor, [epochs, head_fallbacks, multi_rounds] i32), on the card; `cry`
    is only read."""

    dev = tb.alloc.device
    N = global_nodes(tb, mesh)
    if N * block >= 2 ** 31 or block < 1:
        raise ValueError(f"affinity table {N}x{block} is out of the kernel's range")
    if _epoch_shards(mesh, N) <= 1 or not _partitioned(mesh):
        raise ValueError(f"the mesh's epoch path does not apply to {N} nodes")
    sl = _block_of(mesh, N)
    v = _rebased_view(tb, cry, sl.start, n_zones, w, filters, domains_capped=True)
    lib = _lib(v)
    vr = ctypes.byref(v)
    fn = schedule_affinity_wave_sharded_kernel
    shape_b = _rounds_shape(lib, "k9", sl.stop - sl.start, v)
    shape_t = _rounds_shape(lib, "k9_tail", N, v)
    fn.last_shape = {"block": shape_b, "tail": shape_t}
    Cb, smem_b, Ct, smem_t = shape_b.C, shape_b.smem, shape_t.C, shape_t.smem
    j = torch.empty(N, dtype=torch.int32, device=dev)
    state = torch.empty(7, dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.affinity_sharded_scratch_floats(vr, int(block), N)), dtype=_F32,
                     device=dev)
    iscr = torch.empty(int(lib.affinity_sharded_scratch_ints(vr, N)), dtype=torch.int32,
                       device=dev)
    cs = torch.zeros(Ct * int(lib.affinity_sharded_cta_ints(vr, N)), dtype=torch.int32,
                     device=dev)  # each tail CTA's round state, its takes 0
    part = torch.empty(int(lib.affinity_sharded_parts(vr)), dtype=_F32, device=dev)
    pay = torch.empty((sl.stop - sl.start, int(lib.affinity_sharded_pay_floats(vr, int(block)))),
                      dtype=_F32, device=dev)
    _sharded_launch(lib.affinity_sharded_setup_launch, vr, int(g), int(bool(cap1)), int(block), N,
                    sl.start, sl.stop, _ptr(j), _ptr(fs), _ptr(iscr), _ptr(state), Cb, smem_b)
    _count(fn, 1, v)
    _sharded_loop(lib.affinity_sharded_front_launch, lib.affinity_sharded_table_launch,
                  lib.affinity_sharded_tail_launch, v, g, m, block, mesh, (N, sl.start, sl.stop),
                  state, j, fs, iscr, part, pay, (_ptr(state), Cb, smem_b),
                  (int(bool(ss_live)), int(block), N), fn, table_args=(Cb, smem_b),
                  tail_post=(_ptr(cs), Ct, smem_t), front_lead=(int(block),))
    return j, state[0], state[2:5]


def schedule_affinity_wave_rounds_kernel(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                         ss_live: bool = False,
                                         w: ScoreWeights = DEFAULT_WEIGHTS,
                                         filters: FilterFlags = DEFAULT_FILTERS,
                                         block: int = WAVE_BLOCK, n_zones: int = 2, mesh=None):
    """Launch K11 (csrc/affinity_rounds.cu) on this rank of a partitioned
    node `mesh` (`tb` and `cry` the rank's block) whose sharded tail
    applies (N above the epoch limit): the setup once, then per epoch the
    front and the table on the block with all_gather_rows #1 and #2 and the
    reduce between them; where use_multi_pre holds, the select (the block)
    and the merge (the rounds, replicated) around all_gather_rows #3, and
    where the rounds took pods the sandwich (the block) and pmax #4; then
    the finish. Every stage but the reduce and the merge is one
    thread-block cluster over the block (its shape from ops/cluster.py,
    recorded in `last_shape`). The host reads use_multi_pre, the rounds'
    take and, after a sandwich, (placed, last): one to three reads per
    epoch. Every rank returns the same (per-node counts [N] i32, placed as a
    0-dim i32 tensor, [epochs, head_fallbacks, multi_rounds] i32), on the
    card; `cry` is only read."""
    from ..parallel.collectives import all_gather_rows, pmax

    dev = tb.alloc.device
    N = global_nodes(tb, mesh)
    if N * block >= 2 ** 31 or block < 1:
        raise ValueError(f"affinity table {N}x{block} is out of the kernel's range")
    if _round_shards(mesh, N) <= 1 or not _partitioned(mesh):
        raise ValueError(f"the mesh's sharded tail does not apply to {N} nodes")
    R = mesh.shards
    sl = _block_of(mesh, N)
    lo, hi, NL = sl.start, sl.stop, sl.stop - sl.start
    v = _rebased_view(tb, cry, lo, n_zones, w, filters, domains_capped=True)
    lib = _lib(v)
    vr = ctypes.byref(v)
    fn = schedule_affinity_wave_rounds_kernel
    shape = fn.last_shape = _rounds_shape(lib, "k11", NL, v)
    C, smem = shape.C, shape.smem
    slots = v.Sd + v.A + v.B + v.Ca + v.Cw + 1  # every term slot's domain rides the rows
    j = torch.empty(N, dtype=torch.int32, device=dev)
    state = torch.zeros(int(lib.affinity_rounds_state_ints()), dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.affinity_sharded_scratch_floats(vr, int(block), N)), dtype=_F32,
                     device=dev)
    iscr = torch.empty(int(lib.affinity_sharded_scratch_ints(vr, N)), dtype=torch.int32,
                       device=dev)
    kx = torch.empty(int(lib.affinity_rounds_compact_ints()), dtype=torch.int32, device=dev)
    p0 = int(lib.affinity_sharded_parts(vr))  # K9's stacked vector
    P1 = p0 + 4 + (v.Z if ss_live else 0)     # then the flags and the zone sums
    part = torch.empty(P1, dtype=_F32, device=dev)
    red = torch.empty(p0 + 4, dtype=_F32, device=dev)
    summ = torch.empty((1, 8 + slots), dtype=torch.float64, device=dev)
    c = min(N * block, K_EP_MAX, NL * block)
    cand = torch.empty((c + 1, 2 + slots), dtype=torch.int64, device=dev)
    part4 = torch.empty(7, dtype=_F32, device=dev)
    G, B, ss = int(g), int(block), int(bool(ss_live))
    _sharded_launch(lib.affinity_rounds_setup_launch, vr, G, int(bool(cap1)), B, N, lo, hi,
                    _ptr(j), _ptr(fs), _ptr(iscr), _ptr(state), C, smem)
    _count(fn, 1, v)
    placed, last, heads = 0, 1, 0
    while last > 0 and placed < m:
        _sharded_launch(lib.affinity_rounds_front_launch, vr, G, B, N, lo, hi, ss, _ptr(j),
                        _ptr(fs), _ptr(iscr), _ptr(part), _ptr(state), C, smem)
        rows1 = all_gather_rows(part[None], mesh)
        _sharded_launch(lib.affinity_rounds_reduce_launch, vr, G, B, N, ss, R, P1, _ptr(rows1),
                        _ptr(red), _ptr(fs), _ptr(iscr), _ptr(state))
        _sharded_launch(lib.affinity_rounds_table_launch, vr, G, B, N, lo, hi, ss, _ptr(j),
                        _ptr(fs), _ptr(iscr), _ptr(red), _ptr(state), _ptr(summ), C, smem)
        summ_all = all_gather_rows(summ, mesh)
        multi_pre, any_start = state[7:9].tolist()
        _count(fn, 3, v)
        fn.host_reads += 1
        red4, branch = None, "head"
        if multi_pre:
            _sharded_launch(lib.affinity_rounds_select_launch, vr, G, B, N, lo, hi, c, R,
                            _ptr(fs), _ptr(iscr), _ptr(summ_all), _ptr(cand), C, smem)
            rows3 = all_gather_rows(cand, mesh)
            _sharded_launch(lib.affinity_rounds_merge_launch, vr, G, int(m), B, N, c, R, _ptr(fs),
                            _ptr(iscr), _ptr(rows3), _ptr(kx), _ptr(state))
            _count(fn, 2, v)
            fn.host_reads += 1
            branch = "select"
            if int(state[11]) > 0:
                _sharded_launch(lib.affinity_rounds_sandwich_launch, vr, G, B, N, lo, hi, _ptr(j),
                                _ptr(fs), _ptr(iscr), _ptr(part4), C, smem)
                red4 = pmax(part4, mesh)
                _count(fn, 1, v)
                branch = "sandwich"
        _sharded_launch(lib.affinity_rounds_finish_launch, vr, G, int(m), ss, B, N, R, _ptr(j),
                        _ptr(fs), _ptr(iscr), _ptr(red), _ptr_or_null(red4), _ptr(summ_all),
                        _ptr(kx), _ptr(state), C, smem)
        _count(fn, 1, v)
        mesh.tail_branches[branch] += 1
        if red4 is None:  # the head fallback, or nothing feasible
            placed, last, heads = placed + any_start, any_start, heads + any_start
        else:  # the sandwich's verdict: a head fallback is its rejection
            placed, last, _, heads_now = state[:4].tolist()
            fn.host_reads += 1
            if heads_now > heads:
                mesh.tail_branches["rejected"] += 1
            heads = heads_now
    return j, state[0], state[2:5]


def _k12_buffers(lib, vr, dev) -> tuple:
    """K12's scratch, its partial vector (sized for a group with
    ScheduleAnyway terms) and the sa stage's two extrema, on the card."""
    return (torch.empty(int(lib.batch_sharded_scratch_floats(vr)), dtype=_F32, device=dev),
            torch.empty(int(lib.batch_sharded_part_floats(vr, 1)), dtype=_F32, device=dev),
            torch.empty(2, dtype=_F32, device=dev))


def _k12_pod(lib, vr, mesh, lo: int, g: int, forced: int, valid: bool, sa: bool, bufs: tuple,
             shape, prev=None, prev_g: int = 0, prev_p: int = 0, choices=None, row2=None,
             out=None, perm: int = 0) -> int:
    """One pod's K12 stages on this rank's block, whose first node is the
    global `lo` (`forced` already in the block's numbering), each one
    thread-block cluster of `shape` (`_rounds_shape` "k12"): the front,
    which first commits the previous pod from its gathered rows `prev`,
    all_gather_rows #1 of the partial vector, for a group with
    ScheduleAnyway terms (`sa`) the sa stage and pmax #1b, then the score
    stage, which writes the block's best row into `row2` or, in explain
    mode (`out`: every node of the block, K7's packed rows at stage order
    `perm`), the packed rows. Returns the launches made."""
    from ..parallel.collectives import all_gather_rows, pmax

    scratch, part, part_b = bufs
    R = mesh.shards
    C, smem = shape.C, shape.smem
    k1 = int(lib.batch_sharded_part_floats(vr, int(sa)))
    _sharded_launch(lib.batch_sharded_front_launch, vr, g, forced, int(bool(valid)),
                    int(out is not None), lo, R, _ptr_or_null(prev), prev_g, prev_p,
                    _ptr_or_null(choices), _ptr(scratch), _ptr(part), C, smem)
    rows = all_gather_rows(part[:k1][None], mesh)
    sa_red = None
    if sa:
        _sharded_launch(lib.batch_sharded_sa_launch, vr, g, R, _ptr(rows), k1, _ptr(scratch),
                        _ptr(part_b), C, smem)
        sa_red = pmax(part_b, mesh)
    _sharded_launch(lib.batch_sharded_score_launch, vr, g, lo, R, _ptr(rows), k1,
                    _ptr_or_null(sa_red), _ptr(scratch), _ptr_or_null(row2), _ptr_or_null(out),
                    ctypes.c_longlong(perm), C, smem)
    return 3 if sa else 2


def schedule_batch_sharded_kernel(tb: Tables, cry: Carry, pod_group, forced_node, valid,
                                  n_zones: int, mesh, w: ScoreWeights = DEFAULT_WEIGHTS,
                                  filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                                  enable_storage: bool = False):
    """Launch K12 (csrc/batch_sharded.cu) on this rank of a partitioned node
    `mesh`: `tb` and `cry` are the rank's block of NL nodes, the pods and
    their forced nodes global. Per valid pod `_k12_pod` (the front with the
    previous pod's commit, all_gather_rows #1, the sa stage and pmax #1b for
    a group with ScheduleAnyway terms, the score), then all_gather_rows #2 of
    the block's best row; one commit launch after the last. Every stage is
    one thread-block cluster over the block, its shape from ops/cluster.py
    (recorded in `last_shape`). The host reads which groups have
    ScheduleAnyway terms once, and nothing per pod.
    Returns (a CLONE of `cry` that the kernel updates in place, choices [P]
    i32 as global nodes, equal on every rank), on the card."""
    from ..parallel.collectives import all_gather_rows

    dev = tb.alloc.device
    NL = tb.alloc.shape[0]
    lo = mesh.rank * NL
    out = Carry(*(t.clone() for t in cry))
    v = _view(tb, out, n_zones, w, filters, enable_gpu, enable_storage)
    lib = _lib(v)
    vr = ctypes.byref(v)
    fnk = schedule_batch_sharded_kernel
    shape = fnk.last_shape = _rounds_shape(lib, "k12", NL, v)
    pg, fn, vd = (torch.as_tensor(a).tolist() for a in (pod_group, forced_node, valid))
    P = len(pg)
    if len(fn) != P or len(vd) != P:
        raise ValueError("pod_group, forced_node and valid must have one length")
    sa = (tb.sa_t >= 0).any(dim=1).tolist()
    choices = torch.full((P,), -1, dtype=torch.int32, device=dev)
    bufs = _k12_buffers(lib, vr, dev)
    row2 = torch.empty((1, 2 + v.T + v.Tc), dtype=torch.float64, device=dev)
    prev, prev_g, prev_p = None, 0, 0
    for p in range(P):
        if not vd[p]:  # padded pod: feasible nowhere, commits nothing
            continue
        g = int(pg[p])
        _count(fnk, _k12_pod(lib, vr, mesh, lo, g, block_forced(int(fn[p]), lo, NL), True,
                             sa[g], bufs, shape, prev, prev_g, prev_p, choices, row2=row2), v)
        prev, prev_g, prev_p = all_gather_rows(row2, mesh), g, p
    if prev is not None:
        _sharded_launch(lib.batch_sharded_commit_launch, vr, prev_g, prev_p, lo, mesh.shards,
                        _ptr(prev), _ptr(choices), shape.C, shape.smem)
        _count(fnk, 1, v)
    if enable_gpu or enable_storage:
        BRANCH_LAUNCHES["schedule_batch_sharded/gpu_storage"] += 1
    return out, choices


def explain_sharded_kernel(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                           n_zones: int, enable_gpu: bool = False, enable_storage: bool = False,
                           w: ScoreWeights = DEFAULT_WEIGHTS,
                           filters: FilterFlags = DEFAULT_FILTERS, mesh=None) -> torch.Tensor:
    """K12's explain mode on this rank of a partitioned node `mesh`:
    `_k12_pod` on every node of the block, its score stage writing K7's
    packed [EXPLAIN_ROWS, NL] rows with the global normalizers (`forced`
    global; `cry` only read), on K12's cluster shape (recorded in
    `last_shape`). Returns the block's rows."""

    dev = tb.alloc.device
    NL = tb.alloc.shape[0]
    v = _view(tb, cry, n_zones, w, filters, enable_gpu, enable_storage)
    lib = _lib(v)
    vr = ctypes.byref(v)
    lo = mesh.rank * NL
    shape = explain_sharded_kernel.last_shape = _rounds_shape(lib, "k12", NL, v)
    out = torch.empty((len(EXPLAIN_ROWS), NL), dtype=_F32, device=dev)
    perm = sum(STAGE_ROWS.index(k) << (4 * i) for i, k in enumerate(EXPLAIN_STAGES))
    _count(explain_sharded_kernel, _k12_pod(
        lib, vr, mesh, lo, int(g), block_forced(forced, lo, NL), valid, _has_sa(tb, g),
        _k12_buffers(lib, vr, dev), shape, out=out, perm=perm), v)
    return out


def schedule_group_serial_sharded_kernel(tb: Tables, cry: Carry, g: int, valid, cap1: bool,
                                         mesh, w: ScoreWeights = DEFAULT_WEIGHTS,
                                         filters: FilterFlags = DEFAULT_FILTERS,
                                         ss_live: bool = False, sa_live: bool = False,
                                         n_zones: int = 2):
    """Launch K13 (csrc/group_serial_sharded.cu) on this rank of a
    partitioned node `mesh`: `tb` and `cry` are the rank's block of NL
    nodes. Setup once, then per valid pod the front (with the previous
    pod's commit), all_gather_rows #1, with sa_live the sa stage and pmax
    #1b, the score, all_gather_rows #2; one finish launch commits the last
    pod. Every stage is one thread-block cluster over the block, its shape
    from ops/cluster.py (recorded in `last_shape`). The host reads nothing
    per pod. Returns (the block's per-node counts [NL] i32, placed as a
    0-dim i32 tensor, equal on every rank), on the card; `cry` is only
    read."""
    from ..parallel.collectives import all_gather_rows, pmax

    dev = tb.alloc.device
    NL = tb.alloc.shape[0]
    lo, R = mesh.rank * NL, mesh.shards
    v = _view(tb, cry, n_zones, w, filters)
    lib = _lib(v)
    vr = ctypes.byref(v)
    fn = schedule_group_serial_sharded_kernel
    shape = fn.last_shape = _rounds_shape(lib, "k13", NL, v)
    C, smem = shape.C, shape.smem
    G, ss, sa = int(g), int(bool(ss_live)), int(bool(sa_live))
    fs = torch.empty(int(lib.gs_sharded_scratch_floats(vr)), dtype=_F32, device=dev)
    iscr = torch.empty(int(lib.gs_sharded_scratch_ints(vr)), dtype=torch.int32, device=dev)
    k1 = int(lib.gs_sharded_part_floats(vr, ss, sa))
    mk = int(lib.gs_sharded_marks_offset(vr, ss))
    part = torch.empty(k1, dtype=_F32, device=dev)
    part_b = torch.empty(2, dtype=_F32, device=dev)
    row2 = torch.empty((1, 2 + v.Sd + v.Ss), dtype=torch.float64, device=dev)
    _sharded_launch(lib.gs_sharded_setup_launch, vr, G, int(bool(cap1)), _ptr(fs), _ptr(iscr),
                    C, smem)
    _count(fn, 1, v)
    prev = None
    for ok in torch.as_tensor(valid).tolist():
        if not ok:  # padded pod: commits nothing
            continue
        _sharded_launch(lib.gs_sharded_front_launch, vr, G, lo, R, ss, sa, _ptr_or_null(prev),
                        _ptr(fs), _ptr(iscr), _ptr(part), C, smem)
        rows = all_gather_rows(part[None], mesh)
        sa_red = None
        if sa:
            _sharded_launch(lib.gs_sharded_sa_launch, vr, G, R, _ptr(rows), k1, mk, _ptr(fs),
                            _ptr(iscr), _ptr(part_b), C, smem)
            sa_red = pmax(part_b, mesh)
            _count(fn, 1, v)
        _sharded_launch(lib.gs_sharded_score_launch, vr, G, lo, R, ss, sa, _ptr(rows), k1,
                        _ptr_or_null(sa_red), _ptr(fs), _ptr(iscr), _ptr(row2), C, smem)
        _count(fn, 2, v)
        prev = all_gather_rows(row2, mesh)
    if prev is not None:
        _sharded_launch(lib.gs_sharded_finish_launch, vr, G, lo, R, sa, _ptr(prev), _ptr(fs),
                        _ptr(iscr), C, smem)
        _count(fn, 1, v)
    off = int(lib.gs_sharded_j_offset(vr))
    return iscr[off:off + NL].clone(), iscr[off + NL]


def aggregate_commit_sharded_kernel(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                                    gpu_live: bool = False, mesh=None) -> Carry:
    """Launch K14 (csrc/commit_sharded.cu) on this rank of a partitioned
    node `mesh` (`tb`, `cry` and the counts `j` [NL] the rank's block): the
    rows stage (one thread-block cluster over the block writes the new
    carry's rows and the block's per-topology domain counts), ONE
    all_gather_rows of those counts, the domains stage (a grid over the
    counter and carrier elements adds their sum in rank order). Reads `cry`
    and returns the block's new carry in fresh tensors (`cry` is left
    untouched and nothing is cloned). The rows stage's cluster shape is
    recorded in `aggregate_commit_sharded_kernel.last_shape`."""
    from ..parallel.collectives import all_gather_rows

    dev = tb.alloc.device
    v = _view(tb, cry, 2, DEFAULT_WEIGHTS, DEFAULT_FILTERS, enable_gpu=gpu_live)
    lib = _lib(v)
    vr = ctypes.byref(v)
    jj = _i32_on(j, dev, tb.alloc.shape[0], "j")
    U, D1 = _commit_inputs(tb, cry)
    shape = _cluster_shape(lib, "k14", False, False, v, 1)
    out = Carry(*(torch.empty_like(t) for t in cry))
    o = ctypes.byref(_carry_out(out))
    seg = torch.empty((1, U, D1), dtype=_F32, device=dev)
    _sharded_launch(lib.commit_sharded_rows_launch, vr, o, int(g), _ptr(jj), _ptr(tb.topo_dom),
                    U, int(bool(gpu_live)), _ptr(seg), shape.C, shape.smem)
    rows = all_gather_rows(seg, mesh)
    _sharded_launch(lib.commit_sharded_domains_launch, vr, o, int(g), _ptr(rows), mesh.shards,
                    _ptr(tb.counter_topo), _ptr(tb.carr_topo), U)
    _count(aggregate_commit_sharded_kernel, 2, v)
    aggregate_commit_sharded_kernel.last_shape = shape
    if gpu_live:
        BRANCH_LAUNCHES["aggregate_commit_sharded/gpu_live"] += 1
    return out


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def feasibility_packed(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                       filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                       enable_storage: bool = False, mesh=None) -> torch.Tensor:
    """The failure-reason diagnostic as ONE packed [FEASIBILITY_ROWS + R, N]
    uint8 buffer (`unpack_feasibility` gives `feasibility_jit`'s pair): the
    plain version packed (`pack_feasibility`) for CPU tensors, K1's own
    output for CUDA tensors. On a partitioned node `mesh` (the tables and
    carry this rank's block, `forced` a global node) the same on the block,
    gathered tiled as it is, so that every rank holds all N columns (one
    `all_gather_tiled`)."""
    flags = dict(enable_gpu=enable_gpu, enable_storage=enable_storage)
    if _partitioned(mesh):
        NL = tb.alloc.shape[0]
        forced = block_forced(forced, mesh.rank * NL, NL)
    if _on_cpu(tb.alloc):
        rows = pack_feasibility(*feasibility(tb, cry, g, forced, valid, filters, **flags))
    else:
        rows = _feasibility_rows(tb, cry, g, forced, valid, filters, True, **flags)
    if not _partitioned(mesh):
        return rows
    from ..parallel.collectives import all_gather_tiled

    return all_gather_tiled(rows, mesh, axis=1)


def feasibility_jit(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                    filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                    enable_storage: bool = False, mesh=None):
    """The failure-reason diagnostic (JAX `feasibility_jit`): the plain
    version for CPU tensors, K1 for CUDA tensors, as (feasible [N], stages),
    bool views of `feasibility_packed`'s buffer. On a partitioned node
    `mesh` (the tables and carry this rank's block, `forced` a global node)
    the same on the block, gathered tiled, so that every rank returns them
    for all N nodes (one `all_gather_tiled`)."""
    return unpack_feasibility(feasibility_packed(tb, cry, g, forced, valid, filters, enable_gpu,
                                                 enable_storage, mesh))


def explain_kernel(tb: Tables, cry: Carry, g: int, forced: int, valid: bool, n_zones: int,
                   enable_gpu: bool = False, enable_storage: bool = False,
                   w: ScoreWeights = DEFAULT_WEIGHTS,
                   filters: FilterFlags = DEFAULT_FILTERS) -> torch.Tensor:
    """Launch K7 (csrc/explain.cu explain_kernel): one thread-block cluster
    over the N nodes computes the stages, components and total of
    `explain_pod` for group g. Returns the [EXPLAIN_ROWS, N] f32 rows on the
    card (`unpack_explain` gives the four-tuple); `cry` is only read. The
    cluster shape is recorded in `explain_jit.last_shape`."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    v = _view(tb, cry, n_zones, w, filters, enable_gpu, enable_storage)
    lib = _lib(v)
    vr = ctypes.byref(v)
    shape = _cluster_shape(lib, "k7", False, bool(enable_gpu or enable_storage), v, 1)
    # row i of the output holds stage bit perm[i]: EXPLAIN_STAGES mapped by
    # name onto the STAGE_ROWS order of the kernels' stage bits, 4 bits each
    perm = sum(STAGE_ROWS.index(k) << (4 * i) for i, k in enumerate(EXPLAIN_STAGES))
    out = torch.empty((len(EXPLAIN_ROWS), N), dtype=_F32, device=dev)
    scratch = torch.empty(max(1, int(lib.explain_scratch_floats(vr))), dtype=_F32, device=dev)
    _check(lib.explain_launch(vr, int(g), int(forced), int(bool(valid)), ctypes.c_longlong(perm),
                              _ptr(out), _ptr(scratch), shape.C, shape.smem, _stream()),
           "explain_kernel launch")
    _count(explain_jit, 1, v)
    explain_jit.last_shape = shape
    return out


def explain_jit(tb: Tables, cry: Carry, g: int, forced: int, valid: bool, n_zones: int,
                enable_gpu: bool = False, enable_storage: bool = False,
                w: ScoreWeights = DEFAULT_WEIGHTS,
                filters: FilterFlags = DEFAULT_FILTERS, mesh=None) -> torch.Tensor:
    """The xray diagnostic (JAX `explain_jit`) as packed [EXPLAIN_ROWS, N]
    f32 rows, the JAX engine's packed fetch: `explain_pod` packed for CPU
    tensors, K7 for CUDA tensors. `unpack_explain` gives JAX's four-tuple.
    On a partitioned node `mesh` (the tables and carry this rank's block,
    `forced` a global node) the block's rows (K12's explain mode on the
    card), normalized over every rank's nodes and gathered tiled, so that
    every rank returns all N columns."""
    args = (tb, cry, g, forced, valid, n_zones, enable_gpu, enable_storage, w, filters)
    if _on_cpu(tb.alloc):
        packed = pack_explain(*explain_pod(*args, mesh=mesh))
    elif _partitioned(mesh):
        packed = explain_sharded_kernel(*args, mesh=mesh)
    else:
        return explain_kernel(*args)
    if not _partitioned(mesh):
        return packed
    from ..parallel.collectives import all_gather_tiled

    return all_gather_tiled(packed, mesh, axis=1)


def schedule_batch(tb: Tables, cry: Carry, pod_group, forced_node, valid, n_zones: int,
                   w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                   enable_gpu: bool = False, enable_storage: bool = False, mesh=None):
    """Scan the whole batch; returns (final carry, choices [P] i32, -1 =
    unschedulable): the plain version for CPU tensors, K2 for CUDA tensors.
    On a partitioned node `mesh` (the tables and carry this rank's block:
    parallel/mesh.py `to_device_sharded`) the scan on the block, K12 for
    CUDA tensors and `schedule_batch_sharded_plain` for CPU tensors; the
    carry returned is the block's, the choices global and equal on every
    rank."""
    if _partitioned(mesh):
        run = schedule_batch_sharded_plain if _on_cpu(tb.alloc) else schedule_batch_sharded_kernel
        return run(tb, cry, pod_group, forced_node, valid, n_zones, mesh, w, filters, enable_gpu,
                   enable_storage)
    run = schedule_batch_plain if _on_cpu(tb.alloc) else schedule_batch_kernel
    return run(tb, cry, pod_group, forced_node, valid, n_zones, w, filters, enable_gpu,
               enable_storage)


def aggregate_commit(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                     gpu_live: bool = False, mesh=None) -> Carry:
    """Commit j[n] copies of group g on every node n at once (JAX
    `_aggregate_commit`): the plain version for CPU tensors, K3c for CUDA
    tensors. On a partitioned node `mesh` (`tb`, `cry` and j this rank's
    block) the commit on the block, K14 for CUDA tensors and
    `aggregate_commit_sharded_plain` for CPU tensors. Returns a new Carry
    (the block's on a mesh)."""
    if _partitioned(mesh):
        run = (aggregate_commit_sharded_plain if _on_cpu(tb.alloc)
               else aggregate_commit_sharded_kernel)
        return run(tb, cry, g, j, gpu_live, mesh)
    if _on_cpu(tb.alloc):
        return aggregate_commit_plain(tb, cry, g, j, gpu_live)
    return aggregate_commit_kernel(tb, cry, g, j, gpu_live)


def _block_counts(j: torch.Tensor, mesh) -> torch.Tensor:
    """A wave's global counts j [N] as this rank's block on a partitioned
    `mesh` (every rank holds the same j), else j."""
    return j[_block_of(mesh, j.shape[0])] if _partitioned(mesh) else j


def schedule_wave(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                  w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                  block: int = WAVE_BLOCK, kmax: int = 0, gpu_live: bool = False, mesh=None):
    """Place up to m pods of wave-eligible group g, exactly as m serial steps
    would (JAX `schedule_wave`): the plain version for CPU tensors, K3 for
    CUDA tensors (on a partitioned node `mesh`, whose block `tb` and `cry`
    are, K8 where it takes the sharded epoch path and K10 where it takes the
    per-round path above the epoch limit), then `aggregate_commit`. Returns
    (new carry, per-node counts i32, placed): the counts of every node, or
    the block's on a mesh. The loop's statistics (WAVE_STATS) are added to
    `schedule_wave.stats`, an i32 tensor on the wrapper's device (adding it
    up does not wait for the card)."""
    N = global_nodes(tb, mesh)
    if _on_cpu(tb.alloc):
        j, placed, st = schedule_wave_plain(tb, cry, g, m, cap1, w, filters, block, kmax,
                                            gpu_live, mesh)
        stats = torch.tensor([st[k] for k in WAVE_STATS], dtype=torch.int32)
    elif _epoch_shards(mesh, N) > 1:
        j, placed, stats = schedule_wave_sharded_kernel(tb, cry, g, m, cap1, w, filters, block,
                                                        kmax, gpu_live, mesh)
    elif _round_shards(mesh, N) > 1:
        j, placed, stats = schedule_wave_rounds_kernel(tb, cry, g, m, cap1, w, filters, block,
                                                       kmax, gpu_live, mesh)
    else:
        j, placed, stats = schedule_wave_kernel(tb, cry, g, m, cap1, w, filters, block, kmax,
                                                gpu_live)
    prev = schedule_wave.stats
    schedule_wave.stats = stats if prev is None or prev.device != stats.device else prev + stats
    j = _block_counts(j, mesh)
    return aggregate_commit(tb, cry, g, j, gpu_live, mesh), j, placed


def schedule_group_serial(tb: Tables, cry: Carry, g: int, valid, cap1: bool,
                          w: ScoreWeights = DEFAULT_WEIGHTS,
                          filters: FilterFlags = DEFAULT_FILTERS,
                          ss_live: bool = False, sa_live: bool = False, n_zones: int = 2,
                          mesh=None):
    """The serial scan of one group with live spread state (JAX
    `schedule_group_serial`): the plain version for CPU tensors, K4 for CUDA
    tensors (on a partitioned node `mesh`, the scan on this rank's block:
    K13, or `schedule_group_serial_sharded_plain` for CPU tensors), then
    `aggregate_commit`. Returns (new carry, per-node counts i32, placed):
    the block's counts on a mesh, placed global."""
    if _partitioned(mesh):
        run = (schedule_group_serial_sharded_plain if _on_cpu(tb.alloc)
               else schedule_group_serial_sharded_kernel)
        j, placed = run(tb, cry, g, valid, cap1, mesh, w, filters, ss_live, sa_live, n_zones)
    elif _on_cpu(tb.alloc):
        j, placed = schedule_group_serial_plain(tb, cry, g, valid, cap1, w, filters,
                                                ss_live, sa_live, n_zones)
    else:
        j, placed = schedule_group_serial_kernel(tb, cry, g, valid, cap1, w, filters,
                                                 ss_live, sa_live, n_zones)
    return aggregate_commit(tb, cry, g, j, mesh=mesh), j, placed


def schedule_affinity_wave(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                           ss_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                           filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                           n_zones: int = 2, mesh=None):
    """Place up to m pods of affinity-route group g, exactly as m serial
    steps would (JAX `schedule_affinity_wave`): the plain version for CPU
    tensors, K5 for CUDA tensors (on a partitioned node `mesh`, whose block
    `tb` and `cry` are, K9 where it takes the sharded epoch path and K11
    where it takes the sharded tail above the epoch limit), then
    `aggregate_commit`. Returns (new carry, per-node counts i32, placed):
    the block's counts on a mesh. The epoch statistics (AFFINITY_STATS) are
    added to `schedule_affinity_wave.stats`, an i32 tensor on the wrapper's
    device (adding them up does not wait for the card), and this call's
    alone are `schedule_affinity_wave.last_stats`."""
    N = global_nodes(tb, mesh)
    if _on_cpu(tb.alloc):
        j, placed, st = schedule_affinity_wave_plain(tb, cry, g, m, cap1, ss_live, w, filters,
                                                     block, n_zones, mesh)
        stats = torch.tensor([st[k] for k in AFFINITY_STATS], dtype=torch.int32)
    elif _epoch_shards(mesh, N) > 1:
        j, placed, stats = schedule_affinity_wave_sharded_kernel(
            tb, cry, g, m, cap1, ss_live, w, filters, block, n_zones, mesh)
    elif _round_shards(mesh, N) > 1:
        j, placed, stats = schedule_affinity_wave_rounds_kernel(
            tb, cry, g, m, cap1, ss_live, w, filters, block, n_zones, mesh)
    else:
        j, placed, stats = schedule_affinity_wave_kernel(tb, cry, g, m, cap1, ss_live, w,
                                                         filters, block, n_zones)
    prev = schedule_affinity_wave.stats
    schedule_affinity_wave.stats = (stats if prev is None or prev.device != stats.device
                                    else prev + stats)
    schedule_affinity_wave.last_stats = stats
    j = _block_counts(j, mesh)
    return aggregate_commit(tb, cry, g, j, mesh=mesh), j, placed


# ------------------------------------------------------------------- lanes ----
#
# Port of the JAX package's fan-outs (ops/kernels.py :2280-2510): S lanes in
# one dispatch, each with its own node-active mask and its own carry (a
# leading [S] axis). `active` folds into static_mask (`_mask_active`), which
# makes an inactive node a phantom: infeasible for every pod, excluded from
# every normalizer, owner of no placed pod. The capacity probe's lanes
# (`probe_*_fanout`) share one segment; the serve and sweep lanes
# (`serve_*_fanout`, `sweep_*_fanout`) carry their own pod rows or wave
# groups. JAX vmaps K2-K5 over the lanes; the plain versions below loop over
# them, and the lane kernels run one thread-block cluster per lane (K2-K5
# and K3c: csrc/*.cu `*_lanes_kernel`), reading per-lane
# inputs at a lane stride (0 for one value shared by every lane).


def _mask_active(tb: Tables, active: torch.Tensor) -> Tables:
    """Fold an [N] node-active mask into the static group mask (JAX :2294)."""
    return tb._replace(static_mask=tb.static_mask & active[None, :])


def carry_lanes(cry: Carry, S: int) -> Carry:
    """The seed carry broadcast to S lanes: [S, ...] contiguous copies."""
    return Carry(*(t.unsqueeze(0).expand(S, *t.shape).contiguous() for t in cry))


def carry_lane(cry_s: Carry, s: int, copy: bool = True) -> Carry:
    """Lane s of an [S, ...] carry (a copy unless `copy` is False)."""
    return Carry(*((t[s].clone() if copy else t[s]) for t in cry_s))


def _stack_carries(carries) -> Carry:
    return Carry(*(torch.stack(ts) for ts in zip(*carries)))


def _lanes_of(active_s: torch.Tensor, N: int, dev) -> torch.Tensor:
    """`active_s` as a contiguous [S, N] bool tensor on `dev` (raises otherwise)."""
    a = torch.as_tensor(active_s, dtype=torch.bool, device=dev).contiguous()
    if a.dim() != 2 or a.shape[1] != N or a.shape[0] < 1:
        raise ValueError(f"active_s: need shape (S, {N}), got {tuple(a.shape)}")
    return a


def _check_lanes(cry_s: Carry, S: int) -> None:
    for f, t in zip(Carry._fields, cry_s):
        if t.shape[0] != S or not t.is_contiguous():
            raise ValueError(f"carry {f}: need a contiguous [{S}, ...] tensor, got "
                             f"{tuple(t.shape)}")


def _row(a, s: int):
    """Lane s's row of a per-lane [S, P] input, or the [P] input shared by
    every lane."""
    return a[s] if isinstance(a, torch.Tensor) and a.dim() == 2 else a


def _lane_value(a, s: int):
    """Lane s's value of a per-lane [S] input, or the scalar shared by every lane."""
    return a[s].item() if isinstance(a, torch.Tensor) and a.dim() == 1 else a


@torch.inference_mode()
def schedule_batch_lanes_plain(tb: Tables, cry_s: Carry, active_s, pod_group, forced_node,
                               valid, n_zones: int, w: ScoreWeights = DEFAULT_WEIGHTS,
                               filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                               enable_storage: bool = False):
    """Plain version of `schedule_batch_lanes_kernel`: schedule_batch_plain
    on each lane's masked tables. `pod_group`, `forced_node` and `valid` are
    [P] (shared by every lane) or [S, P] (a row per lane). Returns (carry_s,
    choices [S, P] i32)."""
    outs, choices = [], []
    for s in range(active_s.shape[0]):
        c2, ch = schedule_batch_plain(_mask_active(tb, active_s[s]), carry_lane(cry_s, s),
                                      _row(pod_group, s), _row(forced_node, s), _row(valid, s),
                                      n_zones, w, filters, enable_gpu, enable_storage)
        outs.append(c2)
        choices.append(ch)
    return _stack_carries(outs), torch.stack(choices)


@torch.inference_mode()
def schedule_wave_lanes_plain(tb: Tables, cry_s: Carry, active_s, g: int, m: int, cap1: bool,
                              w: ScoreWeights = DEFAULT_WEIGHTS,
                              filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                              kmax: int = 0, gpu_live: bool = False):
    """Plain version of `schedule_wave_lanes_kernel`: `g`, `m` and `cap1` are
    scalars (every lane) or [S] tensors (one per lane). Returns (counts
    [S, N] i32, placed [S] i32, stats [S, 3] i32 in WAVE_STATS order)."""
    js, placed, stats = [], [], []
    for s in range(active_s.shape[0]):
        j, p, st = schedule_wave_plain(_mask_active(tb, active_s[s]), carry_lane(cry_s, s),
                                       int(_lane_value(g, s)), int(_lane_value(m, s)),
                                       bool(_lane_value(cap1, s)), w, filters, block, kmax,
                                       gpu_live)
        js.append(j)
        placed.append(p)
        stats.append([st[k] for k in WAVE_STATS])
    return _lane_results(js, placed, stats)


def _lane_results(js, placed, stats):
    dev = js[0].device
    return (torch.stack(js), torch.tensor(placed, dtype=torch.int32, device=dev),
            torch.tensor(stats, dtype=torch.int32, device=dev))


@torch.inference_mode()
def aggregate_commit_lanes_plain(tb: Tables, cry_s: Carry, g: int, j_s: torch.Tensor,
                                 gpu_live: bool = False) -> Carry:
    """Plain version of `aggregate_commit_lanes_kernel`: lane s commits row s
    of j_s (copies of group g, or of g[s] when g is an [S] tensor) into its
    own carry. The tables are not masked: the counts of an inactive node
    are 0."""
    return _stack_carries(aggregate_commit_plain(tb, carry_lane(cry_s, s), int(_lane_value(g, s)),
                                                 j_s[s], gpu_live)
                          for s in range(j_s.shape[0]))


@torch.inference_mode()
def schedule_group_serial_lanes_plain(tb: Tables, cry_s: Carry, active_s, g: int, valid,
                                      cap1: bool, w: ScoreWeights = DEFAULT_WEIGHTS,
                                      filters: FilterFlags = DEFAULT_FILTERS,
                                      ss_live: bool = False, sa_live: bool = False,
                                      n_zones: int = 2):
    """Plain version of `schedule_group_serial_lanes_kernel`: returns
    (counts [S, N] i32, placed [S] i32)."""
    js, placed = [], []
    for s in range(active_s.shape[0]):
        j, p = schedule_group_serial_plain(_mask_active(tb, active_s[s]), carry_lane(cry_s, s),
                                           g, valid, cap1, w, filters, ss_live, sa_live, n_zones)
        js.append(j)
        placed.append(p)
    return torch.stack(js), torch.tensor(placed, dtype=torch.int32, device=js[0].device)


@torch.inference_mode()
def schedule_affinity_wave_lanes_plain(tb: Tables, cry_s: Carry, active_s, g: int, m: int,
                                       cap1: bool, ss_live: bool = False,
                                       w: ScoreWeights = DEFAULT_WEIGHTS,
                                       filters: FilterFlags = DEFAULT_FILTERS,
                                       block: int = WAVE_BLOCK, n_zones: int = 2):
    """Plain version of `schedule_affinity_wave_lanes_kernel`: returns
    (counts [S, N] i32, placed [S] i32, stats [S, 3] i32 in AFFINITY_STATS
    order)."""
    js, placed, stats = [], [], []
    for s in range(active_s.shape[0]):
        j, p, st = schedule_affinity_wave_plain(_mask_active(tb, active_s[s]),
                                                carry_lane(cry_s, s), g, m, cap1, ss_live, w,
                                                filters, block, n_zones)
        js.append(j)
        placed.append(p)
        stats.append([st[k] for k in AFFINITY_STATS])
    return _lane_results(js, placed, stats)


def _lane_view(tb: Tables, cry_s: Carry, active_s, n_zones: int, w: ScoreWeights,
               filters: FilterFlags, enable_gpu: bool = False, enable_storage: bool = False,
               domains_capped: bool = False):
    """(S, [S, N] mask, TablesView of lane 0) for a lane kernel."""
    active = _lanes_of(active_s, tb.alloc.shape[0], tb.alloc.device)
    S = active.shape[0]
    _check_lanes(cry_s, S)
    v = _view(tb, carry_lane(cry_s, 0, copy=False), n_zones, w, filters, enable_gpu,
              enable_storage, active=active, domains_capped=domains_capped)
    return S, active, v


def _lane_rows(a, dtype, S: int, P: int, dev, what: str) -> Tuple[torch.Tensor, int]:
    """A pod array of shape [P] (shared: lane stride 0) or [S, P] (per lane:
    stride P), contiguous on `dev`, with its lane stride."""
    t = torch.as_tensor(a, dtype=dtype, device=dev).contiguous()
    if t.shape == (P,):
        return t, 0
    if t.shape == (S, P):
        return t, P
    raise ValueError(f"{what}: need shape ({P},) or ({S}, {P}), got {tuple(t.shape)}")


def schedule_batch_lanes_kernel(tb: Tables, cry_s: Carry, active_s, pod_group, forced_node,
                                valid, n_zones: int, w: ScoreWeights = DEFAULT_WEIGHTS,
                                filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                                enable_storage: bool = False, fanout=None):
    """Launch K2 over S lanes (csrc/schedule.cu schedule_batch_lanes_kernel),
    cluster s on lane s (the shape and [S, STATS_WORDS] stats recorded on
    the counting wrapper as in schedule_batch_kernel). `pod_group`,
    `forced_node` and `valid` are [P] (one stream for every lane) or [S, P]
    (a row per lane). Returns (carry_s,
    choices [S, P] i32): the carry is a CLONE of `cry_s` that the kernel
    updates in place. The launch counts on `fanout` (the fan-out wrapper
    that asked for it; probe_serial_fanout by default)."""

    dev = tb.alloc.device
    out = Carry(*(t.clone() for t in cry_s))
    S, active, v = _lane_view(tb, out, active_s, n_zones, w, filters, enable_gpu,
                              enable_storage)
    lib = _lib(v)
    P = int(torch.as_tensor(pod_group).shape[-1])
    pg, pod_lane = _lane_rows(pod_group, torch.int32, S, P, dev, "pod_group")
    fn, fn_lane = _lane_rows(forced_node, torch.int32, S, P, dev, "forced_node")
    vd, valid_lane = _lane_rows(valid, torch.bool, S, P, dev, "valid")
    if fn_lane != pod_lane:
        raise ValueError("pod_group and forced_node must both be shared or both per lane")
    shape = _cluster_shape(lib, "k2", True, bool(enable_gpu or enable_storage), v, S)
    choices = torch.empty((S, P), dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, S * int(lib.schedule_scratch_floats(ctypes.byref(v), shape.C))),
                          dtype=torch.float32, device=dev)
    stats = torch.zeros((S, STATS_WORDS), dtype=torch.int64, device=dev)
    _check(lib.schedule_batch_lanes_launch(ctypes.byref(v), _ptr(pg), _ptr(fn), _ptr(vd), int(P),
                                           pod_lane, valid_lane, int(S), _ptr(choices),
                                           _ptr(scratch), _ptr(stats), shape.C, shape.smem,
                                           _stream()),
           "schedule_batch_lanes_kernel launch")
    wrapper = fanout or probe_serial_fanout
    wrapper.last_shape, wrapper.last_stats = shape, stats
    _count(wrapper, 1, v)
    return out, choices


def _lane_values(vals, dtype, S: int, dev, what: str):
    """A per-lane input as (scalar, None) when every lane shares it (a Python
    or 0-dim value, passed as a launch argument), or (0, [S] contiguous
    device array) for one value per lane."""
    dim = vals.dim() if isinstance(vals, torch.Tensor) else np.ndim(vals)
    if dim == 0:
        return int(vals), None
    t = torch.as_tensor(vals, dtype=dtype, device=dev).contiguous()
    if t.shape != (S,):
        raise ValueError(f"{what}: need a scalar or shape ({S},), got {tuple(t.shape)}")
    return 0, t


def _ptr_or_null(t):
    return None if t is None else _ptr(t)


def schedule_wave_lanes_kernel(tb: Tables, cry_s: Carry, active_s, g, m, cap1,
                               w: ScoreWeights = DEFAULT_WEIGHTS,
                               filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                               kmax: int = 0, gpu_live: bool = False, fanout=None):
    """Launch K3 over S lanes (csrc/wave.cu schedule_wave_lanes_kernel, one
    cluster per lane; the shape and [S, WAVE_CLUSTER_STATS] stats recorded
    as the fan-out wrapper's `last_shape` / `last_cluster_stats`). `g`, `m`
    and `cap1` are each a scalar (every lane; a launch argument) or an [S]
    tensor (one per lane); `block` and `kmax` are shared. Returns (counts
    [S, N] i32, placed [S] i32, stats [S, 3] i32), all on the card; `cry_s`
    is only read. The launch counts on `fanout` (probe_wave_fanout by
    default)."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    K = kmax if kmax else N * block
    if N * block >= 2 ** 31 or not 1 <= K <= N * block:
        raise ValueError(f"wave table {N}x{block} with kmax {K} is out of the kernel's range")
    S, active, v = _lane_view(tb, cry_s, active_s, 2, w, filters, enable_gpu=gpu_live)
    lib = _lib(v)
    shape = _cluster_shape(lib, "k3", True, bool(gpu_live), v, S, block)
    g0, g_t = _lane_values(g, torch.int32, S, dev, "g")
    m0, m_t = _lane_values(m, torch.int32, S, dev, "m")
    c0, c_t = _lane_values(cap1, torch.bool, S, dev, "cap1")
    j = torch.empty((S, N), dtype=torch.int32, device=dev)
    stats = torch.empty((S, len(WAVE_CLUSTER_STATS)), dtype=torch.int32, device=dev)
    fs = torch.empty(max(1, S * int(lib.wave_scratch_floats(N, int(block), shape.C))),
                     dtype=_F32, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _check(lib.schedule_wave_lanes_launch(ctypes.byref(v), g0, m0, int(bool(c0)),
                                          _ptr_or_null(g_t), _ptr_or_null(m_t), _ptr_or_null(c_t),
                                          int(block), int(K), int(S), _ptr(j), _ptr(stats),
                                          _ptr(fs), shape.C, shape.smem, _stream()),
           "schedule_wave_lanes_kernel launch")
    end.record()
    wrapper = fanout or probe_wave_fanout
    _count(wrapper, 1, v)
    wrapper.last_events = (start, end)
    wrapper.last_shape, wrapper.last_cluster_stats = shape, stats
    return j, stats[:, 0], stats[:, 1:4]


def aggregate_commit_lanes_kernel(tb: Tables, cry_s: Carry, g, j_s: torch.Tensor,
                                  gpu_live: bool = False, fanout=None) -> Carry:
    """Launch K3c over S lanes (csrc/aggregate_commit.cu
    aggregate_commit_lanes_kernel, one thread-block cluster a lane): lane s
    reads its carry of `cry_s` and writes its new carry into fresh [S, ...]
    tensors, which it returns (`cry_s` is left untouched). `g` is a scalar
    (every lane; a launch argument) or an [S] tensor (one group per lane).
    The launch counts on `fanout` (aggregate_commit_lanes, the probe
    fan-outs' commit, by default); the cluster shape is recorded in
    `aggregate_commit_lanes.last_shape`."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    jj = torch.as_tensor(j_s, dtype=torch.int32, device=dev).contiguous()
    S = jj.shape[0]
    if jj.shape != (S, N):
        raise ValueError(f"j_s: need shape (S, {N}), got {tuple(jj.shape)}")
    _check_lanes(cry_s, S)
    v = _view(tb, carry_lane(cry_s, 0, copy=False), 2, DEFAULT_WEIGHTS, DEFAULT_FILTERS,
              enable_gpu=gpu_live)
    lib = _lib(v)
    U, D1 = _commit_inputs(tb, cry_s)
    g0, g_t = _lane_values(g, torch.int32, S, dev, "g")
    shape = _cluster_shape(lib, "k3c", True, False, v, S)
    out = Carry(*(torch.empty_like(t) for t in cry_s))
    seg = torch.empty(max(1, S * U * D1), dtype=_F32, device=dev)
    _check(lib.aggregate_commit_lanes_launch(ctypes.byref(v), ctypes.byref(_carry_out(out)), g0,
                                             _ptr_or_null(g_t), _ptr(jj), _ptr(tb.topo_dom),
                                             _ptr(tb.counter_topo), _ptr(tb.carr_topo), int(U),
                                             int(bool(gpu_live)), int(S), _ptr(seg), shape.C,
                                             shape.smem, _stream()),
           "aggregate_commit_lanes_kernel launch")
    _count(fanout or aggregate_commit_lanes, 1, v)
    aggregate_commit_lanes.last_shape = shape
    return out


def schedule_group_serial_lanes_kernel(tb: Tables, cry_s: Carry, active_s, g: int, valid,
                                       cap1: bool, w: ScoreWeights = DEFAULT_WEIGHTS,
                                       filters: FilterFlags = DEFAULT_FILTERS,
                                       ss_live: bool = False, sa_live: bool = False,
                                       n_zones: int = 2):
    """Launch K4 over S lanes (csrc/group_serial.cu
    schedule_group_serial_lanes_kernel, one cluster per lane; the shape and
    [S, STATS_WORDS] stats recorded on probe_group_serial_fanout). Returns
    (counts [S, N] i32, placed [S] i32), on the card; `cry_s` is only
    read."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    vd = torch.as_tensor(valid, dtype=torch.bool, device=dev).contiguous()
    S, active, v = _lane_view(tb, cry_s, active_s, n_zones, w, filters)
    lib = _lib(v)
    shape = _cluster_shape(lib, "k4", True, False, v, S)
    j = torch.empty((S, N), dtype=torch.int32, device=dev)
    placed = torch.empty(S, dtype=torch.int32, device=dev)
    fs = torch.empty(max(1, S * int(lib.group_serial_scratch_floats(ctypes.byref(v), shape.C))),
                     dtype=_F32, device=dev)
    stats = torch.zeros((S, STATS_WORDS), dtype=torch.int64, device=dev)
    _check(lib.schedule_group_serial_lanes_launch(ctypes.byref(v), int(g), _ptr(vd),
                                                  int(vd.shape[0]), int(bool(cap1)),
                                                  int(bool(ss_live)), int(bool(sa_live)), int(S),
                                                  _ptr(j), _ptr(placed), _ptr(fs), _ptr(stats),
                                                  shape.C, shape.smem, _stream()),
           "schedule_group_serial_lanes_kernel launch")
    probe_group_serial_fanout.last_shape = shape
    probe_group_serial_fanout.last_stats = stats
    _count(probe_group_serial_fanout, 1, v)
    return j, placed


def schedule_affinity_wave_lanes_kernel(tb: Tables, cry_s: Carry, active_s, g: int, m: int,
                                        cap1: bool, ss_live: bool = False,
                                        w: ScoreWeights = DEFAULT_WEIGHTS,
                                        filters: FilterFlags = DEFAULT_FILTERS,
                                        block: int = WAVE_BLOCK, n_zones: int = 2):
    """Launch K5 over S lanes (csrc/affinity_wave.cu
    schedule_affinity_wave_lanes_kernel, one cluster per lane; the shape
    and [S, AFFINITY_CLUSTER_STATS] stats recorded on
    probe_affinity_wave_fanout). Returns (counts [S, N] i32, placed [S] i32,
    stats [S, 3] i32), all on the card; `cry_s` is only read."""

    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    if N * block >= 2 ** 31 or block < 1:
        raise ValueError(f"affinity table {N}x{block} is out of the kernel's range")
    S, active, v = _lane_view(tb, cry_s, active_s, n_zones, w, filters, domains_capped=True)
    lib = _lib(v)
    shape = _cluster_shape(lib, "k5", True, False, v, S, block)
    j = torch.empty((S, N), dtype=torch.int32, device=dev)
    stats = torch.empty((S, len(AFFINITY_CLUSTER_STATS)), dtype=torch.int32, device=dev)
    fs = torch.empty(S * int(lib.affinity_scratch_floats(ctypes.byref(v), int(block), shape.C)),
                     dtype=_F32, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _check(lib.schedule_affinity_wave_lanes_launch(ctypes.byref(v), int(g), int(m),
                                                   int(bool(cap1)), int(bool(ss_live)),
                                                   int(block), int(S), _ptr(j), _ptr(stats),
                                                   _ptr(fs), shape.C, shape.smem, _stream()),
           "schedule_affinity_wave_lanes_kernel launch")
    end.record()
    _count(probe_affinity_wave_fanout, 1, v)
    probe_affinity_wave_fanout.last_events = (start, end)
    probe_affinity_wave_fanout.last_shape = shape
    probe_affinity_wave_fanout.last_cluster_stats = stats
    return j, stats[:, 0], stats[:, 1:4]


def aggregate_commit_lanes(tb: Tables, cry_s: Carry, g, j_s: torch.Tensor,
                           gpu_live: bool = False) -> Carry:
    """Commit row s of j_s (copies of group g, or of g[s] for an [S] tensor)
    into lane s of cry_s: the plain version for CPU tensors, K3c over lanes
    for CUDA tensors. Returns a new [S, ...] carry."""
    if _on_cpu(tb.alloc):
        return aggregate_commit_lanes_plain(tb, cry_s, g, j_s, gpu_live)
    return aggregate_commit_lanes_kernel(tb, cry_s, g, j_s, gpu_live)


def _add_stats(fn, stats: torch.Tensor) -> None:
    """Add the lanes' loop statistics, summed over lanes, to `fn.stats`."""
    total = stats.sum(dim=0, dtype=torch.int32)
    prev = fn.stats
    fn.stats = total if prev is None or prev.device != total.device else prev + total


def probe_serial_fanout(tb: Tables, cry_s: Carry, active_s, pod_group, forced_node, valid,
                        n_zones: int, enable_gpu: bool = True, enable_storage: bool = True,
                        w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS):
    """schedule_batch over S candidate node-active masks in one dispatch (JAX
    `probe_serial_fanout`): the plain version for CPU tensors, K2 over lanes
    for CUDA tensors. Returns (carry_s, placed_s [S] i32)."""
    run = schedule_batch_lanes_plain if _on_cpu(tb.alloc) else schedule_batch_lanes_kernel
    carry_s, choices = run(tb, cry_s, active_s, pod_group, forced_node, valid, n_zones, w,
                           filters, enable_gpu, enable_storage)
    return carry_s, (choices >= 0).sum(dim=1, dtype=torch.int32)


def probe_wave_fanout(tb: Tables, cry_s: Carry, active_s, g: int, m: int, cap1: bool,
                      gpu_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                      filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                      kmax: int = 0):
    """schedule_wave over S candidate node-active masks in one dispatch (JAX
    `probe_wave_fanout`): the plain version for CPU tensors, K3 over lanes
    for CUDA tensors, then K3c over lanes. Returns (carry_s, placed_s [S]
    i32); the loop statistics, summed over lanes, join `schedule_wave.stats`."""
    run = schedule_wave_lanes_plain if _on_cpu(tb.alloc) else schedule_wave_lanes_kernel
    j_s, placed_s, stats = run(tb, cry_s, active_s, g, m, cap1, w, filters, block, kmax, gpu_live)
    _add_stats(schedule_wave, stats)
    return aggregate_commit_lanes(tb, cry_s, g, j_s, gpu_live), placed_s


def probe_group_serial_fanout(tb: Tables, cry_s: Carry, active_s, g: int, valid, cap1: bool,
                              w: ScoreWeights = DEFAULT_WEIGHTS,
                              filters: FilterFlags = DEFAULT_FILTERS, ss_live: bool = False,
                              sa_live: bool = False, n_zones: int = 2):
    """schedule_group_serial over S candidate node-active masks in one
    dispatch (JAX `probe_group_serial_fanout`): the plain version for CPU
    tensors, K4 over lanes for CUDA tensors, then K3c over lanes. Returns
    (carry_s, placed_s [S] i32)."""
    run = (schedule_group_serial_lanes_plain if _on_cpu(tb.alloc)
           else schedule_group_serial_lanes_kernel)
    j_s, placed_s = run(tb, cry_s, active_s, g, valid, cap1, w, filters, ss_live, sa_live, n_zones)
    return aggregate_commit_lanes(tb, cry_s, g, j_s), placed_s


def probe_affinity_wave_fanout(tb: Tables, cry_s: Carry, active_s, g: int, m: int, cap1: bool,
                               ss_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                               filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                               n_zones: int = 2):
    """schedule_affinity_wave over S candidate node-active masks in one
    dispatch (JAX `probe_affinity_wave_fanout`): the plain version for CPU
    tensors, K5 over lanes for CUDA tensors, then K3c over lanes. Returns
    (carry_s, placed_s [S] i32); the epoch statistics, summed over lanes,
    join `schedule_affinity_wave.stats`."""
    run = (schedule_affinity_wave_lanes_plain if _on_cpu(tb.alloc)
           else schedule_affinity_wave_lanes_kernel)
    j_s, placed_s, stats = run(tb, cry_s, active_s, g, m, cap1, ss_live, w, filters, block,
                               n_zones)
    _add_stats(schedule_affinity_wave, stats)
    return aggregate_commit_lanes(tb, cry_s, g, j_s), placed_s


def _on(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()


def _serial_lanes(tb: Tables, fanout):
    """K2 over lanes for one fan-out: the plain lanes for CPU tensors, the
    kernel counted on `fanout` for CUDA tensors."""
    if _on_cpu(tb.alloc):
        return schedule_batch_lanes_plain
    return lambda *a: schedule_batch_lanes_kernel(*a, fanout=fanout)


def _wave_pair(tb: Tables, fanout):
    """(K3 over lanes, K3c over lanes) for one fan-out: the plain lanes for
    CPU tensors, the kernels counted on `fanout` for CUDA tensors."""
    if _on_cpu(tb.alloc):
        return schedule_wave_lanes_plain, aggregate_commit_lanes_plain
    return (lambda *a: schedule_wave_lanes_kernel(*a, fanout=fanout),
            lambda *a: aggregate_commit_lanes_kernel(*a, fanout=fanout))


def _wave_chain(tb: Tables, cry_s: Carry, active_s, g_sk, m_sk, cap1_sk, w: ScoreWeights,
                filters: FilterFlags, block: int, kmax: int, wave, commit):
    """K chained wave segments per lane, each `wave` (K3 over lanes) then
    `commit` (K3c over lanes) on the carry the segment before left: (carry_s,
    counts [S, K, N] i32, placed [S, K] i32). The loop statistics join
    `schedule_wave.stats`."""
    dev = tb.alloc.device
    # [K, S]: segment k's per-lane values are one contiguous row
    g_ks, m_ks, c_ks = (_on(a, t, dev).t().contiguous() for a, t in
                        ((g_sk, torch.int32), (m_sk, torch.int32), (cap1_sk, torch.bool)))
    counts, placed = [], []
    for k in range(g_ks.shape[0]):
        j_s, placed_s, stats = wave(tb, cry_s, active_s, g_ks[k], m_ks[k], c_ks[k], w, filters,
                                    block, kmax)
        _add_stats(schedule_wave, stats)
        cry_s = commit(tb, cry_s, g_ks[k], j_s)
        counts.append(j_s)
        placed.append(placed_s)
    return cry_s, torch.stack(counts, dim=1), torch.stack(placed, dim=1)


def serve_whatif_fanout(tb: Tables, cry_s: Carry, active_s, pod_group, forced_node, valid_s,
                        n_zones: int, enable_gpu: bool = True, enable_storage: bool = True,
                        w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS):
    """schedule_batch over S what-if requests of one union-encoded pod batch
    (JAX `serve_whatif_fanout`): every lane scans the union `pod_group` /
    `forced_node` [P] with its own `valid_s` [S, P] row, which picks out its
    request's rows; an invalid step is a no-op. The plain version for CPU
    tensors, K2 over lanes for CUDA tensors. Returns (carry_s, placed_s [S]
    i32)."""
    dev = tb.alloc.device
    carry_s, choices = _serial_lanes(tb, serve_whatif_fanout)(
        tb, cry_s, active_s, _on(pod_group, torch.int32, dev), _on(forced_node, torch.int32, dev),
        _on(valid_s, torch.bool, dev), n_zones, w, filters, enable_gpu, enable_storage)
    return carry_s, (choices >= 0).sum(dim=1, dtype=torch.int32)


def sweep_whatif_fanout(tb: Tables, cry_s: Carry, active_s, pod_group_s, forced_node_s,
                        valid_s, n_zones: int, enable_gpu: bool = True,
                        enable_storage: bool = True, w: ScoreWeights = DEFAULT_WEIGHTS,
                        filters: FilterFlags = DEFAULT_FILTERS):
    """schedule_batch over S scenario lanes, each with its own pod stream
    `pod_group_s`, `forced_node_s`, `valid_s` [S, P] (JAX
    `sweep_whatif_fanout`; [P] arrays are one stream every lane scans, as
    parallel/mesh.py `schedule_scenarios_on_mesh` passes them): the plain
    version for CPU tensors, K2 over lanes for CUDA tensors. Returns
    (carry_s, choices [S, P] i32, -1 = unschedulable)."""
    dev = tb.alloc.device
    return _serial_lanes(tb, sweep_whatif_fanout)(
        tb, cry_s, active_s, _on(pod_group_s, torch.int32, dev),
        _on(forced_node_s, torch.int32, dev), _on(valid_s, torch.bool, dev), n_zones, w, filters,
        enable_gpu, enable_storage)


def serve_wave_fanout(tb: Tables, cry_s: Carry, active_s, g_s, m_s, cap1_s,
                      w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                      block: int = WAVE_BLOCK, kmax: int = 0):
    """schedule_wave (gpu_live off) over S uniform-replica requests, each lane
    with its own group, replica count and cap1 (`g_s`, `m_s`, `cap1_s` [S]),
    then the aggregate commit (JAX `serve_wave_fanout`): the plain version for
    CPU tensors; for CUDA tensors one launch of K3 over lanes and one of K3c
    over lanes, both counted here. `block` and `kmax` are shared. Returns
    (carry_s, placed_s [S] i32)."""
    dev = tb.alloc.device
    carry_s, _, placed = _wave_chain(tb, cry_s, active_s, _on(g_s, torch.int32, dev)[:, None],
                                     _on(m_s, torch.int32, dev)[:, None],
                                     _on(cap1_s, torch.bool, dev)[:, None], w, filters, block,
                                     kmax, *_wave_pair(tb, serve_wave_fanout))
    return carry_s, placed[:, 0]


def sweep_wave_fanout(tb: Tables, cry_s: Carry, active_s, g_sk, m_sk, cap1_sk,
                      w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                      block: int = WAVE_BLOCK, kmax: int = 0):
    """K chained schedule_wave segments per lane (JAX `sweep_wave_fanout`,
    each segment `_sweep_wave_step`): lane s runs its groups `g_sk[s]`,
    replica counts `m_sk[s]` and cap1 flags `cap1_sk[s]` [K] in order,
    segment k's carry feeding segment k+1; a segment with m = 0 commits
    nothing. The plain version for CPU tensors; for CUDA tensors, per segment
    one launch of K3 over lanes and one of K3c over lanes (2K launches, all
    counted here). Returns (carry_s, counts [S, K, N] i32)."""
    carry_s, counts, _ = _wave_chain(tb, cry_s, active_s, g_sk, m_sk, cap1_sk, w, filters, block,
                                     kmax, *_wave_pair(tb, sweep_wave_fanout))
    return carry_s, counts


# --------------------------------------------------------- table extension ----
#
# Port of `open_simulator_tpu/parallel/mesh.py` `_extend_tables_impl` (:672)
# and `extend_tables_on_device` (:703), without the mesh shardings (A12). When
# the capacity search outgrows the encoded node bucket, every appended column
# is a verbatim copy of the template column already on the device (the probe
# session checked at build that the template copies are bit-identical), and
# the phantom re-padding writes constants, so the tables grow in place of a
# re-encode and a host upload. Only valid while the extension does not widen
# the domain axis (no hostname-keyed counter or carrier rows);
# simulator/probe.py re-uploads otherwise. `extend_tables_plain` is torch
# concatenation field by field as the JAX function; `extend_tables_kernel`
# launches csrc/extend.cu (K6) once for every field.

# Phantom fills mirror pad_batch_tables exactly: a padded column must be
# indistinguishable from one it would have produced.
_EXT_GN_FILL = (
    ("static_mask", False), ("mask_taint", False), ("mask_unsched", False),
    ("mask_aff", False), ("mask_extra", False),
    ("simon_raw", 0), ("nodeaff_raw", 0), ("taint_raw", 0), ("avoid_raw", 0),
    ("image_raw", 0), ("extra_raw", 0),
)
_EXT_DOM_FIELDS = ("counter_dom", "topo_dom", "carr_dom")  # filled with the sentinel
_EXT_NROW_FILL = (
    ("alloc", 0), ("dev_total", 0), ("vg_cap", 0), ("vg_nameid", 0),
    ("sdev_cap", 0), ("sdev_media", 0),
)
# (field, node axis, fill, sentinel?): node_zone is a [N] row filled with 0
EXT_FIELDS = ([(f, -1, fill, False) for f, fill in _EXT_GN_FILL]
              + [(f, -1, 0, True) for f in _EXT_DOM_FIELDS]
              + [(f, 0, fill, False) for f, fill in _EXT_NROW_FILL]
              + [("node_zone", -1, 0, False)])


def _check_extension(tb: Tables, n_real: int, k: int, template_col: int, n_pad_new: int) -> int:
    n_old = tb.alloc.shape[0]
    pad = n_pad_new - n_real - k
    if not (0 <= template_col < n_real <= n_old and k >= 0 and pad >= 0):
        raise ValueError(f"extension n_real={n_real} k={k} template_col={template_col} "
                         f"n_pad_new={n_pad_new} does not fit tables of {n_old} nodes")
    return pad


@torch.inference_mode()
def extend_tables_plain(tb: Tables, n_real: int, k: int, template_col: int, n_pad_new: int,
                        sentinel: int) -> Tables:
    """Plain version of `extend_tables_kernel` (JAX `_extend_tables_impl`):
    Tables [*, N_pad] -> [*, n_pad_new]: columns [0, n_real) kept, k copies of
    column `template_col`, then the phantom fill."""
    pad = _check_extension(tb, n_real, k, template_col, n_pad_new)

    def grow(a: torch.Tensor, axis: int, fill) -> torch.Tensor:
        a = a.movedim(axis, 0)
        parts = [a[:n_real], a[template_col:template_col + 1].expand(k, *a.shape[1:])]
        if pad:
            parts.append(torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype, device=a.device))
        return torch.cat(parts, dim=0).movedim(0, axis).contiguous()

    return tb._replace(**{f: grow(getattr(tb, f), axis, sentinel if sent else fill)
                          for f, axis, fill, sent in EXT_FIELDS})


EXT_MAX_FIELDS = 32  # csrc/extend.cu


class ExtField(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p), ("outer", ctypes.c_longlong),
                ("inner", ctypes.c_int), ("elem", ctypes.c_int), ("fill", ctypes.c_uint32),
                ("pad_", ctypes.c_int)]


class ExtArgs(ctypes.Structure):
    _fields_ = [("f", ExtField * EXT_MAX_FIELDS), ("n_fields", ctypes.c_int),
                ("n_old", ctypes.c_int), ("n_new", ctypes.c_int), ("n_real", ctypes.c_int),
                ("k", ctypes.c_int), ("template_col", ctypes.c_int)]


class ExtPlan(NamedTuple):
    """One K6 launch: its pointer table, the output buffers it points at
    (kept alive here) and the largest field's element count."""
    args: ExtArgs
    out: Dict[str, torch.Tensor]
    max_elems: int


def extend_tables_plan(tb: Tables, n_real: int, k: int, template_col: int, n_pad_new: int,
                       sentinel: int) -> ExtPlan:
    """Allocate the grown fields on the card and fill K6's pointer table."""
    _check_extension(tb, n_real, k, template_col, n_pad_new)
    dev = tb.alloc.device
    n_old = tb.alloc.shape[0]
    args = ExtArgs(n_fields=len(EXT_FIELDS), n_old=n_old, n_new=n_pad_new, n_real=n_real, k=k,
                   template_col=template_col)
    out: Dict[str, torch.Tensor] = {}
    max_elems = 1
    for i, (f, axis, fill, sent) in enumerate(EXT_FIELDS):
        a = getattr(tb, f)
        if a.device != dev or not a.is_contiguous() or a.element_size() not in (1, 4):
            raise ValueError(f"{f}: need a contiguous 1- or 4-byte tensor on {dev}")
        if a.shape[axis] != n_old:
            raise ValueError(f"{f}: node axis {a.shape[axis]} != {n_old}")
        shape = list(a.shape)
        shape[axis] = n_pad_new
        dst = torch.empty(shape, dtype=a.dtype, device=dev)
        out[f] = dst
        if axis == -1:
            outer, inner = a.numel() // n_old, 1
        else:
            outer, inner = 1, a.numel() // n_old
        value = sentinel if sent else fill
        if a.dtype == torch.float32:  # the fill's bit pattern (0.0: all zero bits)
            bits = struct.unpack("<I", struct.pack("<f", float(value)))[0]
        else:
            bits = int(value) & 0xffffffff
        args.f[i] = ExtField(src=a.data_ptr(), dst=dst.data_ptr(), outer=outer, inner=inner,
                             elem=a.element_size(), fill=bits)
        max_elems = max(max_elems, dst.numel())
    return ExtPlan(args, out, max_elems)


def extend_tables_launch(plan: ExtPlan) -> None:
    """Launch K6 (csrc/extend.cu extend_tables_kernel) on a plan: one launch
    writes every field of the node axis."""
    from . import build

    _check(build.library().extend_tables_launch(ctypes.byref(plan.args), plan.max_elems,
                                                _stream()),
           "extend_tables_kernel launch")
    extend_tables_on_device.launches += 1


def extend_tables_kernel(tb: Tables, n_real: int, k: int, template_col: int, n_pad_new: int,
                         sentinel: int) -> Tables:
    """K6 on fresh outputs; returns new Tables (the fields off the node axis
    are shared with `tb`)."""
    plan = extend_tables_plan(tb, n_real, k, template_col, n_pad_new, sentinel)
    extend_tables_launch(plan)
    return tb._replace(**plan.out)


def extend_tables_on_device(tables: Tables, *, n_real: int, k: int, template_col: int,
                            n_pad_new: int, sentinel: int) -> Tables:
    """Grow Tables by k template-column copies (+ phantom re-pad to
    n_pad_new) where they lie: the plain version for tables on the CPU, K6
    for tables on the card. `n_real` is the current real column count (the
    old phantom columns are overwritten), `sentinel` the padded domain
    sentinel id."""
    if _on_cpu(tables.alloc):
        return extend_tables_plain(tables, n_real, k, template_col, n_pad_new, sentinel)
    return extend_tables_kernel(tables, n_real, k, template_col, n_pad_new, sentinel)


_WRAPPERS = {"schedule_batch": schedule_batch, "feasibility": feasibility_jit,
             "schedule_wave": schedule_wave, "aggregate_commit": aggregate_commit,
             "schedule_group_serial": schedule_group_serial,
             "schedule_affinity_wave": schedule_affinity_wave,
             "probe_serial_fanout": probe_serial_fanout, "probe_wave_fanout": probe_wave_fanout,
             "probe_group_serial_fanout": probe_group_serial_fanout,
             "probe_affinity_wave_fanout": probe_affinity_wave_fanout,
             "serve_whatif_fanout": serve_whatif_fanout, "serve_wave_fanout": serve_wave_fanout,
             "sweep_wave_fanout": sweep_wave_fanout, "sweep_whatif_fanout": sweep_whatif_fanout,
             "aggregate_commit_lanes": aggregate_commit_lanes,
             "extend_tables": extend_tables_on_device, "explain_jit": explain_jit,
             "schedule_wave_sharded": schedule_wave_sharded_kernel,
             "schedule_affinity_wave_sharded": schedule_affinity_wave_sharded_kernel,
             "schedule_wave_rounds": schedule_wave_rounds_kernel,
             "schedule_affinity_wave_rounds": schedule_affinity_wave_rounds_kernel,
             "schedule_batch_sharded": schedule_batch_sharded_kernel,
             "explain_sharded": explain_sharded_kernel,
             "schedule_group_serial_sharded": schedule_group_serial_sharded_kernel,
             "aggregate_commit_sharded": aggregate_commit_sharded_kernel}
for _f in _WRAPPERS.values():
    _f.launches = _f.wide_launches = 0
# the sharded kernels' reads of (placed, last), one per epoch or round
schedule_wave_sharded_kernel.host_reads = 0
schedule_affinity_wave_sharded_kernel.host_reads = 0
schedule_wave_rounds_kernel.host_reads = 0
schedule_affinity_wave_rounds_kernel.host_reads = 0
schedule_batch.last_events = None
# the last launch's cluster shape (ops/cluster.py Shape) and its stats
# rows (ops/cluster.py STATS_WORDS; one per lane for the fan-outs)
for _f in (schedule_batch, schedule_group_serial, probe_serial_fanout, serve_whatif_fanout,
           sweep_whatif_fanout, probe_group_serial_fanout):
    _f.last_shape = _f.last_stats = None
# K3's and K5's (single lane and fan-outs): the last launch's cluster shape,
# its i32 stats rows (WAVE_CLUSTER_STATS, AFFINITY_CLUSTER_STATS) and its
# CUDA events (elapsed_time() once the caller has synchronized)
for _f in (schedule_wave, schedule_affinity_wave, probe_wave_fanout, serve_wave_fanout,
           sweep_wave_fanout, probe_affinity_wave_fanout):
    _f.last_shape = _f.last_cluster_stats = _f.last_events = None
schedule_wave.stats = None
schedule_affinity_wave.stats = None
schedule_affinity_wave.last_stats = None
# K3c's (single lane and over lanes), K7's, K1's and K14's rows stage's: the
# last launch's cluster shape
aggregate_commit.last_shape = aggregate_commit_lanes.last_shape = explain_jit.last_shape = None
feasibility_jit.last_shape = aggregate_commit_sharded_kernel.last_shape = None
# K10's and K11's: the cluster shape of the last call's stages
schedule_wave_rounds_kernel.last_shape = schedule_affinity_wave_rounds_kernel.last_shape = None
# launches of the kernels with their GPU-share / Open-Local branches on (a
# part of the wrappers' own counts)
BRANCH_LAUNCHES = dict.fromkeys(("feasibility/gpu_storage", "schedule_batch/gpu_storage",
                                 "schedule_wave/gpu_live", "aggregate_commit/gpu_live",
                                 "schedule_wave_sharded/gpu_live",
                                 "schedule_wave_rounds/gpu_live",
                                 "schedule_batch_sharded/gpu_storage",
                                 "aggregate_commit_sharded/gpu_live",
                                 "schedule_affinity_wave/ss_live"), 0)


def reset_launch_counts() -> None:
    for f in _WRAPPERS.values():
        f.launches = f.wide_launches = 0
    schedule_wave_sharded_kernel.host_reads = 0
    schedule_affinity_wave_sharded_kernel.host_reads = 0
    schedule_wave_rounds_kernel.host_reads = 0
    schedule_affinity_wave_rounds_kernel.host_reads = 0
    for k in BRANCH_LAUNCHES:
        BRANCH_LAUNCHES[k] = 0
    schedule_wave.stats = None
    schedule_affinity_wave.stats = None


def _summed(stats, names) -> Dict[str, int]:
    vals = [0] * len(names) if stats is None else stats.cpu().tolist()
    return dict(zip(names, vals))


def wave_stats() -> Dict[str, int]:
    """WAVE_STATS summed over the wave dispatches since reset_launch_counts()
    (reading it waits for the card)."""
    return _summed(schedule_wave.stats, WAVE_STATS)


def affinity_stats() -> Dict[str, int]:
    """AFFINITY_STATS summed over the affinity-wave dispatches since
    reset_launch_counts() (reading it waits for the card)."""
    return _summed(schedule_affinity_wave.stats, AFFINITY_STATS)


def launch_counts() -> Dict[str, int]:
    """Launches per wrapper, and per GPU-share / Open-Local branch."""
    return {**{name: f.launches for name, f in _WRAPPERS.items()}, **BRANCH_LAUNCHES}


def wide_launch_counts() -> Dict[str, int]:
    """The wrappers' launches in the wide build (a part of launch_counts)."""
    return {name: f.wide_launches for name, f in _WRAPPERS.items()}

