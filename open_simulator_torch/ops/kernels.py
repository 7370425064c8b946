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
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

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


def selector_spread_score(pernode, F, zones, Z: int, maxN):
    """SelectorSpread (selector_spread.go:104-160): per-node count score with
    2/3 zone blending over the feasible set F; unfloored."""
    node_score = torch.where(maxN > 0, 100.0 * (maxN - pernode) / maxN, 100.0)
    nz_count = torch.where(F, pernode, 0.0)
    zone_sums = torch.zeros(Z, dtype=_F32, device=pernode.device).index_add_(
        0, zones.long(), nz_count)
    maxZ = torch.max(torch.cat([zone_sums.new_zeros(1), zone_sums[1:]]))
    have_zones = torch.any(F & (zones > 0))
    zscore = torch.where(maxZ > 0, 100.0 * (maxZ - zone_sums[zones.long()]) / maxZ, 100.0)
    return torch.where(have_zones & (zones > 0),
                       node_score * (1.0 / 3.0) + zscore * (2.0 / 3.0), node_score)


def topology_weight(topo_size: torch.Tensor) -> torch.Tensor:
    """ln(topology size + 2), taken in f64 and rounded once to f32 (the
    kernel does the same with the device's f64 log)."""
    return torch.log((topo_size + 2.0).double()).float()


def schedule_anyway_score(cnt_sa, relevantF, dom_rows, svalid, maxskew, D: int):
    """PodTopologySpread ScheduleAnyway scoring (scoring.go:108-200)."""
    Ss = dom_rows.shape[0]
    marks = torch.zeros((Ss, D + 1), dtype=_F32, device=cnt_sa.device)
    marks.scatter_reduce_(1, dom_rows, relevantF.to(_F32).expand(Ss, -1).contiguous(),
                          reduce="amax")
    topo_size = torch.sum(marks[:, :D], dim=1)
    tpw = topology_weight(topo_size)
    contrib = cnt_sa * tpw[:, None] + (maxskew[:, None] - 1.0)
    sa_raw = _flr(_masked_sum(svalid, contrib))
    inf = torch.tensor(float("inf"), device=cnt_sa.device)
    sa_max = torch.clamp(torch.max(torch.where(relevantF, sa_raw, -inf)), min=0.0)
    sa_min_raw = torch.min(torch.where(relevantF, sa_raw, inf))
    sa_min = torch.where(torch.isfinite(sa_min_raw), sa_min_raw, 0.0)
    return torch.where(
        ~relevantF, 0.0,
        torch.where(sa_max > 0, _flr((sa_max + sa_min - sa_raw) * 100.0 / sa_max), 100.0))


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


def score_components(tb: Tables, cry: Carry, g: int, feasible, n_zones: int,
                     w: ScoreWeights = DEFAULT_WEIGHTS, enable_storage: bool = False) -> dict:
    """All normalized, weighted plugin score terms over the feasible set —
    {name: [N] f32} in COMPONENT_ORDER (Open-Local is the constant 0 without
    `enable_storage`)."""
    F = feasible
    dev = F.device
    inf = torch.tensor(float("inf"), device=dev)
    alloc_cm = tb.alloc[:, (CPU_I, MEM_I)]
    used = cry.nonzero + tb.grp_nonzero[g][None, :]
    least, balanced = least_balanced(used[:, 0], used[:, 1], alloc_cm[:, 0], alloc_cm[:, 1])

    simon_s = _flr(100.0 * tb.simon_raw[g])
    na_raw = tb.nodeaff_raw[g]
    t_raw = tb.taint_raw[g]
    ip_raw = interpod_raw(tb, cry, g)

    ss_id = int(tb.ss_t[g])
    has_ss = ss_id >= 0
    pernode = counter_rows_at(tb, cry, torch.tensor([max(ss_id, 0)], device=dev))[1][0]

    maxes = torch.amax(torch.where(F[None, :],
                                   torch.stack([simon_s, na_raw, t_raw, ip_raw, pernode]),
                                   -inf), dim=1)
    mins = torch.amin(torch.where(F[None, :], torch.stack([simon_s, ip_raw]), inf), dim=1)

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

    blended = selector_spread_score(pernode, F, tb.node_zone, max(2, n_zones),
                                    maxN=torch.clamp(maxes[4], min=0.0))
    if bool(tb.ss_skip[g]):
        selector_spread = torch.zeros_like(blended)
    else:
        selector_spread = _flr(blended) if has_ss else torch.full_like(blended, 100.0)

    # PodTopologySpread ScheduleAnyway scoring
    D = cry.counter.shape[1] - 1
    svalid, sidx = _slot_ids(tb.sa_t[g])
    _, sa_at, sa_key, sa_dom = counter_rows_at(tb, cry, sidx)
    ignored = torch.any(svalid[:, None] & ~sa_key, dim=0)
    relevantF = F & ~ignored
    pts = schedule_anyway_score(sa_at, relevantF, sa_dom, svalid, tb.sa_maxskew[g], D)

    # Open-Local Score (open-local.go:94-172): Binpack LVM + device ints, then
    # the plugin's own min-max normalization over F
    openlocal = 0.0
    if enable_storage:
        st = storage_alloc(tb, cry, g)
        st_raw = st["raw"]
        st_hi = torch.clamp(torch.amax(torch.where(F, st_raw, -inf)), min=0.0)
        st_lo_raw = torch.amin(torch.where(F, st_raw, inf))
        st_lo = torch.where(torch.isfinite(st_lo_raw), st_lo_raw, 0.0)
        st_rng = st_hi - st_lo
        openlocal = torch.where(st["has_storage"] & (st_rng > 0),
                                _flr((st_raw - st_lo) * 100.0 / st_rng), 0.0)

    return {
        "least": w.least * least,
        "balanced": w.balanced * balanced,
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
                w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS):
    """The xray flight recorder's diagnostic for one group against a carry
    (JAX `explain_pod`): `feasibility`, then `score_components` over the
    feasible mask. Plain version of `explain_kernel`. Returns (feasible [N]
    bool, stages {EXPLAIN_STAGES: [N] bool}, total [N] f32, components
    {COMPONENT_ORDER: [N] f32}); every component is computed on every node,
    only the normalizers and the zone sums are taken over the feasible set."""
    feasible, stages = feasibility(tb, cry, g, forced, valid, filters, enable_gpu=enable_gpu,
                                   enable_storage=enable_storage)
    comp = score_components(tb, cry, g, feasible, n_zones, w, enable_storage)
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
    T = cry.counter.shape[0]
    Tc = cry.carrier.shape[0]
    D = cry.counter.shape[1] - 1
    c = torch.as_tensor(choice, device=dev).long().clamp(min=0).reshape(1)
    do_t = torch.as_tensor(do, device=dev).bool()
    dof = do_t.to(_F32)

    requested = cry.requested.index_add(0, c, (tb.grp_requests[g] * dof)[None])
    nonzero = cry.nonzero.index_add(0, c, (tb.grp_nonzero[g] * dof)[None])
    pids = tb.grp_ports[g].long()
    port_used = cry.port_used.clone()
    port_used[c, pids] = port_used[c, pids] | ((pids > 0) & do_t)

    dom_col = tb.counter_dom[:, c[0]].long()
    inc = tb.counter_sel_match_g[:, g].to(_F32) * (dom_col < D) * dof
    counter = cry.counter.index_put((torch.arange(T, device=dev), dom_col), inc, accumulate=True)

    cdom_col = tb.carr_dom[:, c[0]].long()
    cinc = tb.grp_carries[g] * (cdom_col < D) * dof
    carrier = cry.carrier.index_put((torch.arange(Tc, device=dev), cdom_col), cinc,
                                    accumulate=True)

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
    return Carry(requested, nonzero, port_used, counter, carrier, dev_used, vg_req, sdev_alloc)


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


def _wave_score_table(tb: Tables, cry: Carry, st: dict, norms: tuple, g: int, j: torch.Tensor,
                      w: ScoreWeights = DEFAULT_WEIGHTS, block: int = WAVE_BLOCK) -> torch.Tensor:
    """[N, B+1] table: entry (n, k) is the score of the (j_n+k+1)-th copy of
    group g on node n. Term by term the formulas of scores(); the terms that
    are constant on F (SelectorSpread, PodTopologySpread, Open-Local) are
    dropped, since a uniform shift never changes the order the wave takes."""
    dev = j.device
    copies = (j.to(_F32)[:, None, None]
              + torch.arange(1, block + 2, dtype=_F32, device=dev)[None, :, None])
    used = cry.nonzero[:, None, :] + tb.grp_nonzero[g][None, None, :] * copies  # [N, B+1, 2]
    a_c, a_m = tb.alloc[:, CPU_I], tb.alloc[:, MEM_I]
    least, balanced = least_balanced(used[:, :, 0], used[:, :, 1], a_c[:, None], a_m[:, None])
    simon, nodeaff, taint, interpod = _normalized_terms(st, norms)
    static_n = ((w.simon + w.gpushare) * simon + w.nodeaff * nodeaff + w.taint * taint
                + w.interpod * interpod + st["static"])
    return w.least * least + w.balanced * balanced + static_n[:, None]


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


def _wave_candidates_from(table_ext, avail, F, B: int, iota_n, kmax: int):
    """The usable-entry mask (capacity, monotone prefix, hidden-continuation
    guard) and the top-kmax candidates in serial's pick order. Returns
    (table [N, B], idx_srt, ex_srt, vals, guarded): idx_srt, ex_srt and vals
    are [kmax]; guarded counts the entries the guard deferred."""
    N = table_ext.shape[0]
    dev = table_ext.device
    ninf = torch.tensor(float("-inf"), device=dev)
    table = table_ext[:, :B]
    ks = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    in_cap = ks < avail[:, None]
    step_ok = torch.cat([torch.ones((N, 1), dtype=torch.int32, device=dev),
                         (table[:, 1:] <= table[:, :-1]).to(torch.int32)], dim=1)
    mono = torch.cumprod(step_ok, dim=1) > 0
    usable = in_cap & mono & F[:, None]

    # an entry is takeable only if its key (score desc, index asc) strictly
    # beats every OTHER node's first hidden entry (past depth B or past a
    # monotonicity break)
    first_bad = torch.amin(torch.where(mono, B, ks), dim=1)
    k_hid = torch.clamp(first_bad, max=B)
    has_hidden = (k_hid < avail) & F
    bound = torch.where(has_hidden,
                        torch.gather(table_ext, 1, k_hid.long()[:, None])[:, 0], ninf)
    b1 = torch.amax(bound)
    i1 = torch.argmax(bound)  # first max = lowest index among ties
    bound2 = bound.clone()
    bound2[i1] = ninf
    b2 = torch.amax(bound2)
    i2 = torch.argmax(bound2)
    cut_s = torch.where(iota_n == i1, b2, b1)
    cut_i = torch.where(iota_n == i1, i2, i1).to(torch.int32)
    beats = (table > cut_s[:, None]) | ((table == cut_s[:, None])
                                        & (iota_n[:, None] < cut_i[:, None]))
    guarded = int((usable & ~beats).sum())
    usable = usable & beats

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


@torch.inference_mode()
def schedule_wave_plain(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                        w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                        block: int = WAVE_BLOCK, kmax: int = 0, gpu_live: bool = False):
    """Plain version of `schedule_wave_kernel`: place up to m pods of the
    wave-eligible group g, reproducing m serial steps. Returns (per-node
    counts [N] i32, placed, stats); the carry is not touched (the aggregate
    commit applies the counts). stats counts the loop's iterations, its
    head-fallback iterations and the entries the hidden-continuation guard
    deferred, summed over iterations. `gpu_live`: the group asks for shared
    GPU memory (no pre-assigned gpu-index): the GPU filter joins the base
    feasibility and GPU units clamp the capacity; the scores do not move."""
    N = tb.alloc.shape[0]
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
        avail = capacity - j  # copies left per node
        F = base_feas & (avail > 0)
        norms = _wave_norms(st, F)
        table_ext = _wave_score_table(tb, cry, st, norms, g, j, w, block)
        j, placed, last_w, it = _wave_iteration(st, norms, table_ext, F, avail, j, placed, m,
                                                block, K)
        stats["iterations"] += 1
        for k, v in it.items():
            stats[k] += v
    return j, placed, stats


@torch.inference_mode()
def aggregate_commit_plain(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                           gpu_live: bool = False) -> Carry:
    """The sum of sum(j) serial commit() calls for group g (j = per-node
    counts), as one update of the carry; returns a new Carry. Plain version
    of `aggregate_commit_kernel`. With `gpu_live`, the device ledger replays
    the allocator one copy at a time on every node (JAX :1007-1031), so it
    equals the serial commits' ledger bit for bit."""
    jf = j.to(_F32)
    D = cry.counter.shape[1] - 1
    requested = cry.requested + tb.grp_requests[g][None, :] * jf[:, None]
    nonzero = cry.nonzero + tb.grp_nonzero[g][None, :] * jf[:, None]
    # a placed copy claims the group's host ports on its node (idempotent bits)
    pids = tb.grp_ports[g].long()
    port_used = cry.port_used.clone()
    port_used[:, pids] = port_used[:, pids] | ((pids > 0)[None, :] & (j > 0)[:, None])
    # counter/carrier rows of one topology key share their domain row: reduce
    # the counts once per unique topology, then broadcast to the rows
    U = tb.topo_dom.shape[0]
    dom = tb.topo_dom.long()
    seg = torch.zeros((U, D + 1), dtype=_F32, device=jf.device).scatter_add_(
        1, dom, jf[None, :] * (dom < D))
    counter = (cry.counter + tb.counter_sel_match_g[:, g, None].to(_F32)
               * seg[tb.counter_topo.long()])
    carrier = cry.carrier + tb.grp_carries[g][:, None] * seg[tb.carr_topo.long()]
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
                        counter=counter, carrier=carrier, dev_used=dev_used)


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
K_EP_MAX = 2048  # width of one epoch's candidate order (JAX K_EP = min(N*B, 2048))
LMAX = 32        # min-rise levels one multi-level round may take
# K5 keys a candidate by (domain, position) in 32 bits: 11 bits of position
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
    # to their budget (a multi-level round marks every eligible or touched one)
    blocked_d = (q < 1.0) | ((consumed_d >= q) & torch.isfinite(q))
    if use_full:
        blocked_d = blocked_d | edom_live | (consumed_d > 0)
    everb = rs["everb"] | (blocked_d[ep["dom_live"].long()] & ep["has_budget"])
    real = torch.arange(D + 1, device=dev) < D
    return {"taken_d": taken_d + consumed_d * real, "counts": rs["counts"] + counts_r,
            "got": rs["got"] + n_take, "last": n_take, "everb": everb,
            "rounds": rs["rounds"] + int(n_take > 0)}


@torch.inference_mode()
def schedule_affinity_wave_plain(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                 ss_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                                 filters: FilterFlags = DEFAULT_FILTERS,
                                 block: int = WAVE_BLOCK, n_zones: int = 2):
    """Plain version of `schedule_affinity_wave_kernel`: place up to m pods
    of the affinity-route group g, exactly as m serial steps would. Returns
    (per-node counts [N] i32, placed, stats) with stats the AFFINITY_STATS
    dict (epochs, head-fallback epochs, productive multi-rounds); the carry is
    not touched (the aggregate commit applies the counts)."""
    N = tb.alloc.shape[0]
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
    doms_same = all(bool(torch.all(~live[:, None] | (dom == dom_live[None, :].long())))
                    for live, dom in ((live_dns, dom_dns), (live_anti, dom_anti),
                                      (live_car, dom_car)))
    budget_composes = n_budget <= 1 or (n_dns == 0 and doms_same)
    edom_live = _sel(live_dns, edom.to(_F32)) > 0           # [D+1]
    ep = {
        "D": D, "INF_P": INF_P, "pos_k": pos_k, "edom_live": edom_live, "dom_live": dom_live,
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

    def norm_stacks(ip_raw, pernode0):
        rows = [st0["simon_s"], st0["na_raw"], st0["t_raw"], ip_raw]
        if ss_live:
            rows.append(pernode0)
        return torch.stack(rows), torch.stack([st0["simon_s"], ip_raw])

    def epoch(state: AffinityWaveState) -> AffinityWaveState:
        j = state.j
        cnt_dns, cnt_aff, cnt_anti, cnt_car, cnt_cw, cnt_ss = state[1:7]
        avail = capacity - j

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
        at_b = torch.gather(cnt_anti, 1, dom_anti) > 0
        blocked_in = torch.any(at_b & bvalid[:, None], dim=0)
        blocked_in_st = torch.any(at_b & bvalid[:, None] & ~live_anti[:, None], dim=0)
        at_c = torch.gather(cnt_car, 1, dom_car) > 0
        blocked_ex = torch.any(at_c & cavalid[:, None], dim=0)
        blocked_ex_st = torch.any(at_c & cavalid[:, None] & ~live_car[:, None], dim=0)
        # F_start: serial's current feasible set; F_hi: live budget gates
        # lifted (the sandwich's upper set)
        room = base_feas & (avail > 0) & aff_ok
        F_start = room & dns_ok & ~blocked_in & ~blocked_ex
        F_hi = room & dns_ok_static & ~blocked_in_st & ~blocked_ex_st & dns_key_live_ok

        # ---- live scores: ip_raw from the live carrier rows, ss per node
        cw_at = torch.gather(cnt_cw, 1, dom_cw)
        ip_raw = ip_pref + _masked_sum(cwvalid, cw_w[:, None] * cw_at)
        pernode0 = torch.gather(cnt_ss, 1, dom_ss)[0]
        max_stack, min_stack = norm_stacks(ip_raw, pernode0)
        maxes_s, mins_s = _norm_vals(max_stack, min_stack, F_start)
        maxes_h, mins_h = _norm_vals(max_stack, min_stack, F_hi)
        norms6 = (maxes_s[0], mins_s[0], torch.clamp(maxes_s[1], min=0.0),
                  torch.clamp(maxes_s[2], min=0.0), torch.clamp(maxes_s[3], min=0.0),
                  torch.clamp(mins_s[1], max=0.0))
        any_hi = bool(torch.any(F_hi))
        # uniform normalizer inputs over F_hi pin every normalizer
        base_hi_min = torch.amin(torch.where(F_hi[None, :], max_stack[:4], float("inf")), dim=1)
        uniform_base = bool(torch.all(maxes_h[:4] == base_hi_min)) and any_hi
        # ip liveness: the frozen table is exact only while ip_raw is uniform
        # over F_hi and each live carrier's domain is single-valued there
        ip_safe = True
        if has_live_cw and any_hi:
            dmax = torch.amax(torch.where(F_hi[None, :], dom_cw, -1), dim=1)
            dmin = torch.amin(torch.where(F_hi[None, :], dom_cw, D + 2), dim=1)
            dom_same = bool(torch.all(~live_cw | (dmax == dmin)))
            ip_safe = dom_same and bool(maxes_h[3] == mins_h[1])

        # ---- the score table under serial's current normalizers
        st_ep = dict(st0, ip_raw=ip_raw)
        table_ext = _wave_score_table(tb, cry, st_ep, norms6, g, j, w, B)
        if ss_live:
            # live SelectorSpread, term for term, maxN and zone sums frozen at
            # the epoch start; column c = c earlier takes on the node
            maxN = torch.clamp(maxes_s[4], min=0.0)
            pernode_k = pernode0[:, None] + torch.arange(B + 1, dtype=_F32, device=dev)[None, :]
            node_score = torch.where(maxN > 0, 100.0 * (maxN - pernode_k) / maxN, 100.0)
            nz_count = torch.where(F_start, pernode0, 0.0)
            zone_sums = torch.zeros(Z, dtype=_F32, device=dev).index_add_(0, zones, nz_count)
            maxZ = torch.amax(torch.cat([zone_sums.new_zeros(1), zone_sums[1:]]))
            have_zones = bool(torch.any(F_start & (zones > 0)))
            zscore = torch.where(maxZ > 0, 100.0 * (maxZ - zone_sums[zones]) / maxZ, 100.0)
            blended = torch.where((have_zones & (zones > 0))[:, None],
                                  node_score * (1.0 / 3.0) + zscore[:, None] * (2.0 / 3.0),
                                  node_score)
            table_ext = table_ext + w.ss * _flr(blended)
            # depth cap: a take past the frozen maxN would move it
            k_cap = torch.clamp(maxN - pernode0, 0.0, float(B)).to(torch.int32)
            ss_multi_ok = not have_zones  # zone sums move with every zoned take
        else:
            k_cap = torch.full((N,), B, dtype=torch.int32, device=dev)
            ss_multi_ok = True
        table = table_ext[:, :B]

        pre_norms_ok = uniform_base or _norms_eq(zip((maxes_s[:4], mins_s),
                                                     (maxes_h[:4], mins_h)))
        if ss_live:
            pre_norms_ok = pre_norms_ok and bool(maxes_s[4] == maxes_h[4])
        use_multi_pre = (budget_composes and not bootstrap and ip_safe and ss_multi_ok
                         and pre_norms_ok)
        m_rem = m - state.placed
        rs = {"counts": torch.zeros(N, dtype=torch.int32, device=dev), "got": 0, "last": 1,
              "rounds": 0, "everb": torch.zeros(N, dtype=torch.bool, device=dev)}
        if use_multi_pre:
            # ---- candidates: capacity, depth cap, monotone prefix, and the
            # hidden-continuation cut (the JAX expressions; the rounds never
            # run when use_multi_pre is off, so neither does this)
            ks = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
            in_cap = ks < torch.minimum(avail, k_cap)[:, None]
            step_ok = torch.cat([torch.ones((N, 1), dtype=torch.int32, device=dev),
                                 (table[:, 1:] <= table[:, :-1]).to(torch.int32)], dim=1)
            mono = torch.cumprod(step_ok, dim=1) > 0
            usable = in_cap & mono & F_hi[:, None]
            first_bad = torch.amin(torch.where(mono, B, ks), dim=1)
            k_hid = torch.minimum(torch.clamp(first_bad, max=B), k_cap)
            has_hidden = (k_hid < avail) & F_hi
            bound = torch.where(has_hidden,
                                torch.gather(table_ext, 1, k_hid.long()[:, None])[:, 0], ninf)
            b1, i1 = torch.amax(bound), torch.argmax(bound)
            bound2 = bound.clone()
            bound2[i1] = ninf
            b2, i2 = torch.amax(bound2), torch.argmax(bound2)
            cut_s = torch.where(iota_n == i1, b2, b1)
            cut_i = torch.where(iota_n == i1, i2, i1).to(torch.int32)
            beats = (table > cut_s[:, None]) | ((table == cut_s[:, None])
                                                & (iota_n[:, None] < cut_i[:, None]))
            usable = usable & beats
            # the top K_EP entries in lax.top_k order (score desc, flat index
            # asc), then each entry's rank among its domain's candidates
            vals_k, flat_pos = _top_k(torch.where(usable, table, ninf).reshape(-1), K_EP)
            idx_srt = torch.div(flat_pos, B, rounding_mode="floor").to(torch.int32)
            cand = torch.isfinite(vals_k)
            dom_srt = dom_live[idx_srt.long()]
            dkey = torch.where(cand, dom_srt, D + 1)
            d2, p2 = torch.sort(dkey, stable=True)
            run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), d2[1:] != d2[:-1]])
            seg_start = torch.cummax(torch.where(run_start, pos_k, 0), dim=0).values
            occ_all = torch.zeros(K_EP, dtype=_F32, device=dev)
            occ_all[p2] = (pos_k - seg_start).to(_F32)
            cnt_live = (_sel(live_dns, cnt_dns) + _sel(live_anti, cnt_anti)
                        + _sel(live_car, cnt_car))
            ep.update(cand=cand, dom_srt=dom_srt, occ_all=occ_all, idx_srt=idx_srt,
                      cnt_live=cnt_live, m_rem=m_rem)
            rs["taken_d"] = torch.zeros(D + 1, dtype=_F32, device=dev)
            # the condition is read once per chain of four rounds, as in JAX
            while rs["last"] > 0 and rs["got"] < m_rem:
                for _ in range(4):
                    rs = _affinity_round(rs, ep)

        # ---- the normalizer sandwich: S_lo <= every F_t <= F_hi
        use_multi = False
        if use_multi_pre and rs["got"] > 0:
            F_lo = F_hi & ~rs["everb"] & ~(rs["counts"] >= avail)
            maxes_l, mins_l = _norm_vals(max_stack, min_stack, F_lo)
            lo_ok = uniform_base or _norms_eq(zip((maxes_h[:4], mins_h), (maxes_l[:4], mins_l)))
            if ss_live:
                lo_ok = lo_ok and bool(maxes_h[4] == maxes_l[4])
            use_multi = lo_ok
        # the head fallback: serial's single next pick is always exact
        use_head = not use_multi and bool(torch.any(F_start)) and m_rem > 0
        if use_multi:
            counts, m_take = rs["counts"], rs["got"]
        else:
            counts = torch.zeros(N, dtype=torch.int32, device=dev)
            m_take = 0
            if use_head:
                counts[torch.argmax(torch.where(F_start, table[:, 0], ninf))] = 1
                m_take = 1

        # fold the takes into every counter/carrier row (the sentinel column
        # never counts, as in commit())
        cf = counts.to(_F32)
        col_real = (torch.arange(D + 1, device=dev) < D).to(_F32)

        def upd(rows, doms, incs):
            add = torch.zeros_like(rows).scatter_add_(1, doms, cf[None, :] * incs[:, None])
            return rows + add * col_real

        e, h, r = state.ep_stats
        return AffinityWaveState(
            j + counts, upd(cnt_dns, dom_dns, inc_dns), upd(cnt_aff, dom_aff, inc_aff),
            upd(cnt_anti, dom_anti, inc_anti), upd(cnt_car, dom_car, inc_car),
            upd(cnt_cw, dom_cw, inc_cw), upd(cnt_ss, dom_ss, ss_match),
            state.placed + m_take, m_take,
            (e + 1, h + int(use_head), r + (rs["rounds"] if use_multi else 0)))

    state = AffinityWaveState(
        torch.zeros(N, dtype=torch.int32, device=dev), cry.counter[dids], cry.counter[aids],
        cry.counter[bids], cry.carrier[ca_ids], cry.carrier[cw_ids], cry.counter[ss_idx],
        0, 1, (0, 0, 0))
    while state.last > 0 and state.placed < m:
        state = epoch(state)
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
MAX_SLOTS = 64  # per-group slot axes (A, B, Cp, Sd, Ss, Ca, Cw, PP, SL, SD) the kernels hold
MAX_NODE_DEVS = 32  # per-node GPU devices, volume groups and storage devices a thread holds


class TablesView(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name, _ in _PTR_FIELDS]
                + [(name, ctypes.c_int) for name in _DIM_FIELDS]
                + [("w", ctypes.c_float * N_WEIGHTS)])


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
          enable_storage: bool = False, active=None) -> TablesView:
    """Check every tensor (device, dtype, contiguity) and fill the struct.
    `enable_gpu` / `enable_storage` switch the kernels' GPU-share and
    Open-Local branches on. A lane kernel passes lane 0 of its [S, ...]
    carry (`carry_lane(cry_s, 0, copy=False)`) and its [S, N] `active`."""
    dev = tb.alloc.device
    src = {**tb._asdict(), **cry._asdict(), "active": active}
    v = TablesView()
    for name, field in _PTR_FIELDS:
        t = src[field]
        if t is None and name == "active":
            continue
        want = _EXPECT.get(name, torch.float32)
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {want} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
        setattr(v, name, t.data_ptr())
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
    for k in ("A", "B", "Cp", "Sd", "Ss", "Ca", "Cw", "PP", "SL", "SD"):
        if dims[k] > MAX_SLOTS:
            raise ValueError(f"slot axis {k}={dims[k]} exceeds the kernel's {MAX_SLOTS}")
    for k in ("MAXDEV",) * bool(enable_gpu) + ("MAXVG", "MAXSD") * bool(enable_storage):
        if dims[k] > MAX_NODE_DEVS:
            raise ValueError(f"node axis {k}={dims[k]} exceeds the kernel's {MAX_NODE_DEVS}")
    if tb.alloc.shape[1] <= max(CPU_I, MEM_I):
        raise ValueError("alloc needs the cpu and memory columns")
    for k, val in dims.items():
        setattr(v, k, int(val))
    weights = (w.least, w.balanced, w.openlocal, w.simon + w.gpushare, w.nodeaff,
               w.taint, w.interpod, w.ss, w.pts, w.avoid, w.image, 1.0)
    for i, x in enumerate(weights):
        v.w[i] = float(x)
    return v


def _check(rc: int, what: str) -> None:
    if rc != 0:
        from . import build

        raise RuntimeError(f"{what} failed: {build.error_string(rc)} (cudaError {rc})")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def feasibility_kernel(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                       filters: FilterFlags = DEFAULT_FILTERS, include_dns: bool = True,
                       enable_gpu: bool = False, enable_storage: bool = False):
    """Launch K1 (csrc/schedule.cu feasibility_kernel): one thread per node.
    Returns (feasible [N] bool, stages {STAGE_KEYS: tensor})."""
    from . import build

    lib = build.library()
    N, R = tb.alloc.shape
    dev = tb.alloc.device
    v = _view(tb, cry, 2, DEFAULT_WEIGHTS, filters, enable_gpu, enable_storage)
    feasible = torch.empty(N, dtype=torch.bool, device=dev)
    stage_rows = torch.empty((len(STAGE_ROWS), N), dtype=torch.bool, device=dev)
    fit_each = torch.empty((N, R), dtype=torch.bool, device=dev)
    _check(lib.feasibility_launch(ctypes.byref(v), int(g), int(forced), int(bool(valid)),
                                  int(bool(include_dns)),
                                  ctypes.c_void_p(feasible.data_ptr()),
                                  ctypes.c_void_p(stage_rows.data_ptr()),
                                  ctypes.c_void_p(fit_each.data_ptr()), _stream()),
           "feasibility_kernel launch")
    feasibility_jit.launches += 1
    if enable_gpu or enable_storage:
        BRANCH_LAUNCHES["feasibility/gpu_storage"] += 1
    stages = {k: stage_rows[i] for i, k in enumerate(STAGE_ROWS)}
    stages["fit_each"] = fit_each
    return feasible, {k: stages[k] for k in STAGE_KEYS}


def schedule_batch_kernel(tb: Tables, cry: Carry, pod_group, forced_node, valid,
                          n_zones: int, w: ScoreWeights = DEFAULT_WEIGHTS,
                          filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                          enable_storage: bool = False):
    """Launch K2 (csrc/schedule.cu schedule_batch_kernel): one persistent
    block that loops over the P pods. The returned carry is a CLONE of `cry`
    that the kernel updates in place; `cry` itself is left untouched."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    out = Carry(*(t.clone() for t in cry))
    pg = torch.as_tensor(pod_group, dtype=torch.int32, device=dev).contiguous()
    fn = torch.as_tensor(forced_node, dtype=torch.int32, device=dev).contiguous()
    vd = torch.as_tensor(valid, dtype=torch.bool, device=dev).contiguous()
    P = pg.shape[0]
    if fn.shape[0] != P or vd.shape[0] != P:
        raise ValueError("pod_group, forced_node and valid must have one length")
    v = _view(tb, out, n_zones, w, filters, enable_gpu, enable_storage)
    choices = torch.empty(P, dtype=torch.int32, device=dev)
    scratch = torch.empty(int(lib.schedule_scratch_floats(ctypes.byref(v))),
                          dtype=torch.float32, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _check(lib.schedule_batch_launch(ctypes.byref(v), ctypes.c_void_p(pg.data_ptr()),
                                     ctypes.c_void_p(fn.data_ptr()),
                                     ctypes.c_void_p(vd.data_ptr()), int(P),
                                     ctypes.c_void_p(choices.data_ptr()),
                                     ctypes.c_void_p(scratch.data_ptr()), _stream()),
           "schedule_batch_kernel launch")
    end.record()
    schedule_batch.launches += 1
    if enable_gpu or enable_storage:
        BRANCH_LAUNCHES["schedule_batch/gpu_storage"] += 1
    # the launch's CUDA events: elapsed_time() once the caller has synchronized
    schedule_batch.last_events = (start, end)
    return out, choices


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
    """Launch K3 (csrc/wave.cu schedule_wave_kernel): one persistent block
    runs the whole wave loop. Returns (per-node counts [N] i32, placed as a
    0-dim i32 tensor, [iterations, head_fallbacks, guarded] i32), all on the
    card; `cry` is only read."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    K = kmax if kmax else N * block
    if N * block >= 2 ** 31 or not 1 <= K <= N * block:
        raise ValueError(f"wave table {N}x{block} with kmax {K} is out of the kernel's range")
    v = _view(tb, cry, 2, w, filters, enable_gpu=gpu_live)
    j = torch.empty(N, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.wave_scratch_floats(N, block)), dtype=_F32, device=dev)
    iscr = torch.empty(int(lib.wave_scratch_ints(N)), dtype=torch.int32, device=dev)
    _check(lib.schedule_wave_launch(ctypes.byref(v), int(g), int(m), int(bool(cap1)),
                                    int(block), int(K), _ptr(j), _ptr(stats), _ptr(fs),
                                    _ptr(iscr), _stream()),
           "schedule_wave_kernel launch")
    schedule_wave.launches += 1
    if gpu_live:
        BRANCH_LAUNCHES["schedule_wave/gpu_live"] += 1
    return j, stats[0], stats[1:]


def aggregate_commit_kernel(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                            gpu_live: bool = False) -> Carry:
    """Launch K3c (csrc/wave.cu aggregate_commit_kernel) on a CLONE of `cry`,
    which it updates in place and returns; `cry` is left untouched."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    out = Carry(*(t.clone() for t in cry))
    v = _view(tb, out, 2, DEFAULT_WEIGHTS, DEFAULT_FILTERS, enable_gpu=gpu_live)
    jj = _i32_on(j, dev, tb.alloc.shape[0], "j")
    for name in ("topo_dom", "counter_topo", "carr_topo"):
        t = getattr(tb, name)
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous int32 tensor on {dev}")
    U = tb.topo_dom.shape[0]
    seg = torch.empty(U * cry.counter.shape[1], dtype=_F32, device=dev)
    _check(lib.aggregate_commit_launch(ctypes.byref(v), int(g), _ptr(jj), _ptr(tb.topo_dom),
                                       _ptr(tb.counter_topo), _ptr(tb.carr_topo), int(U),
                                       int(bool(gpu_live)), _ptr(seg), _stream()),
           "aggregate_commit_kernel launch")
    aggregate_commit.launches += 1
    if gpu_live:
        BRANCH_LAUNCHES["aggregate_commit/gpu_live"] += 1
    return out


def schedule_group_serial_kernel(tb: Tables, cry: Carry, g: int, valid, cap1: bool,
                                 w: ScoreWeights = DEFAULT_WEIGHTS,
                                 filters: FilterFlags = DEFAULT_FILTERS,
                                 ss_live: bool = False, sa_live: bool = False, n_zones: int = 2):
    """Launch K4 (csrc/group_serial.cu schedule_group_serial_kernel): one
    persistent block loops over the pods. Returns (per-node counts [N] i32,
    placed as a 0-dim i32 tensor), on the card; `cry` is only read."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    vd = torch.as_tensor(valid, dtype=torch.bool, device=dev).contiguous()
    v = _view(tb, cry, n_zones, w, filters)
    j = torch.empty(N, dtype=torch.int32, device=dev)
    placed = torch.empty(1, dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.group_serial_scratch_floats(ctypes.byref(v))), dtype=_F32,
                     device=dev)
    iscr = torch.empty(int(lib.group_serial_scratch_ints(ctypes.byref(v))), dtype=torch.int32,
                       device=dev)
    _check(lib.schedule_group_serial_launch(ctypes.byref(v), int(g), _ptr(vd), int(vd.shape[0]),
                                            int(bool(cap1)), int(bool(ss_live)),
                                            int(bool(sa_live)), _ptr(j), _ptr(placed),
                                            _ptr(fs), _ptr(iscr), _stream()),
           "schedule_group_serial_kernel launch")
    schedule_group_serial.launches += 1
    return j, placed[0]


def schedule_affinity_wave_kernel(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                                  ss_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                                  filters: FilterFlags = DEFAULT_FILTERS,
                                  block: int = WAVE_BLOCK, n_zones: int = 2):
    """Launch K5 (csrc/affinity_wave.cu schedule_affinity_wave_kernel): one
    persistent block runs the whole epoch loop. Returns (per-node counts [N]
    i32, placed as a 0-dim i32 tensor, [epochs, head_fallbacks,
    multi_rounds] i32), all on the card; `cry` is only read."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    if N * block >= 2 ** 31 or block < 1:
        raise ValueError(f"affinity table {N}x{block} is out of the kernel's range")
    if cry.counter.shape[1] > AFFINITY_MAX_D1:
        raise ValueError(f"{cry.counter.shape[1]} domains exceed the kernel's {AFFINITY_MAX_D1}")
    v = _view(tb, cry, n_zones, w, filters)
    j = torch.empty(N, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    fs = torch.empty(int(lib.affinity_scratch_floats(ctypes.byref(v), int(block))), dtype=_F32,
                     device=dev)
    iscr = torch.empty(int(lib.affinity_scratch_ints(ctypes.byref(v))), dtype=torch.int32,
                       device=dev)
    _check(lib.schedule_affinity_wave_launch(ctypes.byref(v), int(g), int(m), int(bool(cap1)),
                                             int(bool(ss_live)), int(block), _ptr(j),
                                             _ptr(stats), _ptr(fs), _ptr(iscr), _stream()),
           "schedule_affinity_wave_kernel launch")
    schedule_affinity_wave.launches += 1
    return j, stats[0], stats[1:]


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def feasibility_jit(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                    filters: FilterFlags = DEFAULT_FILTERS, enable_gpu: bool = False,
                    enable_storage: bool = False):
    """The failure-reason diagnostic (JAX `feasibility_jit`): the plain
    version for CPU tensors, K1 for CUDA tensors."""
    flags = dict(enable_gpu=enable_gpu, enable_storage=enable_storage)
    if _on_cpu(tb.alloc):
        return feasibility(tb, cry, g, forced, valid, filters, **flags)
    return feasibility_kernel(tb, cry, g, forced, valid, filters, **flags)


def explain_kernel(tb: Tables, cry: Carry, g: int, forced: int, valid: bool, n_zones: int,
                   enable_gpu: bool = False, enable_storage: bool = False,
                   w: ScoreWeights = DEFAULT_WEIGHTS,
                   filters: FilterFlags = DEFAULT_FILTERS) -> torch.Tensor:
    """Launch K7 (csrc/explain.cu explain_kernel): one block computes the
    stages, components and total of `explain_pod` for group g. Returns the
    [EXPLAIN_ROWS, N] f32 rows on the card (`unpack_explain` gives the
    four-tuple); `cry` is only read."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    v = _view(tb, cry, n_zones, w, filters, enable_gpu, enable_storage)
    # row i of the output holds stage bit perm[i]: EXPLAIN_STAGES mapped by
    # name onto the STAGE_ROWS order of the kernels' stage bits, 4 bits each
    perm = sum(STAGE_ROWS.index(k) << (4 * i) for i, k in enumerate(EXPLAIN_STAGES))
    out = torch.empty((len(EXPLAIN_ROWS), N), dtype=_F32, device=dev)
    scratch = torch.empty(int(lib.explain_scratch_floats(ctypes.byref(v))), dtype=_F32,
                          device=dev)
    _check(lib.explain_launch(ctypes.byref(v), int(g), int(forced), int(bool(valid)),
                              ctypes.c_longlong(perm), _ptr(out), _ptr(scratch), _stream()),
           "explain_kernel launch")
    explain_jit.launches += 1
    return out


def explain_jit(tb: Tables, cry: Carry, g: int, forced: int, valid: bool, n_zones: int,
                enable_gpu: bool = False, enable_storage: bool = False,
                w: ScoreWeights = DEFAULT_WEIGHTS,
                filters: FilterFlags = DEFAULT_FILTERS) -> torch.Tensor:
    """The xray diagnostic (JAX `explain_jit`) as packed [EXPLAIN_ROWS, N]
    f32 rows, the JAX engine's packed fetch: `explain_pod` packed for CPU
    tensors, K7 for CUDA tensors. `unpack_explain` gives JAX's four-tuple."""
    args = (tb, cry, g, forced, valid, n_zones, enable_gpu, enable_storage, w, filters)
    if _on_cpu(tb.alloc):
        return pack_explain(*explain_pod(*args))
    return explain_kernel(*args)


def schedule_batch(tb: Tables, cry: Carry, pod_group, forced_node, valid, n_zones: int,
                   w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                   enable_gpu: bool = False, enable_storage: bool = False):
    """Scan the whole batch; returns (final carry, choices [P] i32, -1 =
    unschedulable): the plain version for CPU tensors, K2 for CUDA tensors."""
    run = schedule_batch_plain if _on_cpu(tb.alloc) else schedule_batch_kernel
    return run(tb, cry, pod_group, forced_node, valid, n_zones, w, filters, enable_gpu,
               enable_storage)


def aggregate_commit(tb: Tables, cry: Carry, g: int, j: torch.Tensor,
                     gpu_live: bool = False) -> Carry:
    """Commit j[n] copies of group g on every node n at once (JAX
    `_aggregate_commit`): the plain version for CPU tensors, K3c for CUDA
    tensors. Returns a new Carry."""
    if _on_cpu(tb.alloc):
        return aggregate_commit_plain(tb, cry, g, j, gpu_live)
    return aggregate_commit_kernel(tb, cry, g, j, gpu_live)


def schedule_wave(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                  w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS,
                  block: int = WAVE_BLOCK, kmax: int = 0, gpu_live: bool = False):
    """Place up to m pods of wave-eligible group g, exactly as m serial steps
    would (JAX `schedule_wave`): the plain version for CPU tensors, K3 for
    CUDA tensors, then `aggregate_commit`. Returns (new carry, per-node
    counts [N] i32, placed). The loop's statistics (WAVE_STATS) are added
    to `schedule_wave.stats`, an i32 tensor on the wrapper's device (adding
    it up does not wait for the card)."""
    if _on_cpu(tb.alloc):
        j, placed, st = schedule_wave_plain(tb, cry, g, m, cap1, w, filters, block, kmax,
                                            gpu_live)
        stats = torch.tensor([st[k] for k in WAVE_STATS], dtype=torch.int32)
    else:
        j, placed, stats = schedule_wave_kernel(tb, cry, g, m, cap1, w, filters, block, kmax,
                                                gpu_live)
    prev = schedule_wave.stats
    schedule_wave.stats = stats if prev is None or prev.device != stats.device else prev + stats
    return aggregate_commit(tb, cry, g, j, gpu_live), j, placed


def schedule_group_serial(tb: Tables, cry: Carry, g: int, valid, cap1: bool,
                          w: ScoreWeights = DEFAULT_WEIGHTS,
                          filters: FilterFlags = DEFAULT_FILTERS,
                          ss_live: bool = False, sa_live: bool = False, n_zones: int = 2):
    """The serial scan of one group with live spread state (JAX
    `schedule_group_serial`): the plain version for CPU tensors, K4 for CUDA
    tensors, then `aggregate_commit`. Returns (new carry, per-node counts [N]
    i32, placed)."""
    if _on_cpu(tb.alloc):
        j, placed = schedule_group_serial_plain(tb, cry, g, valid, cap1, w, filters,
                                                ss_live, sa_live, n_zones)
    else:
        j, placed = schedule_group_serial_kernel(tb, cry, g, valid, cap1, w, filters,
                                                 ss_live, sa_live, n_zones)
    return aggregate_commit(tb, cry, g, j), j, placed


def schedule_affinity_wave(tb: Tables, cry: Carry, g: int, m: int, cap1: bool,
                           ss_live: bool = False, w: ScoreWeights = DEFAULT_WEIGHTS,
                           filters: FilterFlags = DEFAULT_FILTERS, block: int = WAVE_BLOCK,
                           n_zones: int = 2):
    """Place up to m pods of affinity-route group g, exactly as m serial
    steps would (JAX `schedule_affinity_wave`): the plain version for CPU
    tensors, K5 for CUDA tensors, then `aggregate_commit`. Returns (new carry,
    per-node counts [N] i32, placed). The epoch statistics (AFFINITY_STATS)
    are added to `schedule_affinity_wave.stats`, an i32 tensor on the
    wrapper's device (adding them up does not wait for the card), and this
    call's alone are `schedule_affinity_wave.last_stats`."""
    if _on_cpu(tb.alloc):
        j, placed, st = schedule_affinity_wave_plain(tb, cry, g, m, cap1, ss_live, w, filters,
                                                     block, n_zones)
        stats = torch.tensor([st[k] for k in AFFINITY_STATS], dtype=torch.int32)
    else:
        j, placed, stats = schedule_affinity_wave_kernel(tb, cry, g, m, cap1, ss_live, w,
                                                         filters, block, n_zones)
    prev = schedule_affinity_wave.stats
    schedule_affinity_wave.stats = (stats if prev is None or prev.device != stats.device
                                    else prev + stats)
    schedule_affinity_wave.last_stats = stats
    return aggregate_commit(tb, cry, g, j), j, placed


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
# them, and the lane kernels run one block per lane (csrc/*.cu
# `*_lanes_kernel`), reading per-lane inputs at a lane stride (0 for one
# value shared by every lane).


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
               filters: FilterFlags, enable_gpu: bool = False, enable_storage: bool = False):
    """(S, [S, N] mask, TablesView of lane 0) for a lane kernel."""
    active = _lanes_of(active_s, tb.alloc.shape[0], tb.alloc.device)
    S = active.shape[0]
    _check_lanes(cry_s, S)
    v = _view(tb, carry_lane(cry_s, 0, copy=False), n_zones, w, filters, enable_gpu,
              enable_storage, active=active)
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
    block s on lane s. `pod_group`, `forced_node` and `valid` are [P] (one
    stream for every lane) or [S, P] (a row per lane). Returns (carry_s,
    choices [S, P] i32): the carry is a CLONE of `cry_s` that the kernel
    updates in place. The launch counts on `fanout` (the fan-out wrapper
    that asked for it; probe_serial_fanout by default)."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    out = Carry(*(t.clone() for t in cry_s))
    S, active, v = _lane_view(tb, out, active_s, n_zones, w, filters, enable_gpu,
                              enable_storage)
    P = int(torch.as_tensor(pod_group).shape[-1])
    pg, pod_lane = _lane_rows(pod_group, torch.int32, S, P, dev, "pod_group")
    fn, fn_lane = _lane_rows(forced_node, torch.int32, S, P, dev, "forced_node")
    vd, valid_lane = _lane_rows(valid, torch.bool, S, P, dev, "valid")
    if fn_lane != pod_lane:
        raise ValueError("pod_group and forced_node must both be shared or both per lane")
    choices = torch.empty((S, P), dtype=torch.int32, device=dev)
    scratch = torch.empty(S * int(lib.schedule_scratch_floats(ctypes.byref(v))),
                          dtype=torch.float32, device=dev)
    _check(lib.schedule_batch_lanes_launch(ctypes.byref(v), _ptr(pg), _ptr(fn), _ptr(vd), int(P),
                                           pod_lane, valid_lane, int(S), _ptr(choices),
                                           _ptr(scratch), _stream()),
           "schedule_batch_lanes_kernel launch")
    (fanout or probe_serial_fanout).launches += 1
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
    """Launch K3 over S lanes (csrc/wave.cu schedule_wave_lanes_kernel).
    `g`, `m` and `cap1` are each a scalar (every lane; a launch argument) or
    an [S] tensor (one per lane); `block` and `kmax` are shared. Returns
    (counts [S, N] i32, placed [S] i32, stats [S, 3] i32), all on the card;
    `cry_s` is only read. The launch counts on `fanout` (probe_wave_fanout by
    default)."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    K = kmax if kmax else N * block
    if N * block >= 2 ** 31 or not 1 <= K <= N * block:
        raise ValueError(f"wave table {N}x{block} with kmax {K} is out of the kernel's range")
    S, active, v = _lane_view(tb, cry_s, active_s, 2, w, filters, enable_gpu=gpu_live)
    g0, g_t = _lane_values(g, torch.int32, S, dev, "g")
    m0, m_t = _lane_values(m, torch.int32, S, dev, "m")
    c0, c_t = _lane_values(cap1, torch.bool, S, dev, "cap1")
    j = torch.empty((S, N), dtype=torch.int32, device=dev)
    stats = torch.empty((S, 4), dtype=torch.int32, device=dev)
    fs = torch.empty(S * int(lib.wave_scratch_floats(N, block)), dtype=_F32, device=dev)
    iscr = torch.empty(S * int(lib.wave_scratch_ints(N)), dtype=torch.int32, device=dev)
    _check(lib.schedule_wave_lanes_launch(ctypes.byref(v), g0, m0, int(bool(c0)),
                                          _ptr_or_null(g_t), _ptr_or_null(m_t), _ptr_or_null(c_t),
                                          int(block), int(K), int(S), _ptr(j), _ptr(stats),
                                          _ptr(fs), _ptr(iscr), _stream()),
           "schedule_wave_lanes_kernel launch")
    (fanout or probe_wave_fanout).launches += 1
    return j, stats[:, 0], stats[:, 1:]


def aggregate_commit_lanes_kernel(tb: Tables, cry_s: Carry, g, j_s: torch.Tensor,
                                  gpu_live: bool = False, fanout=None) -> Carry:
    """Launch K3c over S lanes (csrc/wave.cu aggregate_commit_lanes_kernel,
    the lane on the grid's second dimension) on a CLONE of `cry_s`, which it
    updates in place and returns. `g` is a scalar (every lane; a launch
    argument) or an [S] tensor (one group per lane). The launch counts on
    `fanout` (aggregate_commit_lanes, the probe fan-outs' commit, by
    default)."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    out = Carry(*(t.clone() for t in cry_s))
    N = tb.alloc.shape[0]
    jj = torch.as_tensor(j_s, dtype=torch.int32, device=dev).contiguous()
    S = jj.shape[0]
    if jj.shape != (S, N):
        raise ValueError(f"j_s: need shape (S, {N}), got {tuple(jj.shape)}")
    _check_lanes(out, S)
    v = _view(tb, carry_lane(out, 0, copy=False), 2, DEFAULT_WEIGHTS, DEFAULT_FILTERS,
              enable_gpu=gpu_live)
    for name in ("topo_dom", "counter_topo", "carr_topo"):
        t = getattr(tb, name)
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous int32 tensor on {dev}")
    U = tb.topo_dom.shape[0]
    g0, g_t = _lane_values(g, torch.int32, S, dev, "g")
    seg = torch.empty(S * U * cry_s.counter.shape[2], dtype=_F32, device=dev)
    _check(lib.aggregate_commit_lanes_launch(ctypes.byref(v), g0, _ptr_or_null(g_t), _ptr(jj),
                                             _ptr(tb.topo_dom), _ptr(tb.counter_topo),
                                             _ptr(tb.carr_topo), int(U), int(bool(gpu_live)),
                                             int(S), _ptr(seg), _stream()),
           "aggregate_commit_lanes_kernel launch")
    (fanout or aggregate_commit_lanes).launches += 1
    return out


def schedule_group_serial_lanes_kernel(tb: Tables, cry_s: Carry, active_s, g: int, valid,
                                       cap1: bool, w: ScoreWeights = DEFAULT_WEIGHTS,
                                       filters: FilterFlags = DEFAULT_FILTERS,
                                       ss_live: bool = False, sa_live: bool = False,
                                       n_zones: int = 2):
    """Launch K4 over S lanes (csrc/group_serial.cu
    schedule_group_serial_lanes_kernel). Returns (counts [S, N] i32, placed
    [S] i32), on the card; `cry_s` is only read."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    vd = torch.as_tensor(valid, dtype=torch.bool, device=dev).contiguous()
    S, active, v = _lane_view(tb, cry_s, active_s, n_zones, w, filters)
    j = torch.empty((S, N), dtype=torch.int32, device=dev)
    placed = torch.empty(S, dtype=torch.int32, device=dev)
    fs = torch.empty(S * int(lib.group_serial_scratch_floats(ctypes.byref(v))), dtype=_F32,
                     device=dev)
    iscr = torch.empty(S * int(lib.group_serial_scratch_ints(ctypes.byref(v))),
                       dtype=torch.int32, device=dev)
    _check(lib.schedule_group_serial_lanes_launch(ctypes.byref(v), int(g), _ptr(vd),
                                                  int(vd.shape[0]), int(bool(cap1)),
                                                  int(bool(ss_live)), int(bool(sa_live)), int(S),
                                                  _ptr(j), _ptr(placed), _ptr(fs), _ptr(iscr),
                                                  _stream()),
           "schedule_group_serial_lanes_kernel launch")
    probe_group_serial_fanout.launches += 1
    return j, placed


def schedule_affinity_wave_lanes_kernel(tb: Tables, cry_s: Carry, active_s, g: int, m: int,
                                        cap1: bool, ss_live: bool = False,
                                        w: ScoreWeights = DEFAULT_WEIGHTS,
                                        filters: FilterFlags = DEFAULT_FILTERS,
                                        block: int = WAVE_BLOCK, n_zones: int = 2):
    """Launch K5 over S lanes (csrc/affinity_wave.cu
    schedule_affinity_wave_lanes_kernel). Returns (counts [S, N] i32, placed
    [S] i32, stats [S, 3] i32), all on the card; `cry_s` is only read."""
    from . import build

    lib = build.library()
    dev = tb.alloc.device
    N = tb.alloc.shape[0]
    if N * block >= 2 ** 31 or block < 1:
        raise ValueError(f"affinity table {N}x{block} is out of the kernel's range")
    if cry_s.counter.shape[2] > AFFINITY_MAX_D1:
        raise ValueError(f"{cry_s.counter.shape[2]} domains exceed the kernel's "
                         f"{AFFINITY_MAX_D1}")
    S, active, v = _lane_view(tb, cry_s, active_s, n_zones, w, filters)
    j = torch.empty((S, N), dtype=torch.int32, device=dev)
    stats = torch.empty((S, 4), dtype=torch.int32, device=dev)
    fs = torch.empty(S * int(lib.affinity_scratch_floats(ctypes.byref(v), int(block))),
                     dtype=_F32, device=dev)
    iscr = torch.empty(S * int(lib.affinity_scratch_ints(ctypes.byref(v))), dtype=torch.int32,
                       device=dev)
    _check(lib.schedule_affinity_wave_lanes_launch(ctypes.byref(v), int(g), int(m),
                                                   int(bool(cap1)), int(bool(ss_live)),
                                                   int(block), int(S), _ptr(j), _ptr(stats),
                                                   _ptr(fs), _ptr(iscr), _stream()),
           "schedule_affinity_wave_lanes_kernel launch")
    probe_affinity_wave_fanout.launches += 1
    return j, stats[:, 0], stats[:, 1:]


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
    `sweep_whatif_fanout`): the plain version for CPU tensors, K2 over lanes
    for CUDA tensors. Returns (carry_s, choices [S, P] i32, -1 =
    unschedulable)."""
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
             "extend_tables": extend_tables_on_device, "explain_jit": explain_jit}
for _f in _WRAPPERS.values():
    _f.launches = 0
schedule_batch.last_events = None
schedule_wave.stats = None
schedule_affinity_wave.stats = None
schedule_affinity_wave.last_stats = None
# launches of the kernels with their GPU-share / Open-Local branches on (a
# part of the wrappers' own counts)
BRANCH_LAUNCHES = dict.fromkeys(("feasibility/gpu_storage", "schedule_batch/gpu_storage",
                                 "schedule_wave/gpu_live", "aggregate_commit/gpu_live"), 0)


def reset_launch_counts() -> None:
    for f in _WRAPPERS.values():
        f.launches = 0
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

