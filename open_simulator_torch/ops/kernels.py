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

Numerical contract (shared with csrc/schedule.cu): every f32 operation is
done separately and in the JAX expression's order (no fused multiply-add);
sums over the small slot axes run left to right from 0; `log` is taken in
f64 and rounded once to f32. Batches with GPU-share or Open-Local demand take
kernel branches this port does not have yet (ROADMAP B9); the engine refuses
them before they reach these functions.
"""

from __future__ import annotations

import ctypes
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
    # GPU-share and Open-Local tables: staged like the rest; the kernels of
    # this route do not read them (ROADMAP B9).
    grp_gpu_mem: torch.Tensor
    grp_gpu_num: torch.Tensor
    grp_gpu_pre: torch.Tensor
    grp_gpu_take: torch.Tensor
    dev_total: torch.Tensor
    grp_lvm_size: torch.Tensor
    grp_lvm_vg: torch.Tensor
    grp_sdev_size: torch.Tensor
    grp_sdev_media: torch.Tensor
    vg_cap: torch.Tensor
    vg_nameid: torch.Tensor
    sdev_cap: torch.Tensor
    sdev_media: torch.Tensor


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


STAGE_KEYS = ("static", "taint", "unsched", "affinity", "extra", "fit", "fit_each",
              "ports", "pod_affinity", "pod_anti", "spread", "gpu", "storage")
# the [N] stage masks in the order the CUDA kernel writes its [12, N] rows
STAGE_ROWS = tuple(k for k in STAGE_KEYS if k != "fit_each")


def feasibility(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                filters: FilterFlags = DEFAULT_FILTERS):
    """[N] feasibility mask for one pod, plus the named per-stage masks
    (STAGE_KEYS) for diagnostics. Plain version of `feasibility_kernel`."""
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

    if filters.interpod:
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
    if filters.spread:
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

    feasible = smask & fit & ~conflict & aff_ok & ~blocked_in & ~blocked_ex & dns_ok
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
        "gpu": ones,
        "storage": ones,
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
                     w: ScoreWeights = DEFAULT_WEIGHTS) -> dict:
    """All normalized, weighted plugin score terms over the feasible set —
    {name: [N] f32} in COMPONENT_ORDER (Open-Local is the constant 0 of a
    batch without storage demand)."""
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

    return {
        "least": w.least * least,
        "balanced": w.balanced * balanced,
        "openlocal": w.openlocal * 0.0,
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


def scores(tb: Tables, cry: Carry, g: int, feasible, n_zones: int,
           w: ScoreWeights = DEFAULT_WEIGHTS) -> torch.Tensor:
    """Weighted sum of all normalized plugin scores over the feasible set."""
    return components_total(score_components(tb, cry, g, feasible, n_zones, w))


def commit(tb: Tables, cry: Carry, g: int, choice, do) -> Carry:
    """Apply one placement to the carry (the Reserve+Bind of the cycle);
    functional: returns a new Carry. `choice`/`do` may be 0-dim tensors, so a
    scan on the card never waits for the host."""
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
    return cry._replace(requested=requested, nonzero=nonzero, port_used=port_used,
                        counter=counter, carrier=carrier)


def step(tb: Tables, cry: Carry, g: int, forced: int, valid: bool, n_zones: int,
         w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS):
    """One scheduleOne cycle: (new carry, choice as a 0-dim i32 tensor, -1 =
    unschedulable)."""
    feasible, _ = feasibility(tb, cry, g, forced, valid, filters)
    any_f = torch.any(feasible)
    sc = scores(tb, cry, g, feasible, n_zones, w)
    masked = torch.where(feasible, sc, float("-inf"))
    choice = torch.argmax(masked).to(torch.int32)  # first max → lowest node index
    choice = torch.where(any_f, choice, torch.tensor(-1, dtype=torch.int32, device=sc.device))
    return commit(tb, cry, g, choice, any_f), choice


@torch.inference_mode()
def schedule_batch_plain(tb: Tables, cry: Carry, pod_group, forced_node, valid,
                         n_zones: int, w: ScoreWeights = DEFAULT_WEIGHTS,
                         filters: FilterFlags = DEFAULT_FILTERS):
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
        cry, ch = step(tb, cry, g, f, v, n_zones, w, filters)
        choices.append(ch)
    if not choices:
        return cry, torch.zeros(0, dtype=torch.int32, device=tb.alloc.device)
    return cry, torch.stack(choices)


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
    # carry
    ("requested", "requested"), ("nonzero", "nonzero"), ("port_used", "port_used"),
    ("counter", "counter"), ("carrier", "carrier"),
)
_DIM_FIELDS = ("N", "R", "G", "T", "Tc", "D1", "PORT1", "PP", "A", "B", "Cp", "Sd",
               "Ss", "Ca", "Cw", "Z", "f_fit", "f_ports", "f_interpod", "f_spread")
N_WEIGHTS = 12  # least balanced openlocal simon nodeaff taint interpod ss pts avoid image extra(unused)
MAX_SLOTS = 64  # per-group slot axes (A, B, Cp, Sd, Ss, Ca, Cw, PP) the kernel's shared memory holds


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
}


def _view(tb: Tables, cry: Carry, n_zones: int, w: ScoreWeights,
          filters: FilterFlags) -> TablesView:
    """Check every tensor (device, dtype, contiguity) and fill the struct."""
    dev = tb.alloc.device
    src = {**tb._asdict(), **cry._asdict()}
    v = TablesView()
    for name, field in _PTR_FIELDS:
        t = src[field]
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
        f_fit=int(filters.fit), f_ports=int(filters.ports),
        f_interpod=int(filters.interpod), f_spread=int(filters.spread))
    for k in ("A", "B", "Cp", "Sd", "Ss", "Ca", "Cw", "PP"):
        if dims[k] > MAX_SLOTS:
            raise ValueError(f"slot axis {k}={dims[k]} exceeds the kernel's {MAX_SLOTS}")
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
                       filters: FilterFlags = DEFAULT_FILTERS):
    """Launch K1 (csrc/schedule.cu feasibility_kernel): one thread per node.
    Returns (feasible [N] bool, stages {STAGE_KEYS: tensor})."""
    from . import build

    lib = build.library()
    N, R = tb.alloc.shape
    dev = tb.alloc.device
    v = _view(tb, cry, 2, DEFAULT_WEIGHTS, filters)
    feasible = torch.empty(N, dtype=torch.bool, device=dev)
    stage_rows = torch.empty((len(STAGE_ROWS), N), dtype=torch.bool, device=dev)
    fit_each = torch.empty((N, R), dtype=torch.bool, device=dev)
    _check(lib.feasibility_launch(ctypes.byref(v), int(g), int(forced), int(bool(valid)),
                                  ctypes.c_void_p(feasible.data_ptr()),
                                  ctypes.c_void_p(stage_rows.data_ptr()),
                                  ctypes.c_void_p(fit_each.data_ptr()), _stream()),
           "feasibility_kernel launch")
    feasibility_jit.launches += 1
    stages = {k: stage_rows[i] for i, k in enumerate(STAGE_ROWS)}
    stages["fit_each"] = fit_each
    return feasible, {k: stages[k] for k in STAGE_KEYS}


def schedule_batch_kernel(tb: Tables, cry: Carry, pod_group, forced_node, valid,
                          n_zones: int, w: ScoreWeights = DEFAULT_WEIGHTS,
                          filters: FilterFlags = DEFAULT_FILTERS):
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
    v = _view(tb, out, n_zones, w, filters)
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
    # the launch's CUDA events: elapsed_time() once the caller has synchronized
    schedule_batch.last_events = (start, end)
    return out, choices


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def feasibility_jit(tb: Tables, cry: Carry, g: int, forced: int, valid: bool,
                    filters: FilterFlags = DEFAULT_FILTERS):
    """The failure-reason diagnostic (JAX `feasibility_jit`): the plain
    version for CPU tensors, K1 for CUDA tensors."""
    if _on_cpu(tb.alloc):
        return feasibility(tb, cry, g, forced, valid, filters)
    return feasibility_kernel(tb, cry, g, forced, valid, filters)


def schedule_batch(tb: Tables, cry: Carry, pod_group, forced_node, valid, n_zones: int,
                   w: ScoreWeights = DEFAULT_WEIGHTS, filters: FilterFlags = DEFAULT_FILTERS):
    """Scan the whole batch; returns (final carry, choices [P] i32, -1 =
    unschedulable): the plain version for CPU tensors, K2 for CUDA tensors."""
    if _on_cpu(tb.alloc):
        return schedule_batch_plain(tb, cry, pod_group, forced_node, valid, n_zones, w, filters)
    return schedule_batch_kernel(tb, cry, pod_group, forced_node, valid, n_zones, w, filters)


feasibility_jit.launches = 0
schedule_batch.launches = 0
schedule_batch.last_events = None


def reset_launch_counts() -> None:
    feasibility_jit.launches = 0
    schedule_batch.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"feasibility": feasibility_jit.launches, "schedule_batch": schedule_batch.launches}

