"""A CPU model of the cross-CTA steps of K1 on a thread-block cluster
(open_simulator_torch/ops/csrc/feasibility.cu, the failure-reason
diagnostic, one cluster over the N nodes), held against the plain
`feasibility` and the JAX package's `feasibility_jit`.

K1 runs on one cluster of C CTAs, CTA r owning the node slice
[r * chunk, (r + 1) * chunk) and the share [r * dc, (r + 1) * dc) of the
D+1 domain columns (dc = ceil((D+1) / C)). Where it crosses the CTAs it
must give what the one-thread-a-node form gave:
- the prologue: each CTA takes, for every valid DoNotSchedule term, the
  minimum of the counter row over the eligible domains of its share as the
  maximum of its negation (an order-preserving integer key, okey: a share
  without an eligible domain pushes -inf), and for required self-affinity
  whether any valid counter row is nonzero in its share (the sentinel column
  excluded); one round merges them by max, so every CTA holds the pod's
  minima (0 for an empty eligible set and for a term with id < 0) and the
  bootstrap flag;
- the EXT roles: a node's base filters, its GPU-share check and its
  Open-Local check on three threads, combined through shared memory (the
  two checks' stage bits, the feasible bit the base's AND both, then valid
  and forced once);
- the packed output: ONE [1 + 12 + R, N] uint8 buffer, the feasible row,
  the STAGE_ROWS rows and fit_each transposed, each CTA staging a pass's
  [pass, R] fit bytes in shared memory and writing them out row by row.
The functions below are that arithmetic in plain PyTorch, step for step,
at every cluster size `choose` gives (1, 2, 4, 8, 16), on a spread cluster
(zone and hostname DoNotSchedule terms: D+1 = N + 1), an affinity cluster
(required self-affinity, hostname spreads), an extended cluster (GPU-share
and Open-Local, EXT) and the hard-predicate cluster, against a mid-run
carry, a full one, one whose DoNotSchedule rows rise column by column, one
with every required-affinity row empty (bootstrap) and one whose only
nonzero required-affinity count lies in the last real domain, with and
without an empty eligible set, forced and not.

The model carries four named mutations, each a fault the design must not
have; `test_named_mutation_is_caught` shows that each one makes a check of
this file fail:
- "cta_min": a CTA's own minimum taken as the pod's;
- "empty_as_zero": an empty share's +inf read as 0;
- "base_only": the feasible bit taken from the base role alone;
- "untransposed": the fit_each rows written untransposed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import open_simulator_tpu.core.types as jax_types
from open_simulator_torch.ops import kernels as tk
from open_simulator_torch.utils.synth import (synth_affinity_cluster, synth_cluster,
                                              synth_extended_cluster, synth_spread_cluster)
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.simulator.engine import Simulator as JaxSimulator
from test_torch_cluster_scan import okey_t, ounkey_t

SIZES = (1, 2, 4, 8, 16)  # ops/cluster.py SIZES
PASS, PASS_EXT = 512, 160  # csrc/feasibility.cu K1_PASS, K1_PASS_EXT
MUTATIONS = ("cta_min", "empty_as_zero", "base_only", "untransposed")
INF = float("inf")


def node_slices(N: int, C: int) -> list:
    """cluster.cuh cluster_setup's cut of the N nodes."""
    w = -(-N // C)
    return [(min(N, r * w), min(N, r * w + w)) for r in range(C)]


def col_shares(D1: int, C: int) -> list:
    """k1_prologue's cut of the D+1 domain columns."""
    w = -(-D1 // C)
    return [(min(D1, r * w), min(D1, r * w + w)) for r in range(C)]


# ------------------------------------------------------------- the model ----

def k1_prologue(tb, cry, g: int, include_dns: bool, C: int, mutation=None) -> dict:
    """Step A: each CTA's keys over its column share, merged by max in one
    round. Returns the pod's minima and bootstrap flag, and each CTA's own
    minima (for "cta_min")."""
    D1 = cry.counter.shape[1]
    D, Sd = D1 - 1, tb.dns_t.shape[1]
    dns = tk.DEFAULT_FILTERS.spread and include_dns
    aff_ids = [int(i) for i in tb.req_aff_t[g] if int(i) >= 0]
    has_aff = tk.DEFAULT_FILTERS.interpod and bool(tb.grp_aff_self[g]) and bool(aff_ids)
    shares = col_shares(D1, C)
    keys = okey_t(torch.full((C, Sd), -INF))
    nz = torch.zeros(C, dtype=torch.int64)
    if dns:
        for s in range(Sd):
            i = int(tb.dns_t[g, s])
            if i < 0:
                continue
            for r, (d0, d1) in enumerate(shares):
                e = tb.dns_edom[g, s, d0:d1]
                mn = cry.counter[i, d0:d1][e].min() if bool(e.any()) else torch.tensor(INF)
                if mutation == "empty_as_zero" and not bool(e.any()):
                    mn = torch.tensor(0.0)
                keys[r, s] = okey_t((-mn).reshape(1))[0]
    if has_aff:
        for r, (d0, d1) in enumerate(shares):
            nz[r] = int(any(bool((cry.counter[i, d0:min(d1, D)] != 0).any()) for i in aff_ids))

    def minima(k):
        m = -ounkey_t(k)
        return torch.where((tb.dns_t[g] >= 0) & torch.isfinite(m), m, 0.0)

    return dict(dns=dns, dns_min=minima(keys.amax(dim=0)),
                boot=has_aff and not bool(nz.amax()),
                cta_min=[minima(keys[r]) for r in range(C)])


def node_step(tb, cry, g: int, pc: dict, dns_min, lo: int, hi: int) -> tuple:
    """The slice's DoNotSchedule and required-affinity stages from the
    prologue's values (node_feasibility's, node-local)."""
    D = cry.counter.shape[1] - 1
    n = hi - lo
    spread = torch.ones(n, dtype=torch.bool)
    if pc["dns"]:
        for s in range(tb.dns_t.shape[1]):
            i = int(tb.dns_t[g, s])
            if i < 0:
                continue
            dom = tb.counter_dom[i, lo:hi].long()
            skew = cry.counter[i, dom] + tb.dns_self[g, s] - dns_min[s]
            spread &= (dom < D) & (skew <= tb.dns_maxskew[g, s])
    aff_all = torch.ones(n, dtype=torch.bool)
    for i in (int(x) for x in tb.req_aff_t[g] if int(x) >= 0):
        dom = tb.counter_dom[i, lo:hi].long()
        aff_all &= (dom < D) & (cry.counter[i, dom] > 0)
    if not tk.DEFAULT_FILTERS.interpod:
        aff_all = torch.ones(n, dtype=torch.bool)
    return spread, torch.ones(n, dtype=torch.bool) if pc["boot"] else aff_all


def k1(tb, cry, g: int, forced: int, flags: dict, C: int, include_dns: bool = True,
       mutation=None) -> torch.Tensor:
    """K1 at C: the packed [13 + R, N] uint8 rows."""
    N, R = tb.alloc.shape
    ext = flags["enable_gpu"] or flags["enable_storage"]
    pc = k1_prologue(tb, cry, g, include_dns, C, mutation)
    # the base role: node_feasibility without EXT, forced -1 and valid
    _, base = tk.feasibility(tb, cry, g, -1, True, include_dns=include_dns)
    stages = {k: v.clone() for k, v in base.items()}
    for r, (lo, hi) in enumerate(node_slices(N, C)):
        dns_min = pc["cta_min"][r] if mutation == "cta_min" else pc["dns_min"]
        stages["spread"][lo:hi], stages["pod_affinity"][lo:hi] = node_step(
            tb, cry, g, pc, dns_min, lo, hi)
    feas = (stages["static"] & stages["fit"] & stages["ports"] & stages["pod_affinity"]
            & stages["pod_anti"] & stages["spread"])
    if ext:  # the GPU-share and Open-Local roles, combined after a CTA barrier
        stages["gpu"] = tk.feasibility(tb, cry, g, -1, True, enable_gpu=flags["enable_gpu"])[1][
            "gpu"].clone()
        stages["storage"] = tk.feasibility(tb, cry, g, -1, True,
                                           enable_storage=flags["enable_storage"])[1][
            "storage"].clone()
        if mutation != "base_only":
            feas = feas & stages["gpu"] & stages["storage"]
    if forced >= 0:
        feas = feas & (torch.arange(N) == forced)
    # the packed rows, a pass of staged nodes at a time
    out = torch.full((tk.FEASIBILITY_ROWS + R, N), 7, dtype=torch.uint8)  # as torch.empty
    P = PASS_EXT if ext else PASS
    for lo, hi in node_slices(N, C):
        for n0 in range(lo, hi, P):
            sl = slice(n0, min(hi, n0 + P))
            np_ = sl.stop - sl.start
            staged = stages["fit_each"][sl].to(torch.uint8)  # [pass, R], node by node
            out[0, sl] = feas[sl].to(torch.uint8)
            for i, k in enumerate(tk.STAGE_ROWS):
                out[1 + i, sl] = stages[k][sl].to(torch.uint8)
            out[tk.FEASIBILITY_ROWS:, sl] = (staged.reshape(R, np_) if mutation == "untransposed"
                                            else staged.T)
    return out


# ------------------------------------------------------------ the inputs ----

def _spread():
    nodes, pods, services = synth_spread_cluster(64, 320)
    return nodes, pods, services, []


def _affinity():
    nodes, pods, services = synth_affinity_cluster(64, 400)
    return nodes, pods, services, []


def _extended():
    nodes, pods, _, scs = synth_extended_cluster(48, 400)
    return nodes, pods, [], scs


def _hard():
    nodes, pods = synth_cluster(64, 640, hard_predicates=True)
    return nodes, pods, [], []


SOURCES = {"spread": _spread, "affinity": _affinity, "extended": _extended, "hard": _hard}
_BATCHES: dict = {}
_WANT: dict = {}  # (batch, case, group, forced, include_dns) -> (plain rows, JAX rows)


def _carries(tt, tc) -> dict:
    """The carries of a batch: mid-run, full, DoNotSchedule rows rising
    column by column (a minimum of 1 over the eligible domains), every
    required-affinity row empty, and its only nonzero count in the last
    real domain."""
    D1 = tc.counter.shape[1]
    dns_ids = torch.unique(tt.dns_t[tt.dns_t >= 0]).long()
    aff_ids = torch.unique(tt.req_aff_t[tt.req_aff_t >= 0]).long()
    ramp = tc.counter.clone()
    ramp[dns_ids] = torch.arange(1, D1 + 1, dtype=torch.float32)[None, :]
    empty = tc.counter.clone()
    empty[aff_ids] = 0.0
    last = empty.clone()
    last[aff_ids, D1 - 2] = 1.0
    return {"mid": tc, "full": tc._replace(requested=tt.alloc.clone()),
            "ramp": tc._replace(counter=ramp), "aff_empty": tc._replace(counter=empty),
            "aff_last": tc._replace(counter=last)}


def batch(name: str):
    """(port tables {kind: Tables}, JAX tables {kind: ...}, carries, groups,
    flags): the tables as encoded and with every eligible set empty."""
    if name not in _BATCHES:
        nodes, pods, services, scs = SOURCES[name]()
        sim = JaxSimulator(nodes, use_mesh=False)
        sim.register_cluster_objects(jax_types.ResourceTypes(services=list(services),
                                                             storage_classes=list(scs)))
        bt = sim.encode_batch(pods)
        jt, jc = sim._to_device(bt)
        P = len(pods)
        ext = name == "extended"
        flags = dict(enable_gpu=ext, enable_storage=ext)
        valid = np.arange(bt.pod_group.shape[0]) < P // 2
        mid, _ = jk.schedule_batch(jt, jc, bt.pod_group, bt.forced_node, valid,
                                   n_zones=bt.n_zones, **flags)
        tt = tk.tables_from_batch(bt, "cpu")
        tc = tk.carry_from_numpy({f: np.asarray(v) for f, v in mid._asdict().items()}, "cpu")
        tables = {"encoded": tt, "no_eligible": tt._replace(dns_edom=torch.zeros_like(tt.dns_edom))}
        jtables = {"encoded": jt,
                   "no_eligible": jt._replace(dns_edom=jnp.zeros_like(jnp.asarray(jt.dns_edom)))}
        groups = sorted({int(g) for g in bt.pod_group[:P]})
        _BATCHES[name] = (tables, jtables, _carries(tt, tc), groups, flags)
    return _BATCHES[name]


CASES = (("encoded", "mid"), ("encoded", "full"), ("encoded", "ramp"),
         ("encoded", "aff_empty"), ("encoded", "aff_last"), ("no_eligible", "ramp"))


def wanted(name: str, kind: str, ckind: str, g: int, forced: int, include_dns: bool):
    """The plain version's packed rows and the JAX feasibility_jit's, packed
    alike (the JAX ones with include_dns only: the route's diagnostic)."""
    key = (name, kind, ckind, g, forced, include_dns)
    if key not in _WANT:
        tables, jtables, carries, _, flags = batch(name)
        tb, cry = tables[kind], carries[ckind]
        plain = tk.pack_feasibility(*tk.feasibility(tb, cry, g, forced, True,
                                                    include_dns=include_dns, **flags))
        jrows = None
        if include_dns:
            jc = jk.Carry(*(jnp.asarray(t.numpy()) for t in cry))
            jf, js = jk.feasibility_jit(jtables[kind], jc, jnp.int32(g), jnp.int32(forced),
                                        jnp.asarray(True), **flags)
            jrows = np.concatenate([np.asarray(jf)[None], np.stack(
                [np.asarray(js[k]) for k in tk.STAGE_ROWS]), np.asarray(js["fit_each"]).T]
            ).astype(np.uint8)
        _WANT[key] = (plain, jrows)
    return _WANT[key]


def k1_mismatches(name: str, C: int, mutation=None, jax_check: bool = True) -> list:
    tables, _, carries, groups, flags = batch(name)
    N = tables["encoded"].alloc.shape[0]
    bad = []
    for kind, ckind in CASES:
        tb, cry = tables[kind], carries[ckind]
        for g in groups:
            for forced, include_dns in ((-1, True), ((7 * g + 3) % N, True), (-1, False)):
                got = k1(tb, cry, g, forced, flags, C, include_dns, mutation)
                plain, jrows = wanted(name, kind, ckind, g, forced, include_dns)
                where = (name, kind, ckind, C, g, forced, include_dns)
                if not torch.equal(got, plain):
                    bad.append(where + ("plain",))
                if jax_check and jrows is not None and not np.array_equal(got.numpy(), jrows):
                    bad.append(where + ("jax",))
    return bad


# ------------------------------------------------------------- the tests ----

@pytest.mark.parametrize("C", SIZES)
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_feasibility_cluster_steps_equal_plain_and_jax(name, C):
    assert k1_mismatches(name, C) == []


def test_feasibility_cases_cross_the_ctas():
    """The inputs reach what the cross-CTA steps guard: zone and hostname
    DoNotSchedule terms (D+1 = N + 1), column shares without an eligible
    domain beside shares with one, and empty shares, at C 16; minima that
    differ from share to share; the bootstrap flag on, and off where only
    the last real domain holds a count (beyond the first share at C 2);
    nodes the base role passes and a GPU-share or Open-Local check fails;
    fit_each rows that differ between resources."""
    seen = dict(zone=0, hostname=0, share_without=0, empty_share=0, min_differs=0, boot=0,
                last_only=0, ext_cut=0, fit_mixed=0)
    for name in sorted(SOURCES):
        tables, _, carries, groups, flags = batch(name)
        tb = tables["encoded"]
        N = tb.alloc.shape[0]
        D1 = carries["mid"].counter.shape[1]
        for g in groups:
            for s in range(tb.dns_t.shape[1]):
                if int(tb.dns_t[g, s]) < 0:
                    continue
                n_dom = int(tb.dns_edom[g, s].sum())
                seen["hostname" if n_dom > N // 2 else "zone"] += 1
                per = [bool(tb.dns_edom[g, s, d0:d1].any()) for d0, d1 in col_shares(D1, 16)]
                seen["share_without"] += any(per) and not all(per)
                seen["empty_share"] += any(d0 == d1 for d0, d1 in col_shares(D1, 16))
                pc = k1_prologue(tb, carries["ramp"], g, True, 4)
                seen["min_differs"] += len({float(m[s]) for m in pc["cta_min"]}) > 1
            seen["boot"] += k1_prologue(tb, carries["aff_empty"], g, True, 2)["boot"]
            if bool(tb.grp_aff_self[g]) and bool((tb.req_aff_t[g] >= 0).any()):
                pc = k1_prologue(tb, carries["aff_last"], g, True, 2)
                seen["last_only"] += (not pc["boot"]) and D1 - 2 >= col_shares(D1, 2)[1][0]
            if flags["enable_gpu"]:
                _, base = tk.feasibility(tb, carries["mid"], g, -1, True)
                _, full = tk.feasibility(tb, carries["mid"], g, -1, True, **flags)
                seen["ext_cut"] += bool((base["static"] & ~(full["gpu"] & full["storage"])).any())
            fe = tk.feasibility(tb, carries["full"], g, -1, True)[1]["fit_each"]
            seen["fit_mixed"] += bool((fe.any(dim=1) & ~fe.all(dim=1)).any())
    assert all(v > 0 for v in seen.values()), seen


def test_packed_rows_round_trip():
    """The wrappers' host side on the CPU: `feasibility_packed` is the plain
    pair packed, `feasibility_jit` its bool views (fit_each the [N, R]
    transposed view), equal to `feasibility`'s own, and `unpack_feasibility`
    of a fetched buffer slices like the engine's reason path."""
    tables, _, carries, groups, flags = batch("extended")
    tb, cry = tables["encoded"], carries["full"]
    N, R = tb.alloc.shape
    for g in groups[:4]:
        rows = tk.feasibility_packed(tb, cry, g, -1, True, enable_gpu=True, enable_storage=True)
        assert rows.dtype == torch.uint8 and rows.shape == (tk.FEASIBILITY_ROWS + R, N)
        f, st = tk.feasibility_jit(tb, cry, g, -1, True, enable_gpu=True, enable_storage=True)
        pf, ps = tk.feasibility(tb, cry, g, -1, True, **flags)
        assert f.dtype == torch.bool and torch.equal(f, pf)
        assert list(st) == list(tk.STAGE_KEYS)
        for k in tk.STAGE_KEYS:
            assert st[k].dtype == torch.bool and torch.equal(st[k], ps[k]), k
        assert st["fit_each"].shape == (N, R)
        _, views = tk.unpack_feasibility(rows)
        assert views["fit_each"].data_ptr() == rows.data_ptr() + tk.FEASIBILITY_ROWS * N
        assert torch.equal(views["fit_each"], ps["fit_each"])


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_named_mutation_is_caught(mutation):
    found = []
    for C in (2, 4, 16):
        for name in sorted(SOURCES):
            found += k1_mismatches(name, C, mutation, jax_check=False)
            if found:
                break
        if found:
            break
    assert found, f"the mutation {mutation!r} went unnoticed"
