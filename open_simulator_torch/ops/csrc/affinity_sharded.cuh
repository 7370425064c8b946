// The scratch layout and the stacked vector of the affinity wave's sharded
// paths, shared by K9 (affinity_sharded.cu: the epoch path) and K11
// (affinity_rounds.cu: the sharded tail above the epoch limit, whose
// cluster stages run K9's per-node setup and front on the same scratch:
// aff_budget_node, aff_front_node).

#pragma once

#include "affinity.cuh"
#include "common.cuh"

// the stacked vector: [0, 5) maxima over F_start of simon, nodeaff, taint,
// ip, pernode; [5, 7) of -simon, -ip; [7, 12), [12, 14) the same over F_hi;
// [14, 18) maxima over F_hi of -simon, -nodeaff, -taint, -ip; then Cw
// maxima of the weighted carriers' domains over F_hi and Cw of their
// negations
#define AS_FIXED 18

// The kernels read the tables through a view of the rank's block (its N is
// the block's NL) whose node-axis pointers ops/kernels.py rebases by the
// block's first node `lo` (wave_sharded.cuh); the scratch is indexed by
// global node over all N nodes of the mesh (the argument N).
//
// Float scratch (K5's layout): table [N, B+1]; ip_pref, simon_s, static,
// ip_raw, pernode0 [N] each; the live rows [slots, D1]; cnt_live, taken
// [D1] each; bound [N]; zone sums [Z]; then the gathered nodeaff, taint
// [N] each. Int scratch: feas, cap, dom_live, u, flags, counts, avail (the
// epoch's gathered, clamped) [N] each; edom_live, first_pos, consumed,
// everb [D1] each; then the gathered zone [N] and every slot's domain
// [slots, N] (the fold's). State: placed, last, epochs, head fallbacks,
// multi rounds, the epoch's bootstrap flag.
static __device__ __forceinline__ AffScratch aff_scratch(const TablesView& t, const Ctx& c, int B,
                                                         float* fs, int* is, int N) {
  const int D1 = t.D1, n_rows = c.off[SK_SS] + 1;
  AffScratch a;
  a.table = fs;
  a.ip_pref = a.table + (size_t)N * (B + 1);
  a.simon_s = a.ip_pref + N;
  a.stat = a.simon_s + N;
  a.ip_raw = a.stat + N;
  a.pn0 = a.ip_raw + N;
  a.rows = a.pn0 + N;
  a.cl = a.rows + (size_t)n_rows * D1;
  a.taken = a.cl + D1;
  a.bound = a.taken + D1;
  a.zone_sums = a.bound + N;
  a.feas = is;
  a.cap = a.feas + N;
  a.dom_live = a.cap + N;
  a.u = a.dom_live + N;
  a.flags = a.u + N;
  a.counts = a.flags + N;
  a.avail = a.counts + N;
  a.edom_live = a.avail + N;
  a.first_pos = a.edom_live + D1;
  a.consumed = a.first_pos + D1;
  a.everb = a.consumed + D1;
  return a;
}

// The rows the sharded paths gather for the tail (see aff_scratch)
struct AffGathered {
  float *nodeaff, *taint;
  int *zone, *fdom;
};

static __device__ __forceinline__ AffGathered aff_gathered(const TablesView& t, const AffScratch& a,
                                                           int N) {
  AffGathered x;
  x.nodeaff = a.zone_sums + t.Z;
  x.taint = x.nodeaff + N;
  x.zone = a.everb + t.D1;
  x.fdom = x.zone + N;
  return x;
}

// Node n's setup after its segment constants (K5's, on K9's and K11's
// scratch): the node's composed budget domain and whether it has every live
// DoNotSchedule term's key (AF_KEY) and every live budget term's domain is
// that one (AF_SAME). The segment constants stay at the call sites: passing
// the __shared__ PodCtx through here moved K9's registers (46 -> 52).
static __device__ __forceinline__ void aff_budget_node(const TablesView& t, const Ctx& c, int n,
                                                       const AffScratch& a) {
  const int D = t.D1 - 1;
  int sum = 0, key = 1;
  for (int k = SK_DNS; k <= SK_CAR; ++k) {
    if (k == SK_AFF) continue;
    for (int s = 0; s < c.n[k]; ++s) {
      if (!c.slot[k][s].live) continue;
      const int dom = slot_dom(t, k, c.slot[k][s].id, n);
      sum += dom;
      if (k == SK_DNS && dom >= D) key = 0;
    }
  }
  const int dl = sum / max(c.n_budget, 1);
  bool same = true;
  for (int k = SK_DNS; k <= SK_CAR; ++k) {
    if (k == SK_AFF) continue;
    for (int s = 0; s < c.n[k]; ++s)
      if (c.slot[k][s].live && slot_dom(t, k, c.slot[k][s].id, n) != dl) same = false;
  }
  a.dom_live[n] = dl;
  a.flags[n] = (key ? AF_KEY : 0) | (same ? AF_SAME : 0);
}

// An epoch front's prologue, block-wide (K5's, from the replicated live
// rows): the DoNotSchedule minimum of every valid term into c.dns_min, and
// the bootstrap flag, returned. The caller passes a barrier before reading
// c.dns_min.
static __device__ __forceinline__ int aff_front_prologue(const TablesView& t, Ctx& c, int g,
                                                         const float* rows, float* s_red) {
  const int D1 = t.D1, D = D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  for (int s = 0; s < c.n[SK_DNS]; ++s) {
    if (!c.slot[SK_DNS][s].valid) continue;
    const float* row = rows + (size_t)(c.off[SK_DNS] + s) * D1;
    const uint8_t* edom = t.dns_edom + ((size_t)g * t.Sd + s) * D1;
    float mn = INFINITY;
    for (int d = tid; d < D1; d += bd)
      if (edom[d]) mn = fminf(mn, row[d]);
    mn = block_min(mn, s_red);
    if (tid == 0) c.dns_min[s] = isfinite(mn) ? mn : 0.0f;
  }
  int boot = 0;
  if (c.has_aff && c.aff_self) {
    bool nz = false;
    for (int s = 0; s < c.n[SK_AFF]; ++s) {
      if (!c.slot[SK_AFF][s].valid) continue;
      const float* row = rows + (size_t)(c.off[SK_AFF] + s) * D1;
      for (int d = tid; d < D; d += bd)
        if (row[d] != 0.0f) nz = true;
    }
    boot = !__syncthreads_or(nz);
  }
  return boot;
}

// An epoch front at node n (epoch_head :1586): the live gates, F_start and
// F_hi into the node's flags, ip_raw and the SelectorSpread count, and the
// node's part of the stacked vector's first AS_FIXED maxima (v)
static __device__ __forceinline__ void aff_front_node(const TablesView& t, const Ctx& c,
                                                      const AffScratch& a, int g, int n,
                                                      const int* j, int boot,
                                                      float (&v)[AS_FIXED]) {
  const int D1 = t.D1, D = D1 - 1;
  const size_t gN = (size_t)g * t.N;  // the block's rows, rebased
  const float* rows = a.rows;
  const int avail = a.cap[n] - j[n];
  int fl = a.flags[n] & (AF_KEY | AF_SAME);
  if (a.feas[n] && avail > 0) {
    bool dns_ok = true, dns_ok_st = true;
    for (int s = 0; s < c.n[SK_DNS]; ++s) {
      const Slot& x = c.slot[SK_DNS][s];
      if (!x.valid) continue;
      const int dom = slot_dom(t, SK_DNS, x.id, n);
      const float at = rows[(size_t)(c.off[SK_DNS] + s) * D1 + dom];
      const bool ok = dom < D && at + x.self - c.dns_min[s] <= x.w;
      dns_ok = dns_ok && ok;
      if (!x.live) dns_ok_st = dns_ok_st && ok;
    }
    bool aff_all = true;
    for (int s = 0; s < c.n[SK_AFF]; ++s) {
      const Slot& x = c.slot[SK_AFF][s];
      if (!x.valid) continue;
      const int dom = slot_dom(t, SK_AFF, x.id, n);
      aff_all = aff_all && dom < D && rows[(size_t)(c.off[SK_AFF] + s) * D1 + dom] > 0.0f;
    }
    bool bl = false, bl_st = false;
    for (int k = SK_ANTI; k <= SK_CAR; ++k) {
      for (int s = 0; s < c.n[k]; ++s) {
        const Slot& x = c.slot[k][s];
        if (!x.valid) continue;
        const int dom = slot_dom(t, k, x.id, n);
        if (rows[(size_t)(c.off[k] + s) * D1 + dom] > 0.0f) {
          bl = true;
          if (!x.live) bl_st = true;
        }
      }
    }
    if (boot || aff_all) {  // room
      if (dns_ok && !bl) fl |= AF_START;
      if (dns_ok_st && !bl_st && (fl & AF_KEY)) fl |= AF_HI;
    }
  }
  a.flags[n] = fl;
  float acc = 0.0f;
  for (int s = 0; s < c.n[SK_CW]; ++s) {
    const Slot& x = c.slot[SK_CW][s];
    if (!x.valid) continue;
    const int dom = slot_dom(t, SK_CW, x.id, n);
    acc = acc + x.w * rows[(size_t)(c.off[SK_CW] + s) * D1 + dom];
  }
  const float ip = a.ip_pref[n] + acc;
  const float pn = rows[(size_t)c.off[SK_SS] * D1 + slot_dom(t, SK_SS, c.slot[SK_SS][0].id, n)];
  a.ip_raw[n] = ip;
  a.pn0[n] = pn;
  const float sm = a.simon_s[n], na = t.nodeaff_raw[gN + n], tr = t.taint_raw[gN + n];
  if (fl & AF_START) {
    v[0] = fmaxf(v[0], sm);
    v[1] = fmaxf(v[1], na);
    v[2] = fmaxf(v[2], tr);
    v[3] = fmaxf(v[3], ip);
    v[4] = fmaxf(v[4], pn);
    v[5] = fmaxf(v[5], -sm);
    v[6] = fmaxf(v[6], -ip);
  }
  if (fl & AF_HI) {
    v[7] = fmaxf(v[7], sm);
    v[8] = fmaxf(v[8], na);
    v[9] = fmaxf(v[9], tr);
    v[10] = fmaxf(v[10], ip);
    v[11] = fmaxf(v[11], pn);
    v[12] = fmaxf(v[12], -sm);
    v[13] = fmaxf(v[13], -ip);
    v[14] = fmaxf(v[14], -sm);
    v[15] = fmaxf(v[15], -na);
    v[16] = fmaxf(v[16], -tr);
    v[17] = fmaxf(v[17], -ip);
  }
}

// K9's payload row of a node: [table (B+1); F_start; F_hi; min(avail, B+1);
// ip_raw; pernode0; simon_s; nodeaff; taint; zone; dom_live; the AF_KEY and
// AF_SAME flags], then every slot's domain at the node: B + AS_PAY_FIXED +
// slots floats
#define AS_PAY_FIXED 12
