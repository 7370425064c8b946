// The scratch layout and the stacked vector of the affinity wave's sharded
// paths, shared by K9 (affinity_sharded.cu: the epoch path) and K11
// (affinity_rounds.cu: the sharded tail above the epoch limit): their
// cluster stages run one setup (aff_setup_stage) and the same per-node
// front (aff_front_prologue, aff_front_node) on the same scratch, and K9's
// tail and K11's merge the same rounds on the compacted domain state
// (affinity_rounds_compact).

#pragma once

#include "affinity.cuh"
#include "common.cuh"
#include "merge.cuh"

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

// The setup of one segment on a cluster over the block [lo, hi) (K9's and
// K11's, one body): K5's segment constants of the block's nodes, each
// node's composed budget domain and flags (aff_budget_node), the live rows
// from the carry, j and the rounds' counts 0 on every node, the zone sums
// 0 and the loop state.
static __device__ __forceinline__ void aff_setup_stage(const TablesView& t, int g, int cap1, int B,
                                                       int N, int lo, int hi, int* j, float* fs,
                                                       int* is, int* state) {
  __shared__ Ctx c;
  __shared__ PodCtx pc;
  __shared__ float s_red[16 * 32];
  CTX_BIND(c, t);
  POD_BIND(pc, t);
  const int D1 = t.D1, tid = threadIdx.x, rank = cluster_rank();
  const int gt = rank * CLUSTER_THREADS + tid, stride = cluster_ctas() * CLUSTER_THREADS;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int n_rows = c.off[SK_SS] + 1;
  int sa, sb;
  cta_slice(hi - lo, &sa, &sb);
  pod_prologue(t, g, 0, &pc, s_red);
  for (int n = lo + sa + tid; n < lo + sb; n += CLUSTER_THREADS) {
    float ip_unused;
    segment_node_constants<false, false>(t, &pc, g, n, cap1, 0, 0, &a.feas[n], &a.cap[n],
                                         &ip_unused, &a.simon_s[n], &a.stat[n]);
    a.ip_pref[n] = interpod_pref_at(t, g, n);
    aff_budget_node(t, c, n, a);
  }
  for (int n = gt; n < N; n += stride) {
    j[n] = 0;
    a.counts[n] = 0;  // the rounds' takes; each finish clears the ones it read
  }
  for (size_t i = gt; i < (size_t)n_rows * D1; i += stride) {
    const int r = (int)(i / D1);
    int k = 0;
    while (k + 1 < N_KINDS && r >= c.off[k + 1]) ++k;
    const int id = c.slot[k][r - c.off[k]].id;
    const float* src = (k == SK_CAR || k == SK_CW) ? t.carrier : t.counter;
    a.rows[i] = src[(size_t)id * D1 + i % D1];
  }
  for (int d = gt; d < D1; d += stride) {
    int e = 0;
    for (int s = 0; s < c.n[SK_DNS]; ++s)
      if (c.slot[SK_DNS][s].live && t.dns_edom[((size_t)g * t.Sd + s) * D1 + d]) e = 1;
    a.edom_live[d] = e;
  }
  for (int z = gt; z < t.Z; z += stride) a.zone_sums[z] = 0.0f;
  if (rank == 0 && tid == 0) {
    state[0] = 0;  // placed
    state[1] = 1;  // last
    state[2] = state[3] = state[4] = state[5] = state[6] = 0;
  }
}

// The compacted round state (global scratch, K_EP_MAX entries each; K11's
// merge keeps one, each CTA of K9's tail its own): K11's merged keys (for
// its finish), and per distinct candidate domain its domain, sandwich bit,
// first consumable position, consumption, live count and taken count
struct Compact {
  u64* keys;
  int *dom, *everb, *first, *cons;
  float *cl, *taken;
};
#define K11_COMPACT_INTS (8 * K_EP_MAX)

static __device__ __forceinline__ Compact compact_of(int* kx) {
  Compact cp;
  cp.keys = reinterpret_cast<u64*>(kx);
  cp.dom = kx + 2 * K_EP_MAX;
  cp.everb = cp.dom + K_EP_MAX;
  cp.first = cp.everb + K_EP_MAX;
  cp.cons = cp.first + K_EP_MAX;
  cp.cl = reinterpret_cast<float*>(cp.cons + K_EP_MAX);
  cp.taken = cp.cl + K_EP_MAX;
  return cp;
}

// The epoch's normalizer vector in K5's order (maxima, then the minima of
// simon and ip, over F_start and over F_hi) from the reduced stacked vector
static __device__ __forceinline__ void k5_order(const float* red, float (&v)[14]) {
  for (int i = 0; i < 14; ++i) v[i] = (i == 5 || i == 6 || i == 12 || i == 13) ? -red[i] : red[i];
}

// A domain's live count: the live budget rows' sum (the order of K5's)
static __device__ __forceinline__ float live_count(const Ctx& c, const float* rows, int D1, int d) {
  float acc = 0.0f;
  for (int k = SK_DNS; k <= SK_CAR; ++k) {
    if (k == SK_AFF) continue;
    for (int s = 0; s < c.n[k]; ++s)
      if (c.slot[k][s].live) acc = acc + rows[(size_t)(c.off[k] + s) * D1 + d];
  }
  return acc;
}

// The rounds of one epoch (JAX round_body :1808, four to a condition check
// as round_chain :1905) on the compacted domain state: affinity.cuh
// `affinity_rounds` with its per-domain passes over the candidates'
// distinct domains (affinity_rounds.cu's header says why that is exact;
// K9's tail and K11's merge run it). s_key[0, L) holds the n_cand distinct
// keys sorted descending, 0 after them (the sort below overwrites their
// first half), s_dom[p] position p's domain (overwritten: each position's
// compact index). Leaves each candidate node's takes in e.counts (which
// are 0 on entry) and every domain's sandwich bit in e.everb; adds the
// productive rounds to `rounds`; returns the pods taken, at most m_rem.
// Block-uniform: each thread owns Q positions (Q * blockDim.x >= K_EP_MAX).
template <int Q>
static __device__ int affinity_rounds_compact(const Ctx& c, const AffScratch& e, const Compact& cp,
                                              const AffShared& sh, int* s_dom, int* s_h0,
                                              const AffDims& dm, int m_rem, int n_cand, int L,
                                              bool has_budget, bool dns_live, float inc_live,
                                              int& rounds) {
  const int D1 = dm.D1, D = dm.D, B = dm.B, INF_P = dm.INF_P;
  const int tid = threadIdx.x, bd = blockDim.x;
  const float* rows = e.rows;
  const int* edom_live = e.edom_live;
  float* s_red = sh.red;
  int* s_int = sh.ints;
  int* s_occ = sh.occ;
  int* s_prise = sh.prise;
  int* s_prov = sh.prov;
  int* s_hist = sh.lhist;
  int& s_L = *sh.L;
  int& s_PL = *sh.PL;
  int got = 0;
  int node[Q], dom[Q], ci[Q];
  bool cand[Q];
  float occ[Q];
  for (int q = 0; q < Q; ++q) {
    const int p = Q * tid + q;
    cand[q] = p < n_cand;
    node[q] = 0;
    dom[q] = 0;
    if (cand[q]) {
      const u32 flat = 0xffffffffu - (u32)(sh.key[p] & 0xffffffffull);
      node[q] = (int)(flat / (u32)B);
      dom[q] = s_dom[p];
    }
  }
  __syncthreads();
  // rank among the same domain's candidates and the compact index of each
  // position's domain: sort the unique (domain, position) pairs, then a
  // max-scan of the run starts and a sum-scan of the runs
  ckey* s_comp = reinterpret_cast<ckey*>(sh.key);
  for (int q = 0; q < Q; ++q) {
    const int p = Q * tid + q;
    if (p < L) s_comp[p] = cand[q] ? ((ckey)dom[q] << POS_BITS) | (ckey)p : CKEY_NONE;
  }
  bitonic_sort<ckey, false>(s_comp, L);
  int rs[Q], st[Q];
  for (int q = 0; q < Q; ++q) {
    const int i = Q * tid + q;
    const bool same = i > 0 && i < n_cand && (s_comp[i] >> POS_BITS) == (s_comp[i - 1] >> POS_BITS);
    rs[q] = same ? 0 : i;
    st[q] = i < n_cand && !same;
  }
  block_scan<true>(rs, s_int);
  const int nd = block_scan<false>(st, s_int);  // the distinct candidate domains
  for (int q = 0; q < Q; ++q) {
    const int i = Q * tid + q;
    if (i >= n_cand) continue;
    const int p = CKEY_POS(s_comp[i]);
    s_occ[p] = i - rs[q];
    s_dom[p] = st[q] - 1;
    if (i == rs[q]) cp.dom[st[q] - 1] = (int)(s_comp[i] >> POS_BITS);
  }
  // the epoch's domain state: every domain's live count, the candidates'
  // marks (compact index + 1 in everb until the rounds end) and round
  // state, the other eligible domains' fixed minimum and level histogram
  for (int d = tid; d < D1; d += bd) {
    e.cl[d] = live_count(c, rows, D1, d);
    e.everb[d] = 0;
  }
  if (tid < LMAX + 2) s_h0[tid] = 0;
  __syncthreads();
  for (int i = tid; i < nd; i += bd) {
    const int d = cp.dom[i];
    e.everb[d] = i + 1;
    cp.cl[i] = e.cl[d];
    cp.taken[i] = 0.0f;
    cp.first[i] = INF_P;
    cp.cons[i] = 0;
    cp.everb[i] = 0;
  }
  __syncthreads();
  float smin = INFINITY;
  for (int d = tid; d < D1; d += bd)
    if (edom_live[d] && !e.everb[d]) smin = fminf(smin, e.cl[d]);
  smin = block_min(smin, s_red);
  if (isfinite(smin))
    for (int d = tid; d < D1; d += bd)
      if (edom_live[d] && !e.everb[d])
        atomicAdd(&s_h0[(int)fminf(e.cl[d] - smin, (float)(LMAX + 1))], 1);
  for (int q = 0; q < Q; ++q) {
    ci[q] = cand[q] ? s_dom[Q * tid + q] : 0;
    occ[q] = cand[q] ? (float)s_occ[Q * tid + q] : 0.0f;
  }
  __syncthreads();

  // ---- the rounds, in chains of four (JAX round_chain): the condition
  // is read once per chain
  float min_c1 = 0.0f;  // the first round's minimum: the static domains' bits
  bool ran = false, any_full = false;
  int last_r = 1;
  while (last_r > 0 && got < m_rem) {
    for (int chain = 0; chain < 4; ++chain) {
      const int m_left = m_rem - got;
      float mn = smin;
      for (int i = tid; i < nd; i += bd)
        if (edom_live[cp.dom[i]]) mn = fminf(mn, cp.cl[i] + cp.taken[i] * inc_live);
      mn = block_min(mn, s_red);
      const float min_c = isfinite(mn) ? mn : 0.0f;
      if (!ran) min_c1 = min_c;
      ran = true;
      // levels still needed per eligible domain; per-position budgets
      for (int i = tid; i < nd; i += bd) {
        if (!edom_live[cp.dom[i]]) continue;
        const float delta = cp.cl[i] + cp.taken[i] * inc_live - min_c;
        atomicAdd(&s_hist[(int)fminf(fmaxf(delta, 0.0f), (float)(LMAX + 1))], 1);
      }
      if (tid < LMAX + 2 && isfinite(smin) && s_h0[tid] > 0)
        atomicAdd(&s_hist[(int)fminf((float)tid + (smin - min_c), (float)(LMAX + 1))], s_h0[tid]);
      bool rem[Q], cons[Q];
      float l_e[Q];
      for (int q = 0; q < Q; ++q) {
        const int p = Q * tid + q;
        rem[q] = cons[q] = false;
        l_e[q] = 1.0f;
        if (!cand[q]) continue;
        const int d = dom[q], x = ci[q];
        const float cnow = cp.cl[x] + cp.taken[x] * inc_live;
        const float qe = budget_q(c, cnow, min_c, d, D);
        const float r_e = occ[q] - cp.taken[x];
        rem[q] = r_e >= 0.0f;
        cons[q] = rem[q] && r_e < qe;
        l_e[q] = fmaxf(1.0f, r_e - qe + 2.0f);
        const float lc = cnow + r_e + 1.0f - min_c;
        if (rem[q] && edom_live[d] && lc >= 1.0f && lc <= (float)LMAX) {
          const int li = (int)fminf(fmaxf(lc, 0.0f), (float)(LMAX + 1));
          atomicMax(&s_prise[li], p);
          atomicAdd(&s_prov[li], 1);
        }
        if (cons[q]) atomicMin(&cp.first[x], p);
      }
      __syncthreads();
      // the multi-level take: the longest run of levels whose every
      // needed domain provided its rise-completing entry
      if (tid == 0) {
        int needed = s_hist[0], L_used = 0, prise = s_prise[0];
        for (int l = 1; l <= LMAX; ++l) {
          if (s_prov[l] != needed) break;
          needed += s_hist[l];
          prise = max(prise, s_prise[l]);
          L_used = l;
        }
        s_L = L_used;
        s_PL = prise;
      }
      __syncthreads();
      const int L_used = s_L, P_L = s_PL;
      bool tf[Q];
      float rv[4] = {0.0f, -1.0f, 0.0f, 0.0f};  // n_full, rise, unreached, any at min
      for (int q = 0; q < Q; ++q) {
        tf[q] = rem[q] && l_e[q] <= (float)L_used && Q * tid + q <= P_L;
        rv[0] += tf[q] ? 1.0f : 0.0f;
      }
      if (dns_live) {
        for (int i = tid; i < nd; i += bd) {
          if (!edom_live[cp.dom[i]] || cp.cl[i] + cp.taken[i] * inc_live != min_c) continue;
          rv[3] = 1.0f;
          if (cp.first[i] >= INF_P) rv[2] = 1.0f;
          else rv[1] = fmaxf(rv[1], (float)cp.first[i]);
        }
        if (tid == 0 && smin == min_c) rv[2] = rv[3] = 1.0f;  // no candidate: unreached
      }
      {
        const int op4[4] = {OP_SUM, OP_MAX, OP_MAX, OP_MAX};
        block_reduce<4>(rv, op4, s_red);
      }
      const int n_full = (int)rv[0];
      const bool use_full = dns_live && L_used >= 1 && n_full <= m_left && n_full > 0;
      const int p_rise = (rv[3] > 0.0f && rv[2] == 0.0f) ? (int)rv[1] : INF_P;
      // the single-rise take, cut at m_left in position order
      int r[Q], tp[Q];
      for (int q = 0; q < Q; ++q) tp[q] = r[q] = cons[q] && Q * tid + q <= p_rise;
      const int total = block_scan<false>(r, s_int);
      const int n_take = use_full ? n_full : min(m_left, total);
      for (int q = 0; q < Q; ++q) {
        if (!(use_full ? tf[q] : (tp[q] && r[q] <= m_left))) continue;
        atomicAdd(&e.counts[node[q]], 1);
        atomicAdd(&cp.cons[ci[q]], 1);
      }
      __syncthreads();
      // the sandwich's bookkeeping, and the round's consumption
      for (int i = tid; i < nd; i += bd) {
        const int d = cp.dom[i];
        const float qd = budget_q(c, cp.cl[i] + cp.taken[i] * inc_live, min_c, d, D);
        const float cd = (float)cp.cons[i];
        const bool blocked = qd < 1.0f || (cd >= qd && isfinite(qd))
                             || (use_full && (edom_live[d] || cd > 0.0f));
        if (blocked && has_budget) cp.everb[i] = 1;
        if (d < D) cp.taken[i] = cp.taken[i] + cd;
        cp.cons[i] = 0;
        cp.first[i] = INF_P;
      }
      if (tid < LMAX + 2) {
        s_prise[tid] = -1;
        s_prov[tid] = 0;
        s_hist[tid] = 0;
      }
      any_full = any_full || use_full;
      __syncthreads();
      got += n_take;
      last_r = n_take;
      rounds += n_take > 0;
    }
  }
  // ---- every domain's sandwich bit: the candidates' from their rounds,
  // the others' from the first round's minimum and the multi-level rounds
  for (int d = tid; d < D1; d += bd) {
    const int mk = e.everb[d];
    bool b = false;
    if (mk) b = cp.everb[mk - 1];
    else if (has_budget && ran)
      b = budget_q(c, e.cl[d] + 0.0f * inc_live, min_c1, d, D) < 1.0f || (any_full && edom_live[d]);
    e.everb[d] = b;
  }
  __syncthreads();
  return got;
}

