// Device code shared by the affinity kernels (affinity_wave.cu: K5 and its
// lanes; affinity_sharded.cu: K9; affinity_rounds.cu: K11): the term slots
// of one group, their live flags and increments, the round budget, the
// block-wide sorts and scans of the candidate order, the rounds, the
// sandwich's lower set and the fold.

#pragma once

#include "common.cuh"
#include "select.cuh"

#define K_EP_MAX 2048
#define LMAX 32
#define POS_BITS 11

typedef unsigned int u32;

// The candidate key (domain << POS_BITS) | position of the rounds' rank
// sort: 32-bit in the default build (a domain below 2^21,
// ops/kernels.py AFFINITY_MAX_D1), 64-bit in the wide build
#if OSIM_WIDE
typedef u64 ckey;
#define CKEY_NONE 0xffffffffffffffffull
#define CKEY_POS(k) ((int)((k) & ((1u << POS_BITS) - 1)))
#else
typedef u32 ckey;
#define CKEY_NONE 0xffffffffu
#define CKEY_POS(k) ((k) & ((1u << POS_BITS) - 1))
#endif

// term slot kinds, in the order of their live rows in the float scratch
enum { SK_DNS = 0, SK_AFF, SK_ANTI, SK_CAR, SK_CW, SK_SS, N_KINDS };

// node flags of one epoch
#define AF_START 1  // in F_start (serial's current feasible set)
#define AF_HI 2     // in F_hi (live budget gates lifted)
#define AF_KEY 4    // carries every live DoNotSchedule term's key (static)
#define AF_SAME 8   // every live budget term's domain is the composed one (static)

struct Slot {
  int id;       // counter id (carrier id for SK_CAR, SK_CW); 0 for a padded slot
  int valid;    // holds a term, after the filter flags
  int live;     // the group's own placements move the gate (DNS, anti, carried anti, cw)
  float inc;    // count one placement adds to the row
  float w;      // SK_CW: the interpod weight; SK_DNS: maxSkew
  float self;   // SK_DNS: the self-match count
};

// The group's term slots; the wide build keeps the slots and dns_min in the
// CTA's scratch (CTX_BIND)
struct Ctx {
#if OSIM_WIDE
  Slot* slot[N_KINDS];  // [n[k]] each
#else
  Slot slot[N_KINDS][MAX_SLOTS];
#endif
  int n[N_KINDS];
  int off[N_KINDS];  // first live row of each kind
#if OSIM_WIDE
  float* dns_min;  // [Sd]
#else
  float dns_min[MAX_SLOTS];
#endif
  int n_dns, n_budget, has_aff, aff_self, has_live_cw;
  float skew_live, self_live, inc_live;
};

#if OSIM_WIDE
static_assert(sizeof(Slot) == 4 * WIDE_SLOT_WORDS && N_KINDS == WIDE_KINDS, "wide scratch");
// every thread writes the same pointers, before any reads them
#define CTX_BIND(c, t)                                                                   \
  do {                                                                                   \
    for (int k_ = 0; k_ < N_KINDS; ++k_)                                                 \
      (c).slot[k_] = (Slot*)wide_row(t, WR_ROWS) + (size_t)k_ * (t).wide_slots;          \
    (c).dns_min = wide_row(t, WR_CTX_DNS);                                               \
  } while (0)
#else
#define CTX_BIND(c, t)
#endif

static __device__ __forceinline__ int slot_dom(const TablesView& t, int kind, int id, int n) {
  return (kind == SK_CAR || kind == SK_CW) ? t.carr_dom[(size_t)id * t.N + n]
                                           : t.counter_dom[(size_t)id * t.N + n];
}

// The per-domain entry budget of a round (JAX round_body q): DNS adds one
// count per entry up to maxSkew above the current minimum; composed anti
// terms admit one entry while the count is 0; the sentinel domain is never
// metered.
static __device__ __forceinline__ float budget_q(const Ctx& c, float cnow, float min_c, int d,
                                                 int D) {
  if (d == D || c.n_budget < 1) return INFINITY;
  if (c.n_dns > 0) return fmaxf(c.skew_live - c.self_live + min_c - cnow + 1.0f, 0.0f);
  return cnow > 0.0f ? 0.0f : 1.0f;
}

// Bitonic sort of a[0, L) in shared memory (L a power of two), descending
// or ascending. Block-uniform; ends with a barrier.
template <typename T, bool DESC>
static __device__ void bitonic_sort(T* a, int L) {
  __syncthreads();
  for (int k = 2; k <= L; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const T x = a[i], y = a[ixj];
          const bool up = (i & k) == 0;
          const bool swap = DESC ? (up ? x < y : x > y) : (up ? x > y : x < y);
          if (swap) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Inclusive scan (sum, or max of non-negative values) over Q * blockDim.x
// elements, thread t holding elements Q t to Q t + Q - 1; returns the total.
// `s_int` holds 32 ints.
template <bool MAX, int Q>
static __device__ int block_scan(int (&a)[Q], int* s_int) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int q = 1; q < Q; ++q) a[q] = MAX ? max(a[q - 1], a[q]) : a[q - 1] + a[q];
  int x = a[Q - 1];
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x = MAX ? max(x, y) : x + y;
  }
  __syncthreads();  // the previous call's readers are done with s_int
  if (lane == 31) s_int[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int v = lane < nw ? s_int[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v = MAX ? max(v, y) : v + y;
    }
    s_int[lane] = v;
  }
  __syncthreads();
  int prev = __shfl_up_sync(FULL_MASK, x, 1);
  if (lane == 0) prev = 0;
  const int before = wid > 0 ? s_int[wid - 1] : 0;
  const int excl = MAX ? max(before, prev) : before + prev;
#pragma unroll
  for (int q = 0; q < Q; ++q) a[q] = MAX ? max(excl, a[q]) : excl + a[q];
  return s_int[nw - 1];
}

// The term slots of group g (the JAX prologue :1394-1512): ids, validity
// under the filter flags, live flags, increments, and the composed budget
// meter's sums. One thread.
static __device__ __forceinline__ void affinity_slots(const TablesView& t, int g, Ctx* c) {
  const int ns[N_KINDS] = {t.Sd, t.A, t.B, t.Ca, t.Cw, 1};
  int off = 0;
  for (int k = 0; k < N_KINDS; ++k) {
    c->n[k] = ns[k];
    c->off[k] = off;
    off += ns[k];
  }
  int n_dns = 0, n_anti = 0, has_aff = 0, has_live_cw = 0;
  float skew = 0.0f, self = 0.0f, inc_d = 0.0f, inc_b = 0.0f, inc_c = 0.0f;
  for (int s = 0; s < t.Sd; ++s) {
    Slot& x = c->slot[SK_DNS][s];
    const int id = t.dns_t[g * t.Sd + s];
    x.id = max(id, 0);
    x.valid = id >= 0 && t.f_spread;
    const bool match = t.counter_sel_match_g[(size_t)x.id * t.G + g];
    x.self = t.dns_self[g * t.Sd + s];
    x.w = t.dns_maxskew[g * t.Sd + s];
    x.live = x.valid && match && x.self > 0.0f;
    x.inc = (match && x.valid) ? 1.0f : 0.0f;
    if (x.live) {
      ++n_dns;
      skew = skew + x.w;
      self = self + x.self;
      inc_d = inc_d + x.inc;
    }
  }
  for (int s = 0; s < t.A; ++s) {
    Slot& x = c->slot[SK_AFF][s];
    const int id = t.req_aff_t[g * t.A + s];
    x.id = max(id, 0);
    x.valid = id >= 0 && t.f_interpod;
    x.live = 0;
    x.inc = (x.valid && t.counter_sel_match_g[(size_t)x.id * t.G + g]) ? 1.0f : 0.0f;
    has_aff |= x.valid;
  }
  for (int s = 0; s < t.B; ++s) {
    Slot& x = c->slot[SK_ANTI][s];
    const int id = t.req_anti_t[g * t.B + s];
    x.id = max(id, 0);
    x.valid = id >= 0 && t.f_interpod;
    x.live = x.valid && t.counter_sel_match_g[(size_t)x.id * t.G + g];
    x.inc = x.live ? 1.0f : 0.0f;
    if (x.live) {
      ++n_anti;
      inc_b = inc_b + x.inc;
    }
  }
  for (int s = 0; s < t.Ca; ++s) {
    Slot& x = c->slot[SK_CAR][s];
    const int id = t.carr_anti_t[g * t.Ca + s];
    x.id = max(id, 0);
    x.valid = id >= 0 && t.f_interpod;
    const float carried = t.grp_carries[(size_t)g * t.Tc + x.id];
    x.live = x.valid && carried > 0.0f;
    x.inc = x.valid ? carried : 0.0f;
    if (x.live) {
      ++n_anti;
      inc_c = inc_c + x.inc;
    }
  }
  for (int s = 0; s < t.Cw; ++s) {
    Slot& x = c->slot[SK_CW][s];
    const int id = t.carr_w_t[g * t.Cw + s];
    x.id = max(id, 0);
    x.valid = id >= 0;
    const float carried = t.grp_carries[(size_t)g * t.Tc + x.id];
    x.live = x.valid && carried > 0.0f;
    x.inc = x.valid ? carried : 0.0f;
    x.w = t.carr_w_w[g * t.Cw + s];
    has_live_cw |= x.live;
  }
  {
    Slot& x = c->slot[SK_SS][0];
    x.id = max(t.ss_t[g], 0);
    x.valid = t.ss_t[g] >= 0;
    x.live = 0;
    x.inc = (x.valid && t.counter_sel_match_g[(size_t)x.id * t.G + g]) ? 1.0f : 0.0f;
  }
  c->n_dns = n_dns;
  c->n_budget = n_dns + n_anti;
  c->has_aff = has_aff;
  c->aff_self = t.grp_aff_self[g];
  c->has_live_cw = has_live_cw;
  c->skew_live = skew;
  c->self_live = self;
  c->inc_live = inc_d + inc_b + inc_c;
}

// The working arrays of one group's epochs in global scratch (K5 and K9
// lay them out apart; `avail` is K9's gathered, clamped copies left, null in
// K5) and the rounds' shared memory (each kernel declares its own).
struct AffScratch {
  float *table, *ip_pref, *simon_s, *stat, *ip_raw, *pn0, *rows, *cl, *taken, *bound, *zone_sums;
  int *feas, *cap, *dom_live, *u, *flags, *counts, *avail, *edom_live, *first_pos, *consumed,
      *everb;
};
// The loop constants of one group's epochs: N nodes, D1 = D + 1 domains, Z
// zones, depth B (B1 = B + 1), K_EP candidates at most, the past-the-end
// position INF_P, and gN = g * N for group g's [G, N] rows.
struct AffDims {
  int N, D1, D, B, B1, Z, K_EP, INF_P;
  size_t gN;
};

struct AffShared {
  float* red;
  int *ints, *occ, *prise, *prov, *lhist, *L, *PL;
  u64* key;
};

// What the sandwich reads of node n: the copies it has left, from the
// segment's capacity and j (K5), or gathered and clamped to B+1 (K9), which
// no count can reach.
struct AvailLive {
  const int *cap, *j;
  __device__ __forceinline__ int avail(int n) const { return cap[n] - j[n]; }
};
struct AvailGathered {
  const int* avail_s;
  __device__ __forceinline__ int avail(int n) const { return avail_s[n]; }
};

// A position's budget domain in the rounds: its node's dom_live (K5, whose
// candidates come from its full-width table).
struct DomLive {
  const int* dom_live;
  __device__ __forceinline__ int operator()(int, int node) const { return dom_live[node]; }
};

// The rounds of one epoch (JAX round_body :1808, four to a condition check
// as round_chain :1905) over the candidate order in s_key[0, L): n_cand
// distinct keys sorted descending, 0 after them, position p's budget domain
// dom_of(p, node). Leaves each node's takes in e.counts (all N cleared
// first) and each domain's sandwich bit in e.everb: JAX ORs
// blocked_d[dom_live] into a per-node mask, and dom_live is fixed within the
// epoch, so a node's bit is its domain's. Adds the productive rounds to
// `rounds`; returns the pods taken, at most m_rem. Block-uniform; each
// thread owns Q positions, so Q * blockDim.x must reach K_EP_MAX (K5's
// clusters of 512 threads take Q = 4).
template <int Q = 2, class DomOf>
static __device__ __forceinline__ int
affinity_rounds(const Ctx& c, const AffScratch& e, const AffShared& sh, const AffDims& dm,
                int m_rem, int n_cand, int L, bool has_budget, bool dns_live, float inc_live,
                const DomOf& dom_of, int& rounds) {
  const int N = dm.N, D1 = dm.D1, D = dm.D, B = dm.B, INF_P = dm.INF_P;
  const int tid = threadIdx.x, bd = blockDim.x;
  float* rows = e.rows;
  float* cl = e.cl;
  float* taken = e.taken;
  const int* edom_live = e.edom_live;
  int* counts = e.counts;
  int* first_pos = e.first_pos;
  int* consumed = e.consumed;
  int* everb = e.everb;
  float* s_red = sh.red;
  int* s_int = sh.ints;
  u64* s_key = sh.key;
  int* s_occ = sh.occ;
  int* s_prise = sh.prise;
  int* s_prov = sh.prov;
  int* s_hist = sh.lhist;
  int& s_L = *sh.L;
  int& s_PL = *sh.PL;
  int got = 0;
  // each thread owns positions Q*tid to Q*tid+Q-1
  int node[Q], dom[Q];
  bool cand[Q];
  float occ[Q];
  for (int q = 0; q < Q; ++q) {
    const int p = Q * tid + q;
    cand[q] = p < n_cand;
    node[q] = 0;
    dom[q] = 0;
    if (cand[q]) {
      const u32 flat = 0xffffffffu - (u32)(s_key[p] & 0xffffffffull);
      node[q] = (int)(flat / (u32)B);
      dom[q] = dom_of(p, node[q]);
    }
  }
  __syncthreads();
  // rank among the same domain's candidates: sort the unique
  // (domain, position) pairs, then a max-scan of the run starts
  ckey* s_comp = reinterpret_cast<ckey*>(s_key);
  for (int q = 0; q < Q; ++q) {
    const int p = Q * tid + q;
    if (p < L) s_comp[p] = cand[q] ? ((ckey)dom[q] << POS_BITS) | (ckey)p : CKEY_NONE;
  }
  bitonic_sort<ckey, false>(s_comp, L);
  int rs[Q];
  for (int q = 0; q < Q; ++q) {
    const int i = Q * tid + q;
    rs[q] = (i > 0 && i < n_cand && (s_comp[i] >> POS_BITS) == (s_comp[i - 1] >> POS_BITS))
                ? 0 : i;
  }
  block_scan<true>(rs, s_int);
  for (int q = 0; q < Q; ++q) {
    const int i = Q * tid + q;
    if (i < n_cand) s_occ[CKEY_POS(s_comp[i])] = i - rs[q];
  }
  // the epoch's round state: live counts, consumption, blocks
  for (int d = tid; d < D1; d += bd) {
    float acc = 0.0f;
    for (int k = SK_DNS; k <= SK_CAR; ++k) {
      if (k == SK_AFF) continue;
      for (int s = 0; s < c.n[k]; ++s)
        if (c.slot[k][s].live) acc = acc + rows[(size_t)(c.off[k] + s) * D1 + d];
    }
    cl[d] = acc;
    taken[d] = 0.0f;
    first_pos[d] = INF_P;
    consumed[d] = 0;
    everb[d] = 0;
  }
  for (int n = tid; n < N; n += bd) counts[n] = 0;
  __syncthreads();
  for (int q = 0; q < Q; ++q) occ[q] = cand[q] ? (float)s_occ[Q * tid + q] : 0.0f;

  // ---- the rounds, in chains of four (JAX round_chain): the condition
  // is read once per chain
  int last_r = 1;
  while (last_r > 0 && got < m_rem) {
    for (int chain = 0; chain < 4; ++chain) {
      const int m_left = m_rem - got;
      float mn = INFINITY;
      for (int d = tid; d < D1; d += bd)
        if (edom_live[d]) mn = fminf(mn, cl[d] + taken[d] * inc_live);
      mn = block_min(mn, s_red);
      const float min_c = isfinite(mn) ? mn : 0.0f;
      // levels still needed per eligible domain; per-position budgets
      for (int d = tid; d < D1; d += bd) {
        if (!edom_live[d]) continue;
        const float delta = cl[d] + taken[d] * inc_live - min_c;
        atomicAdd(&s_hist[(int)fminf(fmaxf(delta, 0.0f), (float)(LMAX + 1))], 1);
      }
      bool rem[Q], cons[Q];
      float l_e[Q];
      for (int q = 0; q < Q; ++q) {
        const int p = Q * tid + q;
        rem[q] = cons[q] = false;
        l_e[q] = 1.0f;
        if (!cand[q]) continue;
        const int d = dom[q];
        const float cnow = cl[d] + taken[d] * inc_live;
        const float qe = budget_q(c, cnow, min_c, d, D);
        const float r_e = occ[q] - taken[d];
        rem[q] = r_e >= 0.0f;
        cons[q] = rem[q] && r_e < qe;
        l_e[q] = fmaxf(1.0f, r_e - qe + 2.0f);
        const float lc = cnow + r_e + 1.0f - min_c;
        if (rem[q] && edom_live[d] && lc >= 1.0f && lc <= (float)LMAX) {
          const int li = (int)fminf(fmaxf(lc, 0.0f), (float)(LMAX + 1));
          atomicMax(&s_prise[li], p);
          atomicAdd(&s_prov[li], 1);
        }
        if (cons[q]) atomicMin(&first_pos[d], p);
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
        for (int d = tid; d < D1; d += bd) {
          if (!edom_live[d] || cl[d] + taken[d] * inc_live != min_c) continue;
          rv[3] = 1.0f;
          if (first_pos[d] >= INF_P) rv[2] = 1.0f;
          else rv[1] = fmaxf(rv[1], (float)first_pos[d]);
        }
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
        atomicAdd(&counts[node[q]], 1);
        atomicAdd(&consumed[dom[q]], 1);
      }
      __syncthreads();
      // the sandwich's bookkeeping, and the round's consumption
      for (int d = tid; d < D1; d += bd) {
        const float qd = budget_q(c, cl[d] + taken[d] * inc_live, min_c, d, D);
        const float cd = (float)consumed[d];
        const bool blocked = qd < 1.0f || (cd >= qd && isfinite(qd))
                             || (use_full && (edom_live[d] || cd > 0.0f));
        if (blocked && has_budget) everb[d] = 1;
        if (d < D) taken[d] = taken[d] + cd;
        consumed[d] = 0;
        first_pos[d] = INF_P;
      }
      if (tid < LMAX + 2) {
        s_prise[tid] = -1;
        s_prov[tid] = 0;
        s_hist[tid] = 0;
      }
      __syncthreads();
      got += n_take;
      last_r = n_take;
      rounds += n_take > 0;
    }
  }
  return got;
}

// The sandwich's lower set on nodes [lo, hi) (JAX :1921): the maxima of
// simon, nodeaff, taint, ip and pernode and the minima of simon and ip
// (K5's w7 order) over F_hi without the nodes of an ever-blocked domain and
// those the takes exhaust. Block-uniform; every thread gets w7.
template <class Avail>
static __device__ __forceinline__ void
affinity_lower_set(const TablesView& t, const AffScratch& e, const Avail& av, const AffDims& dm,
                   int lo, int hi, bool has_budget, float (&w7)[7], float* s_red) {
  const size_t gN = dm.gN;
  for (int i = 0; i < 7; ++i) w7[i] = i < 5 ? -INFINITY : INFINITY;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    if (!(e.flags[n] & AF_HI) || (has_budget && e.everb[e.dom_live[n]])
        || e.counts[n] >= av.avail(n))
      continue;
    w7[0] = fmaxf(w7[0], e.simon_s[n]);
    w7[1] = fmaxf(w7[1], t.nodeaff_raw[gN + n]);
    w7[2] = fmaxf(w7[2], t.taint_raw[gN + n]);
    w7[3] = fmaxf(w7[3], e.ip_raw[n]);
    w7[4] = fmaxf(w7[4], e.pn0[n]);
    w7[5] = fminf(w7[5], e.simon_s[n]);
    w7[6] = fminf(w7[6], e.ip_raw[n]);
  }
  const int op7[7] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MIN};
  block_reduce<7>(w7, op7, s_red);
}

// Fold the epoch's takes on the nodes [lo, hi) into j and every live row
// (the sentinel column never counts, as in commit()): each node's counts
// when use_multi, else one pod on `head` (none where head < 0). A slot's
// domain at node n is dom_of(n, r), r the slot's live row (K9's tail reads
// it from the gathered payload, since its view holds only the rank's
// block). The row updates are atomics of integer-valued counts: exact in
// any order, so the CTAs of a cluster may fold their slices at once.
template <class DomOf>
static __device__ __forceinline__ void affinity_fold(const Ctx& c, const AffScratch& e, int D1,
                                                     int lo, int hi, bool use_multi, int head,
                                                     int* j, const DomOf& dom_of) {
  const int D = D1 - 1;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    const int cn = use_multi ? e.counts[n] : (n == head ? 1 : 0);
    if (cn == 0) continue;
    j[n] += cn;
    for (int k = 0; k < N_KINDS; ++k) {
      for (int s = 0; s < c.n[k]; ++s) {
        const Slot& x = c.slot[k][s];
        if (x.inc == 0.0f) continue;
        const int dom = dom_of(n, c.off[k] + s);
        if (dom < D) atomicAdd(&e.rows[(size_t)(c.off[k] + s) * D1 + dom], (float)cn * x.inc);
      }
    }
  }
}
