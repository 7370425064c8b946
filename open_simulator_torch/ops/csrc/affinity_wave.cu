// Hand-written Hopper kernel for the affinity route.
//
// K5 schedule_affinity_wave_kernel replaces open_simulator_tpu/ops/kernels.py
//    `schedule_affinity_wave` (:1307/:1311; the unsharded epoch loop
//    :1372-1976; its final `_aggregate_commit` :2097 is K3c): places up to m
//    pods of one group whose hard predicates read its own running placements
//    (self-matching DoNotSchedule spread, required self-affinity, non-hostname
//    required self-anti-affinity in either direction, live SelectorSpread)
//    exactly as m serial steps would, and returns per-node counts.
//
// One epoch, as in the JAX function: the live gates and feasible sets
// (F_start, serial's current set; F_hi, with the live budget gates lifted)
// from the [slots, D+1] live counter rows; the normalizers over both; the
// [N, B+1] table of the score each node gives its next copies (with the live
// SelectorSpread blend and its depth caps); then, when the epoch may take
// more than one pod, the usable entries (capacity, depth cap, monotone
// prefix, the two-largest-bound cut), the top K_EP = min(N*B, 2048) of them
// in lax.top_k order, each entry's rank among its domain's candidates, and
// rounds in chains of four that consume that order against per-domain
// budgets; the normalizer sandwich accepts the take, or the epoch places
// serial's single next pick (the head fallback).
//
// The top K_EP without a library sort: when more than K_EP entries are
// usable, the shared radix select (select.cuh) finds the K_EP-th key; the
// entries at or above it (a prefix of each node's row) are gathered into
// shared memory and sorted there by a bitonic sort of their 64-bit keys
// (score bits, then the complement of the flat index: distinct keys, -0 as
// +0). The ranks within domains come from a second bitonic sort, of the
// unique (domain, position) pairs, and a max-scan of the run starts.
// Entries past the candidates (JAX's -inf entries) change nothing in a
// round, so they are not materialized.
//
// What bounds it on an H100: latency. An epoch is a chain of dependent
// block-wide phases (per-slot minima, a node pass, the table, the
// selection, two sorts of <= 2,048 keys, the rounds: each round about ten
// barriers over K_EP positions and the D+1 domains); the bytes are the group's rows
// and the live [slots, D+1] rows, a few hundred KB. Design: ONE persistent
// block of 1,024 threads runs the whole epoch loop (no host round trip per
// epoch); the table, the live rows and the [D+1] round arrays live in device
// memory (L2 resident; five [D+1] rows at 16K domains would not fit in
// shared memory), the candidate order in shared memory (16 KB of keys); each
// thread owns two candidate positions and keeps their state in registers. An
// epoch that cannot take more than one pod (use_multi_pre false: a
// bootstrap, a moving normalizer, zoned SelectorSpread) builds only the
// table's first column. Spreading the table and the node passes over the
// card's 132 SMs is later work.
//
// The exactness contract with the plain PyTorch version is in common.cuh;
// everything past the table is integer-valued f32 or integer work, so the
// atomics (zone sums, row updates, counts) are exact in any order.

#include "common.cuh"
#include "select.cuh"

#define K_EP_MAX 2048
#define LMAX 32
#define POS_BITS 11

typedef unsigned int u32;

// term slot kinds, in the order of their live rows in the float scratch
enum { SK_DNS = 0, SK_AFF, SK_ANTI, SK_CAR, SK_CW, SK_SS, N_KINDS };

// node flags of one epoch
#define AF_START 1  // in F_start (serial's current feasible set)
#define AF_HI 2     // in F_hi (live budget gates lifted)
#define AF_KEY 4    // carries every live DoNotSchedule term's key (static)

struct Slot {
  int id;       // counter id (carrier id for SK_CAR, SK_CW); 0 for a padded slot
  int valid;    // holds a term, after the filter flags
  int live;     // the group's own placements move the gate (DNS, anti, carried anti, cw)
  float inc;    // count one placement adds to the row
  float w;      // SK_CW: the interpod weight; SK_DNS: maxSkew
  float self;   // SK_DNS: the self-match count
};

struct Ctx {
  Slot slot[N_KINDS][MAX_SLOTS];
  int n[N_KINDS];
  int off[N_KINDS];  // first live row of each kind
  float dns_min[MAX_SLOTS];
  int n_dns, n_budget, has_aff, aff_self, has_live_cw;
  float skew_live, self_live, inc_live;
};

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

// Inclusive scan (sum, or max of non-negative values) over 2 * blockDim.x
// elements, thread t holding elements 2t and 2t+1; returns the total.
// `s_int` holds 32 ints.
template <bool MAX>
static __device__ int block_scan2(int& a0, int& a1, int* s_int) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  a1 = MAX ? max(a0, a1) : a0 + a1;
  int x = a1;
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
  a0 = MAX ? max(excl, a0) : excl + a0;
  a1 = MAX ? max(excl, a1) : excl + a1;
  return s_int[nw - 1];
}

// Float scratch: table [N, B+1]; ip_pref, simon_s, static, ip_raw, pernode0
// [N] each; the live rows [slots, D1]; cnt_live, taken [D1] each; bound [N];
// zone sums [Z]. Int scratch: feas, cap, dom_live, u (usable prefix), flags, counts
// [N] each; edom_live, first_pos, consumed, everb [D1] each.
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_affinity_wave_kernel(TablesView t, int g, int m, int cap1, int ss_live, int B, int* j,
                              int* stats, float* fs, int* is) {
  __shared__ Ctx c;
  __shared__ PodCtx pc;
  __shared__ float s_red[16 * 32];
  __shared__ int s_int[32];
  __shared__ u64 s_key[K_EP_MAX];
  __shared__ int s_occ[K_EP_MAX];
  __shared__ int hist[256];
  __shared__ int s_prise[LMAX + 2], s_prov[LMAX + 2], s_hist[LMAX + 2];
  __shared__ u64 s_prefix;
  __shared__ int s_rem, s_cnt, s_L, s_PL;
  const int N = t.N, R = t.R, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  const int B1 = B + 1, Z = t.Z;
  const size_t gN = (size_t)g * N;
  const int K_EP = min(N * B, K_EP_MAX), INF_P = N * B + 1;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];

  // ---- term slots (the JAX prologue :1394-1512), by thread 0
  if (tid == 0) {
    const int ns[N_KINDS] = {t.Sd, t.A, t.B, t.Ca, t.Cw, 1};
    int off = 0;
    for (int k = 0; k < N_KINDS; ++k) {
      c.n[k] = ns[k];
      c.off[k] = off;
      off += ns[k];
    }
    int n_dns = 0, n_anti = 0, has_aff = 0, has_live_cw = 0;
    float skew = 0.0f, self = 0.0f, inc_d = 0.0f, inc_b = 0.0f, inc_c = 0.0f;
    for (int s = 0; s < t.Sd; ++s) {
      Slot& x = c.slot[SK_DNS][s];
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
      Slot& x = c.slot[SK_AFF][s];
      const int id = t.req_aff_t[g * t.A + s];
      x.id = max(id, 0);
      x.valid = id >= 0 && t.f_interpod;
      x.live = 0;
      x.inc = (x.valid && t.counter_sel_match_g[(size_t)x.id * t.G + g]) ? 1.0f : 0.0f;
      has_aff |= x.valid;
    }
    for (int s = 0; s < t.B; ++s) {
      Slot& x = c.slot[SK_ANTI][s];
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
      Slot& x = c.slot[SK_CAR][s];
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
      Slot& x = c.slot[SK_CW][s];
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
      Slot& x = c.slot[SK_SS][0];
      x.id = max(t.ss_t[g], 0);
      x.valid = t.ss_t[g] >= 0;
      x.live = 0;
      x.inc = (x.valid && t.counter_sel_match_g[(size_t)x.id * t.G + g]) ? 1.0f : 0.0f;
    }
    c.n_dns = n_dns;
    c.n_budget = n_dns + n_anti;
    c.has_aff = has_aff;
    c.aff_self = t.grp_aff_self[g];
    c.has_live_cw = has_live_cw;
    c.skew_live = skew;
    c.self_live = self;
    c.inc_live = inc_d + inc_b + inc_c;
  }
  __syncthreads();

  const int n_rows = c.off[SK_SS] + 1;
  float* table = fs;
  float* ip_pref = table + (size_t)N * B1;
  float* simon_s = ip_pref + N;
  float* stat_s = simon_s + N;
  float* ip_raw = stat_s + N;
  float* pn0 = ip_raw + N;
  float* rows = pn0 + N;
  float* cl = rows + (size_t)n_rows * D1;
  float* taken = cl + D1;
  float* bound_s = taken + D1;
  float* zone_sums = bound_s + N;
  int* feas_s = is;
  int* cap_s = feas_s + N;
  int* dom_live = cap_s + N;
  int* u_s = dom_live + N;
  int* flags = u_s + N;
  int* counts = flags + N;
  int* edom_live = counts + N;
  int* first_pos = edom_live + D1;
  int* consumed = first_pos + D1;
  int* everb = consumed + D1;

  // ---- segment constants: base feasibility (no DoNotSchedule, no
  // InterPodAffinity: the epochs gate those from their live rows), capacity,
  // static score terms, the composed budget domain of each node
  pod_prologue(t, g, 0, &pc, s_red);
  bool same = true;
  for (int n = tid; n < N; n += bd) {
    float ip_unused;
    segment_node_constants<false>(t, &pc, g, n, cap1, 0, 0, &feas_s[n], &cap_s[n], &ip_unused,
                                  &simon_s[n], &stat_s[n]);
    ip_pref[n] = interpod_pref_at(t, g, n);
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
    for (int k = SK_DNS; k <= SK_CAR; ++k) {
      if (k == SK_AFF) continue;
      for (int s = 0; s < c.n[k]; ++s)
        if (c.slot[k][s].live && slot_dom(t, k, c.slot[k][s].id, n) != dl) same = false;
    }
    dom_live[n] = dl;
    flags[n] = key ? AF_KEY : 0;
    j[n] = 0;
  }
  for (size_t i = tid; i < (size_t)n_rows * D1; i += bd) {
    const int r = (int)(i / D1);
    int k = 0;
    while (k + 1 < N_KINDS && r >= c.off[k + 1]) ++k;
    const int id = c.slot[k][r - c.off[k]].id;
    const float* src = (k == SK_CAR || k == SK_CW) ? t.carrier : t.counter;
    rows[i] = src[(size_t)id * D1 + i % D1];
  }
  for (int d = tid; d < D1; d += bd) {
    int e = 0;
    for (int s = 0; s < c.n[SK_DNS]; ++s)
      if (c.slot[SK_DNS][s].live && t.dns_edom[((size_t)g * t.Sd + s) * D1 + d]) e = 1;
    edom_live[d] = e;
  }
  for (int z = tid; z < Z; z += bd) zone_sums[z] = 0.0f;
  if (tid < LMAX + 2) {
    s_prise[tid] = -1;
    s_prov[tid] = 0;
    s_hist[tid] = 0;
  }
  const bool doms_same = __syncthreads_and(same);
  const bool budget_composes = c.n_budget <= 1 || (c.n_dns == 0 && doms_same);
  const bool has_budget = c.n_budget >= 1, dns_live = c.n_dns > 0;
  const float inc_live = c.inc_live;

  int placed = 0, last = 1, epochs = 0, heads = 0, rounds_total = 0;
  while (last > 0 && placed < m) {
    // ---- the DoNotSchedule minimum of every valid term, the bootstrap flag
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
      // the counts are non-negative: their sum is 0 iff every entry is 0
      bool nz = false;
      for (int s = 0; s < c.n[SK_AFF]; ++s) {
        if (!c.slot[SK_AFF][s].valid) continue;
        const float* row = rows + (size_t)(c.off[SK_AFF] + s) * D1;
        for (int d = tid; d < D; d += bd)
          if (row[d] != 0.0f) nz = true;
      }
      boot = !__syncthreads_or(nz);
    }
    __syncthreads();

    // ---- the live gates, F_start and F_hi, the live scores and the
    // normalizer inputs over both sets (JAX epoch_head, front_full)
    float v[16] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, INFINITY, INFINITY,
                   -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY,
                   INFINITY, INFINITY, INFINITY, INFINITY};
    bool anyS = false, anyH = false, hz = false;
    for (int n = tid; n < N; n += bd) {
      const int avail = cap_s[n] - j[n];
      int fl = flags[n] & AF_KEY;
      if (feas_s[n] && avail > 0) {
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
      flags[n] = fl;
      if (!(fl & AF_HI)) continue;  // F_start is inside F_hi
      float acc = 0.0f;
      for (int s = 0; s < c.n[SK_CW]; ++s) {
        const Slot& x = c.slot[SK_CW][s];
        if (!x.valid) continue;
        const int dom = slot_dom(t, SK_CW, x.id, n);
        acc = acc + x.w * rows[(size_t)(c.off[SK_CW] + s) * D1 + dom];
      }
      const float ip = ip_pref[n] + acc;
      const float pn = rows[(size_t)c.off[SK_SS] * D1 + slot_dom(t, SK_SS, c.slot[SK_SS][0].id, n)];
      ip_raw[n] = ip;
      pn0[n] = pn;
      const float sm = simon_s[n], na = t.nodeaff_raw[gN + n], tr = t.taint_raw[gN + n];
      anyH = true;
      v[7] = fmaxf(v[7], sm);
      v[8] = fmaxf(v[8], na);
      v[9] = fmaxf(v[9], tr);
      v[10] = fmaxf(v[10], ip);
      v[11] = fmaxf(v[11], pn);
      v[12] = fminf(v[12], sm);
      v[13] = fminf(v[13], ip);
      v[14] = fminf(v[14], na);
      v[15] = fminf(v[15], tr);
      if (fl & AF_START) {
        anyS = true;
        v[0] = fmaxf(v[0], sm);
        v[1] = fmaxf(v[1], na);
        v[2] = fmaxf(v[2], tr);
        v[3] = fmaxf(v[3], ip);
        v[4] = fmaxf(v[4], pn);
        v[5] = fminf(v[5], sm);
        v[6] = fminf(v[6], ip);
        if (ss_live) {
          const int zone = t.node_zone[n];
          if (zone > 0) hz = true;
          atomicAdd(&zone_sums[zone], pn);  // integer counts: exact
        }
      }
    }
    {
      const int op[16] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MIN, OP_MAX,
                          OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MIN, OP_MIN, OP_MIN};
      block_reduce<16>(v, op, s_red);
    }
    const bool any_start = __syncthreads_or(anyS);
    const bool any_hi = __syncthreads_or(anyH);
    const bool have_zones = __syncthreads_or(hz);
    // ip liveness: each live carrier's domain single-valued over F_hi
    bool dom_same = true;
    if (c.has_live_cw && any_hi) {
      for (int s = 0; s < c.n[SK_CW]; ++s) {
        const Slot& x = c.slot[SK_CW][s];
        if (!x.live) continue;
        float dv[2] = {-INFINITY, INFINITY};
        for (int n = tid; n < N; n += bd) {
          if (!(flags[n] & AF_HI)) continue;
          const float dom = (float)slot_dom(t, SK_CW, x.id, n);
          dv[0] = fmaxf(dv[0], dom);
          dv[1] = fminf(dv[1], dom);
        }
        const int op2[2] = {OP_MAX, OP_MIN};
        block_reduce<2>(dv, op2, s_red);
        dom_same = dom_same && dv[0] == dv[1];
      }
    }
    const Norms nm = {v[0], v[5], fmaxf(v[1], 0.0f), fmaxf(v[2], 0.0f), fmaxf(v[3], 0.0f),
                      fminf(v[6], 0.0f)};
    const bool uniform_base = v[7] == v[12] && v[8] == v[14] && v[9] == v[15] && v[10] == v[13]
                              && any_hi;
    const bool ip_safe = !c.has_live_cw || !any_hi || (dom_same && v[10] == v[13]);
    const float maxN = fmaxf(v[4], 0.0f);
    float maxZ = 0.0f;
    for (int z = 1; z < Z; ++z) maxZ = fmaxf(maxZ, zone_sums[z]);
    bool pre_norms_ok = uniform_base || (v[0] == v[7] && v[1] == v[8] && v[2] == v[9]
                                         && v[3] == v[10] && v[5] == v[12] && v[6] == v[13]);
    if (ss_live) pre_norms_ok = pre_norms_ok && v[4] == v[11];
    const bool ss_multi_ok = !ss_live || !have_zones;
    const bool use_multi_pre = budget_composes && !boot && ip_safe && ss_multi_ok && pre_norms_ok;

    // ---- the score table under serial's current normalizers (JAX
    // _wave_score_table + apply_zone), each F_hi node's usable prefix and
    // its first hidden entry; one column when the epoch takes one pod
    float b1 = -INFINITY;
    int i1 = 0x7fffffff;
    const int ncols = use_multi_pre ? B1 : 1;
    for (int n = tid; n < N; n += bd) {
      const int fl = flags[n];
      int u = 0;
      float bound = -INFINITY;
      if (fl & AF_HI) {
        float simon, nodeaff, taint, interpod;
        normalized_terms(nm, simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_raw[n],
                         &simon, &nodeaff, &taint, &interpod);
        const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                               + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + stat_s[n];
        const float jf = (float)j[n];
        const float nz_c = t.nonzero[(size_t)n * 2 + 0], nz_m = t.nonzero[(size_t)n * 2 + 1];
        const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
        const int zone = t.node_zone[n];
        const bool blend = have_zones && zone > 0;
        const float zs = ss_live ? zone_sums[zone] : 0.0f;
        float* row = table + (size_t)n * B1;
        int first_bad = B;
        float prev = 0.0f;
        for (int k = 0; k < ncols; ++k) {
          const float copies = jf + (float)(k + 1);
          float least, bal;
          least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
          float val = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
          if (ss_live)
            val = val + t.w[W_SS] * floorf(selector_spread_blend(pn0[n] + (float)k, maxN, zs,
                                                                 maxZ, blend));
          row[k] = val;
          if (k > 0 && k < B && first_bad == B && val > prev) first_bad = k;
          prev = val;
        }
        if (use_multi_pre) {
          const int avail = cap_s[n] - j[n];
          const int k_cap = ss_live ? (int)fminf(fmaxf(maxN - pn0[n], 0.0f), (float)B) : B;
          u = max(0, min(min(avail, k_cap), first_bad));
          const int k_hid = min(first_bad, k_cap);
          if (k_hid < avail) bound = row[k_hid];
        }
      }
      u_s[n] = u;
      if (use_multi_pre) {
        bound_s[n] = bound;
        argmax_update(bound, n, &b1, &i1);
      }
    }

    if (tid < 1) s_cnt = 0;
    int got = 0, rounds = 0;
    if (use_multi_pre) {
      // ---- the two-largest-bound cut: an entry is usable only if its key
      // beats every OTHER node's first hidden entry
      block_argmax(&b1, &i1, s_red, s_int);
      float b2 = -INFINITY;
      int i2 = 0x7fffffff;
      for (int n = tid; n < N; n += bd) argmax_update(n == i1 ? -INFINITY : bound_s[n], n, &b2, &i2);
      block_argmax(&b2, &i2, s_red, s_int);
      int U = 0;
      for (int n = tid; n < N; n += bd) {
        const float cut_s = n == i1 ? b2 : b1;
        const int cut_i = n == i1 ? i2 : i1;
        const float* row = table + (size_t)n * B1;
        const int u0 = u_s[n];
        int uu = 0;
        while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
        u_s[n] = uu;
        U += uu;
      }
      U = block_sum_int(U, s_int);

      // ---- the top K_EP usable entries in lax.top_k order
      const int n_cand = min(U, K_EP);
      const u64 T = U > K_EP ? select_key(table, u_s, N, B, K_EP, hist, &s_prefix, &s_rem) : 0;
      for (int n = tid; n < N; n += bd) {
        const float* row = table + (size_t)n * B1;
        const int cn = T ? count_at_least(row, n, u_s[n], B, T) : u_s[n];
        if (cn == 0) continue;
        const int base = atomicAdd(&s_cnt, cn);
        for (int k = 0; k < cn; ++k) s_key[base + k] = entry_key(row[k], n, k, B);
      }
      int L = 2;
      while (L < n_cand) L <<= 1;
      __syncthreads();
      for (int i = n_cand + tid; i < L; i += bd) s_key[i] = 0ull;
      bitonic_sort<u64, true>(s_key, L);

      // each thread owns positions 2*tid and 2*tid+1
      int node[2], dom[2];
      bool cand[2];
      float occ[2];
      for (int q = 0; q < 2; ++q) {
        const int p = 2 * tid + q;
        cand[q] = p < n_cand;
        node[q] = 0;
        dom[q] = 0;
        if (cand[q]) {
          const u32 flat = 0xffffffffu - (u32)(s_key[p] & 0xffffffffull);
          node[q] = (int)(flat / (u32)B);
          dom[q] = dom_live[node[q]];
        }
      }
      __syncthreads();
      // rank among the same domain's candidates: sort the unique
      // (domain, position) pairs, then a max-scan of the run starts
      u32* s_comp = reinterpret_cast<u32*>(s_key);
      for (int q = 0; q < 2; ++q) {
        const int p = 2 * tid + q;
        if (p < L) s_comp[p] = cand[q] ? ((u32)dom[q] << POS_BITS) | (u32)p : 0xffffffffu;
      }
      bitonic_sort<u32, false>(s_comp, L);
      int rs[2];
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * tid + q;
        rs[q] = (i > 0 && i < n_cand && (s_comp[i] >> POS_BITS) == (s_comp[i - 1] >> POS_BITS))
                    ? 0 : i;
      }
      block_scan2<true>(rs[0], rs[1], s_int);
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * tid + q;
        if (i < n_cand) s_occ[s_comp[i] & ((1u << POS_BITS) - 1)] = i - rs[q];
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
      for (int q = 0; q < 2; ++q) occ[q] = cand[q] ? (float)s_occ[2 * tid + q] : 0.0f;

      // ---- the rounds, in chains of four (JAX round_chain): the condition
      // is read once per chain
      const int m_rem = m - placed;
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
          bool rem[2], cons[2];
          float l_e[2];
          for (int q = 0; q < 2; ++q) {
            const int p = 2 * tid + q;
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
          bool tf[2];
          float rv[4] = {0.0f, -1.0f, 0.0f, 0.0f};  // n_full, rise, unreached, any at min
          for (int q = 0; q < 2; ++q) {
            tf[q] = rem[q] && l_e[q] <= (float)L_used && 2 * tid + q <= P_L;
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
          int r0 = cons[0] && 2 * tid <= p_rise, r1 = cons[1] && 2 * tid + 1 <= p_rise;
          const int tp0 = r0, tp1 = r1;
          const int total = block_scan2<false>(r0, r1, s_int);
          const bool take[2] = {use_full ? tf[0] : (tp0 && r0 <= m_left),
                                use_full ? tf[1] : (tp1 && r1 <= m_left)};
          const int n_take = use_full ? n_full : min(m_left, total);
          for (int q = 0; q < 2; ++q) {
            if (!take[q]) continue;
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
    }

    // ---- the normalizer sandwich: S_lo <= every F_t <= F_hi
    bool use_multi = false;
    if (use_multi_pre && got > 0) {
      float w7[7] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, INFINITY, INFINITY};
      for (int n = tid; n < N; n += bd) {
        if (!(flags[n] & AF_HI) || (has_budget && everb[dom_live[n]])
            || counts[n] >= cap_s[n] - j[n])
          continue;
        w7[0] = fmaxf(w7[0], simon_s[n]);
        w7[1] = fmaxf(w7[1], t.nodeaff_raw[gN + n]);
        w7[2] = fmaxf(w7[2], t.taint_raw[gN + n]);
        w7[3] = fmaxf(w7[3], ip_raw[n]);
        w7[4] = fmaxf(w7[4], pn0[n]);
        w7[5] = fminf(w7[5], simon_s[n]);
        w7[6] = fminf(w7[6], ip_raw[n]);
      }
      const int op7[7] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MIN};
      block_reduce<7>(w7, op7, s_red);
      bool lo_ok = uniform_base || (v[7] == w7[0] && v[8] == w7[1] && v[9] == w7[2]
                                    && v[10] == w7[3] && v[12] == w7[5] && v[13] == w7[6]);
      if (ss_live) lo_ok = lo_ok && v[11] == w7[4];
      use_multi = lo_ok;
    }

    // ---- the head fallback: serial's single next pick is always exact
    int head = -1;
    if (!use_multi && any_start) {
      float hv = -INFINITY;
      int hi = 0x7fffffff;
      for (int n = tid; n < N; n += bd)
        argmax_update((flags[n] & AF_START) ? table[(size_t)n * B1] : -INFINITY, n, &hv, &hi);
      block_argmax(&hv, &hi, s_red, s_int);
      head = hi;
    }
    const int m_take = use_multi ? got : (head >= 0 ? 1 : 0);

    // ---- fold the takes into j and every live row (the sentinel column
    // never counts, as in commit())
    for (int n = tid; n < N; n += bd) {
      const int cn = use_multi ? counts[n] : (n == head ? 1 : 0);
      if (cn == 0) continue;
      j[n] += cn;
      for (int k = 0; k < N_KINDS; ++k) {
        for (int s = 0; s < c.n[k]; ++s) {
          const Slot& x = c.slot[k][s];
          if (x.inc == 0.0f) continue;
          const int dom = slot_dom(t, k, x.id, n);
          if (dom < D) atomicAdd(&rows[(size_t)(c.off[k] + s) * D1 + dom], (float)cn * x.inc);
        }
      }
    }
    for (int z = tid; z < Z; z += bd) zone_sums[z] = 0.0f;
    __syncthreads();
    placed += m_take;
    last = m_take;
    ++epochs;
    heads += head >= 0;
    rounds_total += use_multi ? rounds : 0;
  }
  if (tid == 0) {
    stats[0] = placed;
    stats[1] = epochs;
    stats[2] = heads;
    stats[3] = rounds_total;
  }
}

// ------------------------------------------------------------ C interface --

extern "C" {

static long long affinity_rows(const TablesView* t) {
  return (long long)(t->Sd + t->A + t->B + t->Ca + t->Cw + 1) * t->D1;
}

// (float scratch, int scratch) sizes of K5 at table depth B
long long affinity_scratch_floats(const TablesView* t, int B) {
  return (long long)t->N * (B + 1) + 6LL * t->N + affinity_rows(t) + 2LL * t->D1 + t->Z;
}
long long affinity_scratch_ints(const TablesView* t) { return 6LL * t->N + 4LL * t->D1; }

int schedule_affinity_wave_launch(const TablesView* t, int g, int m, int cap1, int ss_live, int B,
                                  int* j, int* stats, float* fs, int* is, cudaStream_t stream) {
  schedule_affinity_wave_kernel<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, cap1, ss_live, B, j,
                                                                 stats, fs, is);
  return (int)cudaGetLastError();
}

}  // extern "C"
