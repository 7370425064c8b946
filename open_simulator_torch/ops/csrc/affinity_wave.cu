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
// What bounds it on an H100: latency. An epoch is a chain of dependent
// cross-node steps over a few dozen bytes a node; the live rows and the
// round arrays are [slots, D+1] and [D+1]. Design: each lane's whole epoch
// loop runs on one persistent thread-block cluster of C CTAs of 512 threads
// (cluster.cuh, C from ops/cluster.py `choose`). CTA r owns a node slice and
// keeps its nodes' segment constants, epoch state and table rows in shared
// memory (in its slice of global scratch where they do not fit), and its
// own copy of the live rows (shared memory when it fits with the rows, else
// global scratch), into which it folds every take as every other CTA does.
// The DoNotSchedule minima are kept level by level (cluster.cuh dns_levels)
// and the bootstrap flag from the self-affinity rows' first nonzero count.
// A one-pod epoch (a bootstrap, a moving normalizer, zoned SelectorSpread:
// use_multi_pre false) is two cluster rounds: (1) the 16 normalizer values,
// any_start, any_hi, have_zones, the zone sums and the live carriers'
// domain range; (2) the table's first column's first-max, the head. A
// multi-pod epoch adds the two-largest-bound cut (one round of top-two
// pairs), the usable count and key range, the K_EP-th key by the cluster
// radix select (wave_cluster.cuh) only when more are usable, each CTA's
// candidate count, then every CTA's candidate keys pushed into every CTA's
// shared memory; each CTA sorts them (bitonic) and runs the rounds
// (affinity.cuh affinity_rounds, four positions a thread) replicated, with
// no exchange, and the sandwich's lower set is one more round.
//
// K5 over lanes (schedule_affinity_wave_lanes_kernel, one cluster per lane,
// each with its own scratch slice) replaces `probe_affinity_wave_fanout`
// (:2340/:2342); see common.cuh `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh;
// everything past the table is integer-valued f32 or integer work, so the
// atomics (zone sums, row updates, counts) are exact in any order.

#include "affinity.cuh"
#include "wave_cluster.cuh"

// Round 1's keys: the 16 normalizer values, any_start, any_hi, have_zones,
// and the domain max / min of the first K5_CW_FUSED live carriers (more
// carriers take a round each pair)
#define K5_CW_FUSED 2
#define K5_KEYS (19 + 2 * K5_CW_FUSED)
// A lane's stats row (i32): placed, epochs, head fallbacks, multi-pod
// rounds, cluster rounds
#define K5_STATS 5

static __host__ __device__ inline int k5_words(int Z) {
  return K5_KEYS + Z > RX_WORDS ? K5_KEYS + Z : RX_WORDS;
}
static __host__ __device__ inline long long k5_ctx_bytes() {
  return ((long long)sizeof(Ctx) + 15) & ~15LL;
}
static __host__ __device__ inline long long k5_live_rows(const TablesView& t) {
  return (long long)(t.Sd + t.A + t.B + t.Ca + t.Cw + 1) * t.D1;
}

// A CTA's dynamic shared memory besides its rows: the candidate keys
// [K_EP_MAX] u64 and ranks [K_EP_MAX], the term slots (Ctx), the rounds'
// warp words [RX_SCRATCH], a radix histogram [256], the round slots
// [2][C][W], fin [W], the zone partial sums and sums [Z] each (padded to 4)
static __host__ __device__ inline long long k5_fixed_bytes(const TablesView& t, int C) {
  const long long W = k5_words(t.Z), Z4 = (t.Z + 3) & ~3;
  return 12LL * K_EP_MAX + k5_ctx_bytes() + 4LL * (RX_SCRATCH + 256 + 2 * C * W + W + 2 * Z4);
}

// K5's per-node rows of a CTA: feas, cap, flags, u, j [chunk] i32; the
// floored Simon input, static terms, interpod preference and raw, and
// per-node SelectorSpread count [chunk] f32; the table [chunk, B+1]
static __host__ __device__ inline long long k5_rows_bytes(int N, int B, int C) {
  const long long chunk = (N + C - 1) / C;
  return 4LL * chunk * (B + 11);
}

// Where a CTA's node rows and its live rows live: on chip, node rows first
static __host__ __device__ inline bool k5_rows_on_chip(const TablesView& t, int B, int C) {
  return k5_fixed_bytes(t, C) + k5_rows_bytes(t.N, B, C) <= CLUSTER_SMEM_MAX;
}
static __host__ __device__ inline bool k5_live_on_chip(const TablesView& t, int B, int C) {
  return k5_rows_on_chip(t, B, C)
         && k5_fixed_bytes(t, C) + k5_rows_bytes(t.N, B, C) + 4 * k5_live_rows(t)
                <= CLUSTER_SMEM_MAX;
}

// K5's dynamic shared memory at C, the one formula of it (ops/cluster.py
// takes it from here)
static __host__ __device__ inline long long k5_smem_bytes(const TablesView& t, int B, int C) {
  return k5_fixed_bytes(t, C) + (k5_rows_on_chip(t, B, C) ? k5_rows_bytes(t.N, B, C) : 0)
         + (k5_live_on_chip(t, B, C) ? 4 * k5_live_rows(t) : 0);
}

// Floats of one CTA's part of a lane's scratch: its counts [N], its round
// arrays cl, taken, edom_live, first_pos, consumed, everb [D1], then its
// live rows and its node rows where they are not on chip
static __host__ __device__ inline long long k5_cta_floats(const TablesView& t, int B, int C) {
  return (long long)t.N + 6LL * t.D1 + (k5_live_on_chip(t, B, C) ? 0 : k5_live_rows(t))
         + (k5_rows_on_chip(t, B, C) ? 0 : k5_rows_bytes(t.N, B, C) / 4);
}

// Floats of one lane's scratch: the composed budget domain of every node
// [N] i32 (each CTA writes its slice), then each CTA's part
static __host__ __device__ inline long long k5_scratch_floats(const TablesView& t, int B, int C) {
  return (long long)t.N + C * k5_cta_floats(t, B, C);
}

// The slot index of the q-th live carrier of the interpod weight (SK_CW)
static __device__ __forceinline__ int live_cw(const Ctx& c, int q) {
  for (int s = 0; s < c.n[SK_CW]; ++s)
    if (c.slot[SK_CW][s].live && q-- == 0) return s;
  return -1;
}

// This CTA's exclusive prefix, in rank order, of every CTA's sum of its
// threads' x, and the cluster's total (*total). One round.
static __device__ int cluster_prefix(Cluster& cx, int x, int* s_rx, int* fin, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  round_arm(cx, 1);
  const int r = __reduce_add_sync(FULL_MASK, x);
  if (lane == 0) s_rx[wid] = r;
  __syncthreads();
  if (wid == 0)
    round_put(cx, 0, __reduce_add_sync(FULL_MASK, lane < CLUSTER_WARPS ? s_rx[lane] : 0));
  const int W = cx.W;
  const int* src = round_wait(cx);
  if (wid == 0) {
    const int y = lane < cx.C ? src[lane * W] : 0;
    const int ex = __reduce_add_sync(FULL_MASK, lane < cx.rank ? y : 0);
    const int tot = __reduce_add_sync(FULL_MASK, y);
    if (lane == 0) {
      fin[0] = ex;
      fin[1] = tot;
    }
  }
  __syncthreads();
  *total = fin[1];
  return fin[0];
}

// One lane's epoch loop on this CTA's cluster. `t_in` is the launch's view
// (lane 0's for the lane kernel, moved to lane s by lane_view); j_out [N] and
// stats [K5_STATS] are the lane's, fs its scratch.
template <bool LANE>
static __device__ __forceinline__ void
schedule_affinity_wave_body(const TablesView& t_in, int s, int g, int m, int cap1, int ss_live,
                            int B, int* j_out, int* stats, float* fs) {
  __shared__ TablesView t;
  __shared__ PodCtx pc;
  __shared__ uint64_t s_mbar[2];
  __shared__ float s_red[7 * 32];
  __shared__ int s_int[32];
  __shared__ int s_prise[LMAX + 2], s_prov[LMAX + 2], s_lhist[LMAX + 2];
  __shared__ int s_sel[CLUSTER_WARPS + 3];
  __shared__ u64 s_w64[CLUSTER_WARPS];
  SLOT_ARRAY(float, s_mn);  // the DoNotSchedule levels (dns_levels)
  SLOT_ARRAY(int, s_nmin);
  TERM_WORD(s_rescan);
  __shared__ int s_L, s_PL, s_cnt, s_bootnz;
  __shared__ float s_maxz;
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int C = cluster_ctas(), rank = cluster_rank();
  if (tid == 0) t = LANE ? lane_view(t_in, s) : t_in;
  __syncthreads();
  const int N = t.N, R = t.R, D1 = t.D1, D = D1 - 1, Z = t.Z, B1 = B + 1;
  const int chunk = (N + C - 1) / C, W = k5_words(Z);
  const size_t gN = (size_t)g * N;
  const int K_EP = min(N * B, K_EP_MAX), INF_P = N * B + 1;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  const bool rows_on = k5_rows_on_chip(t, B, C), live_on = k5_live_on_chip(t, B, C);

  // ---- dynamic shared memory and scratch
  u64* s_key = (u64*)smem;
  int* s_occ = (int*)(s_key + K_EP_MAX);
  Ctx& c = *(Ctx*)(s_occ + K_EP_MAX);
  int* s_rx = (int*)((char*)&c + k5_ctx_bytes());
  int* s_hist = s_rx + RX_SCRATCH;
  int* slots = s_hist + 256;
  CTX_BIND(c, t);
  POD_BIND(pc, t);
  SLOT_BIND(s_mn, t, WR_MN);
  SLOT_BIND(s_nmin, t, WR_NMIN);
  TERM_BIND(s_rescan, t, WC_RESCAN);
  WARP_BIND(s_rx, t);
  int* fin = slots + 2 * C * W;
  float* part = (float*)(fin + W);
  float* zsum = part + ((Z + 3) & ~3);
  float* chip = zsum + ((Z + 3) & ~3);
  int* dom_live = (int*)fs;  // [N], every node's
  float* cta = fs + N + (size_t)rank * k5_cta_floats(t, B, C);
  int* counts = (int*)cta;
  float* cl = cta + N;
  float* taken = cl + D1;
  int* edom_live = (int*)(taken + D1);
  int* first_pos = edom_live + D1;
  int* consumed = first_pos + D1;
  int* everb = consumed + D1;
  float* spill = (float*)(everb + D1);
  float* rows = live_on ? chip + (rows_on ? k5_rows_bytes(N, B, C) / 4 : 0) : spill;
  float* nrow = rows_on ? chip : spill + (live_on ? 0 : k5_live_rows(t));
  int* feas_s = (int*)nrow;
  int* cap_s = feas_s + chunk;
  int* flags_s = cap_s + chunk;
  int* u_s = flags_s + chunk;
  int* j_s = u_s + chunk;
  float* simon_s = (float*)(j_s + chunk);
  float* stat_s = simon_s + chunk;
  float* ip_pref = stat_s + chunk;
  float* ip_raw = ip_pref + chunk;
  float* pn0 = ip_raw + chunk;
  float* tab = pn0 + chunk;

  // ---- term slots (the JAX prologue :1394-1512), by thread 0 of each CTA
  if (tid == 0) affinity_slots(t, g, &c);
  Cluster cx = cluster_setup(N, W, slots, s_mbar);
  const int lo = cx.lo, cnt = cx.hi - cx.lo;
  cta_prologue(t, g, true, 0, &pc, s_rx);
  __syncthreads();
  const int n_rows = c.off[SK_SS] + 1;

  // ---- segment constants: base feasibility (no DoNotSchedule, no
  // InterPodAffinity: the epochs gate those from their live rows), capacity,
  // static score terms, the composed budget domain of each node
  bool same = true;
  for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
    const int n = lo + l;
    float ip_unused;
    segment_node_constants<false, LANE>(t, &pc, g, n, cap1, 0, 0, &feas_s[l], &cap_s[l],
                                        &ip_unused, &simon_s[l], &stat_s[l]);
    ip_pref[l] = interpod_pref_at(t, g, n);
    int sum = 0, key = 1;
    for (int k = SK_DNS; k <= SK_CAR; ++k) {
      if (k == SK_AFF) continue;
      for (int q = 0; q < c.n[k]; ++q) {
        if (!c.slot[k][q].live) continue;
        const int dom = slot_dom(t, k, c.slot[k][q].id, n);
        sum += dom;
        if (k == SK_DNS && dom >= D) key = 0;
      }
    }
    const int dl = sum / max(c.n_budget, 1);
    for (int k = SK_DNS; k <= SK_CAR; ++k) {
      if (k == SK_AFF) continue;
      for (int q = 0; q < c.n[k]; ++q)
        if (c.slot[k][q].live && slot_dom(t, k, c.slot[k][q].id, n) != dl) same = false;
    }
    dom_live[n] = dl;
    flags_s[l] = key ? AF_KEY : 0;
    j_s[l] = 0;
  }
  for (size_t i = tid; i < (size_t)n_rows * D1; i += CLUSTER_THREADS) {
    const int r = (int)(i / D1);
    int k = 0;
    while (k + 1 < N_KINDS && r >= c.off[k + 1]) ++k;
    const int id = c.slot[k][r - c.off[k]].id;
    const float* src = (k == SK_CAR || k == SK_CW) ? t.carrier : t.counter;
    rows[i] = src[(size_t)id * D1 + i % D1];
  }
  for (int d = tid; d < D1; d += CLUSTER_THREADS) {
    int e = 0;
    for (int q = 0; q < c.n[SK_DNS]; ++q)
      if (c.slot[SK_DNS][q].live && t.dns_edom[((size_t)g * t.Sd + q) * D1 + d]) e = 1;
    edom_live[d] = e;
  }
  for (int z = tid; z < Z; z += CLUSTER_THREADS) part[z] = 0.0f;
  if (tid < LMAX + 2) {
    s_prise[tid] = -1;
    s_prov[tid] = 0;
    s_lhist[tid] = 0;
  }
  if (tid == 0) {
    TERMS_ZERO(s_rescan, t);
    s_bootnz = 0;
  }
#if OSIM_WIDE
  // the valid DoNotSchedule slots, word by word (every thread stores the
  // same words)
  const TermSet dns_terms = wide_terms(t, WC_DNS_TERMS);
  for (int w = 0; w < (c.n[SK_DNS] + 63) / 64; ++w) {
    unsigned long long x = 0ull;
    for (int q = 64 * w; q < min(c.n[SK_DNS], 64 * w + 64); ++q)
      if (c.slot[SK_DNS][q].valid) x |= 1ull << (q & 63);
    dns_terms[w] = x;
  }
#else
  unsigned long long dns_terms = 0ull;  // the valid DoNotSchedule slots
  for (int q = 0; q < c.n[SK_DNS]; ++q)
    if (c.slot[SK_DNS][q].valid) dns_terms |= 1ull << q;
#endif
  // every CTA started (its mbarriers visible) and every slice of dom_live
  // written: release / acquire at cluster scope covers global memory
  cluster_barrier_uncounted();
  int same_r[1] = {same ? 1 : 0};
  {
    const int op[1] = {RX_MIN};
    cluster_reduce<1>(cx, same_r, op, s_rx, fin);
  }
  dns_levels(t, g, rows, dns_terms, &pc, s_mn, s_nmin, s_rx);
  // the bootstrap's self-affinity rows: nonzero once a count lands (the
  // counts are non-negative, so their sum is 0 iff every entry is 0)
  bool boot_nz = false;
  if (c.has_aff && c.aff_self) {
    bool nz = false;
    for (int q = 0; q < c.n[SK_AFF]; ++q) {
      if (!c.slot[SK_AFF][q].valid) continue;
      const float* row = rows + (size_t)(c.off[SK_AFF] + q) * D1;
      for (int d = tid; d < D; d += CLUSTER_THREADS)
        if (row[d] != 0.0f) nz = true;
    }
    boot_nz = __syncthreads_or(nz);
  }
  const bool budget_composes = c.n_budget <= 1 || (c.n_dns == 0 && same_r[0]);
  const bool has_budget = c.n_budget >= 1, dns_live = c.n_dns > 0;
  const float inc_live = c.inc_live;
  int n_live_cw = 0;
  for (int q = 0; q < c.n[SK_CW]; ++q) n_live_cw += c.slot[SK_CW][q].live;

  const AffScratch ep = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, rows, cl, taken,
                         nullptr, nullptr, nullptr, nullptr, dom_live, nullptr, nullptr, counts,
                         nullptr, edom_live, first_pos, consumed, everb};
  // the sandwich's view of this CTA's node rows, indexed by global node
  const AffScratch ep_nodes = {nullptr, nullptr, simon_s - lo, nullptr, ip_raw - lo, pn0 - lo,
                               nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               dom_live, nullptr, flags_s - lo, counts, nullptr, nullptr,
                               nullptr, nullptr, everb};
  const AffShared sh = {s_red, s_int, s_occ, s_prise, s_prov, s_lhist, &s_L, &s_PL, s_key};
  const AffDims dm = {N, D1, D, B, B1, Z, K_EP, INF_P, gN};

  int placed = 0, last = 1, epochs = 0, heads = 0, rounds_total = 0;
  while (last > 0 && placed < m) {
    const int boot = (c.has_aff && c.aff_self) ? !boot_nz : 0;

    // ---- the live gates, F_start and F_hi, the live scores and the
    // normalizer inputs over both sets (JAX epoch_head, front_full)
    float v[16] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, INFINITY, INFINITY,
                   -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY,
                   INFINITY, INFINITY, INFINITY, INFINITY};
    int anyS = 0, anyH = 0, hz = 0;
    int cwk[2 * K5_CW_FUSED];
    for (int q = 0; q < K5_CW_FUSED; ++q) {
      cwk[2 * q] = INT_LO;
      cwk[2 * q + 1] = INT_HI;
    }
    for (int base = 0; base < cnt; base += CLUSTER_THREADS) {  // uniform trips
      const int l = base + tid;
      int zone_at = -1;
      float pn_at = 0.0f;
      if (l < cnt) {
        const int n = lo + l;
        const int avail = cap_s[l] - j_s[l];
        int fl = flags_s[l] & AF_KEY;
        if (feas_s[l] && avail > 0) {
          bool dns_ok = true, dns_ok_st = true;
          for (int q = 0; q < c.n[SK_DNS]; ++q) {
            const Slot& x = c.slot[SK_DNS][q];
            if (!x.valid) continue;
            const int dom = slot_dom(t, SK_DNS, x.id, n);
            const float at = rows[(size_t)(c.off[SK_DNS] + q) * D1 + dom];
            const bool ok = dom < D && at + x.self - pc.dns_min[q] <= x.w;
            dns_ok = dns_ok && ok;
            if (!x.live) dns_ok_st = dns_ok_st && ok;
          }
          bool aff_all = true;
          for (int q = 0; q < c.n[SK_AFF]; ++q) {
            const Slot& x = c.slot[SK_AFF][q];
            if (!x.valid) continue;
            const int dom = slot_dom(t, SK_AFF, x.id, n);
            aff_all = aff_all && dom < D && rows[(size_t)(c.off[SK_AFF] + q) * D1 + dom] > 0.0f;
          }
          bool bl = false, bl_st = false;
          for (int k = SK_ANTI; k <= SK_CAR; ++k) {
            for (int q = 0; q < c.n[k]; ++q) {
              const Slot& x = c.slot[k][q];
              if (!x.valid) continue;
              const int dom = slot_dom(t, k, x.id, n);
              if (rows[(size_t)(c.off[k] + q) * D1 + dom] > 0.0f) {
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
        flags_s[l] = fl;
        if (fl & AF_HI) {  // F_start is inside F_hi
          float acc = 0.0f;
          for (int q = 0; q < c.n[SK_CW]; ++q) {
            const Slot& x = c.slot[SK_CW][q];
            if (!x.valid) continue;
            const int dom = slot_dom(t, SK_CW, x.id, n);
            acc = acc + x.w * rows[(size_t)(c.off[SK_CW] + q) * D1 + dom];
          }
          const float ip = ip_pref[l] + acc;
          const float pn =
              rows[(size_t)c.off[SK_SS] * D1 + slot_dom(t, SK_SS, c.slot[SK_SS][0].id, n)];
          ip_raw[l] = ip;
          pn0[l] = pn;
          const float sm = simon_s[l], na = t.nodeaff_raw[gN + n], tr = t.taint_raw[gN + n];
          anyH = 1;
          v[7] = fmaxf(v[7], sm);
          v[8] = fmaxf(v[8], na);
          v[9] = fmaxf(v[9], tr);
          v[10] = fmaxf(v[10], ip);
          v[11] = fmaxf(v[11], pn);
          v[12] = fminf(v[12], sm);
          v[13] = fminf(v[13], ip);
          v[14] = fminf(v[14], na);
          v[15] = fminf(v[15], tr);
          for (int q = 0; q < K5_CW_FUSED && q < n_live_cw; ++q) {
            const int dom = slot_dom(t, SK_CW, c.slot[SK_CW][live_cw(c, q)].id, n);
            cwk[2 * q] = max(cwk[2 * q], dom);
            cwk[2 * q + 1] = min(cwk[2 * q + 1], dom);
          }
          if (fl & AF_START) {
            anyS = 1;
            v[0] = fmaxf(v[0], sm);
            v[1] = fmaxf(v[1], na);
            v[2] = fmaxf(v[2], tr);
            v[3] = fmaxf(v[3], ip);
            v[4] = fmaxf(v[4], pn);
            v[5] = fminf(v[5], sm);
            v[6] = fminf(v[6], ip);
            if (ss_live) {
              const int zone = t.node_zone[n];
              if (zone > 0) hz = 1;
              zone_at = zone;
              pn_at = pn;
            }
          }
        }
      }
      if (ss_live) warp_add_at(part, zone_at, pn_at);  // integer counts: exact
    }

    // ---- round 1: the normalizers, any_start, any_hi, have_zones, the zone
    // sums and the live carriers' domain range
    const int ne = ss_live ? Z : 0;
    {
      int key[K5_KEYS];
      for (int k = 0; k < 16; ++k) key[k] = okey(v[k]);
      key[16] = anyS;
      key[17] = anyH;
      key[18] = hz;
      for (int k = 0; k < 2 * K5_CW_FUSED; ++k) key[19 + k] = cwk[k];
      unsigned mins = (1u << 5) | (1u << 6) | (1u << 12) | (1u << 13) | (1u << 14) | (1u << 15);
      for (int q = 0; q < K5_CW_FUSED; ++q) mins |= 1u << (20 + 2 * q);
      cluster_round_push<K5_KEYS>(cx, key, mins, part, ne, nullptr, 0, s_rx);
      cluster_round_finish(cx, K5_KEYS, mins, ne, 0, fin);
    }
    for (int k = 0; k < 16; ++k) v[k] = ounkey(fin[k]);
    const bool any_start = fin[16], any_hi = fin[17], have_zones = fin[18];
    bool dom_same = true;
    for (int q = 0; q < K5_CW_FUSED && q < n_live_cw; ++q)
      dom_same = dom_same && fin[19 + 2 * q] == fin[20 + 2 * q];
    for (int z = tid; z < Z; z += CLUSTER_THREADS) {
      zsum[z] = ss_live ? __int_as_float(fin[K5_KEYS + z]) : 0.0f;
      part[z] = 0.0f;  // pushed already
    }
    __syncthreads();
    if (tid == 0) {
      float mz = 0.0f;
      for (int z = 1; z < Z; ++z) mz = fmaxf(mz, zsum[z]);
      s_maxz = mz;
    }
    // ip liveness past the fused carriers: each live carrier's domain
    // single-valued over F_hi, a pair of carriers a round
    if (c.has_live_cw && any_hi) {
      for (int q0 = K5_CW_FUSED; q0 < n_live_cw; q0 += 2) {
        int dv[4] = {INT_LO, INT_HI, INT_LO, INT_HI};
        for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
          if (!(flags_s[l] & AF_HI)) continue;
          for (int q = q0; q < q0 + 2 && q < n_live_cw; ++q) {
            const int dom = slot_dom(t, SK_CW, c.slot[SK_CW][live_cw(c, q)].id, lo + l);
            dv[2 * (q - q0)] = max(dv[2 * (q - q0)], dom);
            dv[2 * (q - q0) + 1] = min(dv[2 * (q - q0) + 1], dom);
          }
        }
        const int op[4] = {RX_MAX, RX_MIN, RX_MAX, RX_MIN};
        cluster_reduce<4>(cx, dv, op, s_rx, fin);
        dom_same = dom_same && dv[0] == dv[1] && dv[2] == dv[3];
      }
    }
    __syncthreads();
    const float maxZ = s_maxz;
    const Norms nm = {v[0], v[5], fmaxf(v[1], 0.0f), fmaxf(v[2], 0.0f), fmaxf(v[3], 0.0f),
                      fminf(v[6], 0.0f)};
    const bool uniform_base = v[7] == v[12] && v[8] == v[14] && v[9] == v[15] && v[10] == v[13]
                              && any_hi;
    const bool ip_safe = !c.has_live_cw || !any_hi || (dom_same && v[10] == v[13]);
    const float maxN = fmaxf(v[4], 0.0f);
    bool pre_norms_ok = uniform_base || (v[0] == v[7] && v[1] == v[8] && v[2] == v[9]
                                         && v[3] == v[10] && v[5] == v[12] && v[6] == v[13]);
    if (ss_live) pre_norms_ok = pre_norms_ok && v[4] == v[11];
    const bool ss_multi_ok = !ss_live || !have_zones;
    const bool use_multi_pre = budget_composes && !boot && ip_safe && ss_multi_ok && pre_norms_ok;

    // ---- the score table under serial's current normalizers (JAX
    // _wave_score_table + apply_zone), each F_hi node's usable prefix and
    // its first hidden entry; one column when the epoch takes one pod
    float b1 = -INFINITY, b2 = -INFINITY;
    int i1 = INT_HI, i2 = INT_HI;
    const int ncols = use_multi_pre ? B1 : 1;
    for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
      const int n = lo + l;
      const int fl = flags_s[l];
      int u = 0;
      float bound = -INFINITY;
      if (fl & AF_HI) {
        float simon, nodeaff, taint, interpod;
        normalized_terms(nm, simon_s[l], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_raw[l],
                         &simon, &nodeaff, &taint, &interpod);
        const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                               + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + stat_s[l];
        const float jf = (float)j_s[l];
        const float nz_c = t.nonzero[(size_t)n * 2 + 0], nz_m = t.nonzero[(size_t)n * 2 + 1];
        const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
        const int zone = t.node_zone[n];
        const bool blend = have_zones && zone > 0;
        const float zs = ss_live ? zsum[zone] : 0.0f;
        float* row = tab + (size_t)l * B1;
        int first_bad = B;
        float prev = 0.0f;
        for (int k = 0; k < ncols; ++k) {
          const float copies = jf + (float)(k + 1);
          float least, bal;
          least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
          float val = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
          if (ss_live)
            val = val + t.w[W_SS] * floorf(selector_spread_blend(pn0[l] + (float)k, maxN, zs,
                                                                 maxZ, blend));
          row[k] = val;
          if (k > 0 && k < B && first_bad == B && val > prev) first_bad = k;
          prev = val;
        }
        if (use_multi_pre) {
          const int avail = cap_s[l] - j_s[l];
          const int k_cap = ss_live ? (int)fminf(fmaxf(maxN - pn0[l], 0.0f), (float)B) : B;
          u = max(0, min(min(avail, k_cap), first_bad));
          const int k_hid = min(first_bad, k_cap);
          if (k_hid < avail) bound = row[k_hid];
        }
      }
      u_s[l] = u;
      if (use_multi_pre) top2_update(bound, n, b1, i1, b2, i2);
    }

    int got = 0, rounds = 0;
    bool use_multi = false;
    if (use_multi_pre) {
      // ---- the two-largest-bound cut: an entry is usable only if its key
      // beats every OTHER node's first hidden entry
      cluster_top2(cx, b1, i1, b2, i2, s_rx, fin);
      int U = 0, hmin = INT_HI, lmin = INT_HI;
      u64 kmax = 0;
      for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
        const int n = lo + l;
        const float cut_s = n == i1 ? b2 : b1;
        const int cut_i = n == i1 ? i2 : i1;
        const float* row = tab + (size_t)l * B1;
        const int u0 = u_s[l];
        int uu = 0;
        while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
        u_s[l] = uu;
        if (uu == 0) continue;
        U += uu;
        const u64 k0 = entry_key(row[0], n, 0, B), kl = entry_key(row[uu - 1], n, uu - 1, B);
        if (k0 > kmax) kmax = k0;
        hmin = min(hmin, uokey((uint32_t)(kl >> 32)));
        lmin = min(lmin, uokey((uint32_t)kl));
      }
      int r3[3] = {U, hmin, lmin};
      const int op3[3] = {RX_SUM, RX_MIN, RX_MIN};
      cluster_reduce<3, true>(cx, r3, op3, s_rx, fin, &kmax, s_w64);
      U = r3[0];

      // ---- the top K_EP usable entries in lax.top_k order: every CTA's
      // candidates pushed into every CTA's s_key, then sorted there
      const int n_cand = min(U, K_EP);
      if (n_cand > 0) {
        u64 T = 0;
        if (U > K_EP) {
          const u64 kmin = ((u64)uounkey(r3[1]) << 32) | (u64)uounkey(r3[2]);
          const RowSet rs = {tab, B1, u_s, lo, cnt, B, B};
          T = cluster_select_key(cx, rs, K_EP, kmin, kmax, s_hist, s_sel, s_rx, fin, s_w64);
        }
        int mine = 0;
        for (int l = tid; l < cnt; l += CLUSTER_THREADS)
          mine += T ? count_at_least(tab + (size_t)l * B1, lo + l, u_s[l], B, T) : u_s[l];
        if (tid == 0) s_cnt = 0;
        int total;
        const int base = cluster_prefix(cx, mine, s_rx, fin, &total);
        const uint32_t mbar = cx.mbar_a + 8 * cx.parity, key_a = smem_u32(s_key);
        if (tid == 0) mbar_arrive_expect(mbar, (uint32_t)(n_cand * 8));
        for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
          const float* row = tab + (size_t)l * B1;
          const int cn = T ? count_at_least(row, lo + l, u_s[l], B, T) : u_s[l];
          if (cn == 0) continue;
          const int p0 = base + atomicAdd(&s_cnt, cn);
          for (int k = 0; k < cn; ++k) {
            const u64 key = entry_key(row[k], lo + l, k, B);
            for (int r = 0; r < C; ++r) {
              const uint32_t dst = at_rank(key_a + 8 * (p0 + k), r), mb = at_rank(mbar, r);
              st_async(dst, (int)(uint32_t)key, mb);
              st_async(dst + 4, (int)(uint32_t)(key >> 32), mb);
            }
          }
        }
        round_wait(cx);
        int L = 2;
        while (L < n_cand) L <<= 1;
        for (int i = n_cand + tid; i < L; i += CLUSTER_THREADS) s_key[i] = 0ull;
        bitonic_sort<u64, true>(s_key, L);
        got = affinity_rounds<4>(c, ep, sh, dm, m - placed, n_cand, L, has_budget, dns_live,
                                 inc_live, DomLive{dom_live}, rounds);
      }

      // ---- the normalizer sandwich: S_lo <= every F_t <= F_hi
      if (got > 0) {
        float w7[7];
        affinity_lower_set(t, ep_nodes, AvailLive{cap_s - lo, j_s - lo}, dm, lo, cx.hi,
                           has_budget, w7, s_red);
        int r7[7];
        for (int k = 0; k < 7; ++k) r7[k] = okey(w7[k]);
        const int op7[7] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MIN, RX_MIN};
        cluster_reduce<7>(cx, r7, op7, s_rx, fin);
        for (int k = 0; k < 7; ++k) w7[k] = ounkey(r7[k]);
        bool lo_ok = uniform_base || (v[7] == w7[0] && v[8] == w7[1] && v[9] == w7[2]
                                      && v[10] == w7[3] && v[12] == w7[5] && v[13] == w7[6]);
        if (ss_live) lo_ok = lo_ok && v[11] == w7[4];
        use_multi = lo_ok;
      }
    }

    // ---- the head fallback: serial's single next pick is always exact
    int head = -1;
    if (!use_multi && any_start) {
      float hv = -INFINITY;
      int hi = INT_HI;
      for (int l = tid; l < cnt; l += CLUSTER_THREADS)
        argmax_update((flags_s[l] & AF_START) ? tab[(size_t)l * B1] : -INFINITY, lo + l, &hv,
                      &hi);
      head = cluster_argmax(cx, hv, hi, s_rx, fin);
    }

    // ---- fold the takes into j (the owner's nodes) and this CTA's live
    // rows (the sentinel column never counts, as in commit())
    if (use_multi) {
      for (int n = tid; n < N; n += CLUSTER_THREADS) {
        const int cn = counts[n];
        if (cn == 0) continue;
        if (n >= lo && n < cx.hi) j_s[n - lo] += cn;
        for (int k = 0; k < N_KINDS; ++k) {
          for (int q = 0; q < c.n[k]; ++q) {
            const Slot& x = c.slot[k][q];
            if (x.inc == 0.0f) continue;
            const int dom = slot_dom(t, k, x.id, n);
            if (dom >= D) continue;
            atomicAdd(&rows[(size_t)(c.off[k] + q) * D1 + dom], (float)cn * x.inc);
            if (k == SK_AFF) s_bootnz = 1;
          }
        }
      }
      if (tid == 0) TERMS_COPY(s_rescan, dns_terms, t);  // the levels from scratch
    } else if (head >= 0 && tid == 0) {
      if (head >= lo && head < cx.hi) j_s[head - lo] += 1;
      for (int k = 0; k < N_KINDS; ++k) {
        for (int q = 0; q < c.n[k]; ++q) {
          const Slot& x = c.slot[k][q];
          if (x.inc == 0.0f) continue;
          const int dom = slot_dom(t, k, x.id, head);
          if (dom >= D) continue;
          float* at = &rows[(size_t)(c.off[k] + q) * D1 + dom];
          const float old = *at;
          *at = old + x.inc;
          if (k == SK_AFF) s_bootnz = 1;
          // one eligible domain fewer at the minimum; none left: rescan
          if (k == SK_DNS && TERM_IN(dns_terms, q)
              && t.dns_edom[((size_t)g * t.Sd + q) * D1 + dom] && old == s_mn[q]
              && --s_nmin[q] == 0)
            TERMS_ADD(s_rescan, q);
        }
      }
    }
    __syncthreads();
    boot_nz = s_bootnz;
    const TermSet rescan = s_rescan;
    if (TERMS_ANY(rescan, t)) {
      dns_levels(t, g, rows, rescan, &pc, s_mn, s_nmin, s_rx);
      if (tid == 0) TERMS_ZERO(s_rescan, t);  // every thread read it before the barriers
    }
    const int m_take = use_multi ? got : (head >= 0 ? 1 : 0);
    heads += head >= 0;
    rounds_total += use_multi ? rounds : 0;
    placed += m_take;
    last = m_take;
    ++epochs;
  }
  for (int l = tid; l < cnt; l += CLUSTER_THREADS) j_out[lo + l] = j_s[l];
  if (rank == 0 && tid == 0) {
    stats[0] = placed;
    stats[1] = epochs;
    stats[2] = heads;
    stats[3] = rounds_total;
    stats[4] = cx.rounds;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_affinity_wave_kernel(TablesView t, int g, int m, int cap1, int ss_live, int B, int* j,
                              int* stats, float* fs) {
  schedule_affinity_wave_body<false>(t, 0, g, m, cap1, ss_live, B, j, stats, fs);
}

// K5 over lanes (JAX probe_affinity_wave_fanout :2340): cluster s runs lane
// s's epoch loop into its own j row [s, N], stats row [s, K5_STATS] and
// scratch slice.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_affinity_wave_lanes_kernel(TablesView t, int g, int m, int cap1, int ss_live, int B,
                                    int* j, int* stats, float* fs, long long fs_lane) {
  const int s = blockIdx.x / cluster_ctas();
  schedule_affinity_wave_body<true>(t, s, g, m, cap1, ss_live, B, j + (size_t)s * t.N,
                                    stats + K5_STATS * s, fs + s * fs_lane);
}

// ------------------------------------------------------------ C interface --

extern "C" {

// K5's dynamic shared memory at C, and the floats of one lane's scratch, at
// table depth B
long long affinity_wave_smem(const TablesView* t, int B, int C) { return k5_smem_bytes(*t, B, C); }
long long affinity_scratch_floats(const TablesView* t, int B, int C) {
  return k5_scratch_floats(*t, B, C);
}

// cluster_kernel_init (cluster.cuh) of K5's two kernels; schedule.cu
// cluster_kernels_init calls it
int affinity_cluster_init() {
  cudaError_t e = cluster_kernel_init(schedule_affinity_wave_kernel);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_affinity_wave_lanes_kernel);
  return (int)e;
}

static bool k5_cluster_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

// One cluster of C CTAs with `smem` bytes each (affinity_wave_smem; any
// other value is refused). stats [K5_STATS].
int schedule_affinity_wave_launch(const TablesView* t, int g, int m, int cap1, int ss_live, int B,
                                  int* j, int* stats, float* fs, int C, long long smem,
                                  cudaStream_t stream) {
  if (!k5_cluster_size_ok(C) || smem != affinity_wave_smem(t, B, C))
    return (int)cudaErrorInvalidValue;
  return cluster_launch(schedule_affinity_wave_kernel, C, 1, smem, stream, *t, g, m, cap1,
                        ss_live, B, j, stats, fs);
}

// S lanes, one cluster of C CTAs each: the view is lane 0's with
// `t->active` the [S, N] mask; j, stats [S, N], [S, K5_STATS]; fs S slices
// of affinity_scratch_floats
int schedule_affinity_wave_lanes_launch(const TablesView* t, int g, int m, int cap1, int ss_live,
                                        int B, int S, int* j, int* stats, float* fs, int C,
                                        long long smem, cudaStream_t stream) {
  if (!k5_cluster_size_ok(C) || smem != affinity_wave_smem(t, B, C))
    return (int)cudaErrorInvalidValue;
  return cluster_launch(schedule_affinity_wave_lanes_kernel, C, S, smem, stream, *t, g, m, cap1,
                        ss_live, B, j, stats, fs, affinity_scratch_floats(t, B, C));
}

// Clusters of C CTAs with `smem` bytes that can be resident at once, into
// *out, for the single-lane (lanes 0) or the lane kernel
int affinity_wave_occupancy(int lanes, int C, long long smem, int* out) {
  if (!k5_cluster_size_ok(C)) return (int)cudaErrorInvalidValue;
  return lanes ? cluster_occupancy_of(schedule_affinity_wave_lanes_kernel, C, smem, out)
               : cluster_occupancy_of(schedule_affinity_wave_kernel, C, smem, out);
}

}  // extern "C"
