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
// K5 over lanes (schedule_affinity_wave_lanes_kernel, one block per lane,
// each with its own scratch slice for the live rows and round arrays, so
// every atomic stays inside its lane) replaces `probe_affinity_wave_fanout`
// (:2340/:2342); see common.cuh `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh;
// everything past the table is integer-valued f32 or integer work, so the
// atomics (zone sums, row updates, counts) are exact in any order.

#include "affinity.cuh"
#include "common.cuh"
#include "select.cuh"

// Float scratch: table [N, B+1]; ip_pref, simon_s, static, ip_raw, pernode0
// [N] each; the live rows [slots, D1]; cnt_live, taken [D1] each; bound [N];
// zone sums [Z]. Int scratch: feas, cap, dom_live, u (usable prefix), flags, counts
// [N] each; edom_live, first_pos, consumed, everb [D1] each.
// LANE: the lane kernel's body (the lane's active row folds into the static
// mask); the single-lane kernel runs LANE = false.
template <bool LANE>
static __device__ __forceinline__ void
schedule_affinity_wave_body(const TablesView& t, int g, int m, int cap1, int ss_live, int B,
                            int* j, int* stats, float* fs, int* is) {
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
  if (tid == 0) affinity_slots(t, g, &c);
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
    segment_node_constants<false, LANE>(t, &pc, g, n, cap1, 0, 0, &feas_s[n], &cap_s[n],
                                        &ip_unused, &simon_s[n], &stat_s[n]);
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

    const AffScratch ep = {table,    ip_pref, simon_s, stat_s,    ip_raw,    pn0,      rows,
                           cl,       taken,   bound_s, zone_sums, feas_s,    cap_s,    dom_live,
                           u_s,      flags,   counts,  nullptr,   edom_live, first_pos, consumed,
                           everb};
    const AffShared sh = {s_red, s_int, s_occ, hist, s_prise, s_prov, s_hist, &s_rem, &s_cnt,
                          &s_L, &s_PL, s_key, &s_prefix};
    const AvailLive av = {cap_s, j};
    const AffDims dm = {N, D1, D, B, B1, Z, K_EP, INF_P, gN};
    const int m_take = affinity_epoch_tail(t, c, ep, sh, av, dm, m, placed, ss_live,
                                           use_multi_pre, uniform_base, any_start, has_budget,
                                           dns_live, inc_live, v, b1, i1, j, heads, rounds_total);
    placed += m_take;
    last = m_take;
    ++epochs;
  }
  if (tid == 0) {
    stats[0] = placed;
    stats[1] = epochs;
    stats[2] = heads;
    stats[3] = rounds_total;
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_affinity_wave_kernel(TablesView t, int g, int m, int cap1, int ss_live, int B, int* j,
                              int* stats, float* fs, int* is) {
  schedule_affinity_wave_body<false>(t, g, m, cap1, ss_live, B, j, stats, fs, is);
}

// K5 over lanes (JAX probe_affinity_wave_fanout :2340): block s runs lane s's
// epoch loop into its own j row [s, N], stats row [s, 4] and scratch slices
// (its live rows, round arrays and their atomics included).
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_affinity_wave_lanes_kernel(TablesView t, int g, int m, int cap1, int ss_live, int B,
                                    int* j, int* stats, float* fs, int* is, long long fs_lane,
                                    long long is_lane) {
  const int s = blockIdx.x;
  LANE_VIEW(lt, t, s)
  schedule_affinity_wave_body<true>(lt, g, m, cap1, ss_live, B, j + (size_t)s * t.N,
                                    stats + 4 * s, fs + s * fs_lane, is + s * is_lane);
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

// S lanes: the view is lane 0's with `t->active` the [S, N] mask; j, stats
// [S, N], [S, 4]; fs, is S slices of the scratch sizes above
int schedule_affinity_wave_lanes_launch(const TablesView* t, int g, int m, int cap1, int ss_live,
                                        int B, int S, int* j, int* stats, float* fs, int* is,
                                        cudaStream_t stream) {
  schedule_affinity_wave_lanes_kernel<<<S, BLOCK_THREADS, 0, stream>>>(
      *t, g, m, cap1, ss_live, B, j, stats, fs, is, affinity_scratch_floats(t, B),
      affinity_scratch_ints(t));
  return (int)cudaGetLastError();
}

}  // extern "C"
