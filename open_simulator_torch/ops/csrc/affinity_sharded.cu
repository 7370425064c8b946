// Hand-written Hopper kernels for the affinity wave's sharded epoch path.
//
// K9 replaces the `shard_map` epoch loop of open_simulator_tpu/ops/kernels.py
//    `schedule_affinity_wave` (:1977-2094: `front_sharded` :1982-2066,
//    `loop_sharded` :2068-2078, the shared `epoch_tail` :1714 and
//    `apply_zone` :1680) on the partitioned layout (`table_shardings`,
//    `carry_shardings`): every rank of a node mesh holds only its node
//    block [lo, hi) of the tables and the carry, and the live [slots, D+1]
//    rows whole; rank r builds the segment constants and the epoch front on
//    its block, the host makes the epoch's two collectives
//    (parallel/collectives.py), and the tail runs on every rank on the
//    gathered full-width rows, so the counts, the live rows, `placed` and
//    the statistics are equal on every rank and equal to K5's.
//
// Four kernels, one block each, launched by ops/kernels.py
// `schedule_affinity_wave_sharded_kernel`:
//   setup  (once per segment, the block): the term slots, base
//          feasibility, capacity, static score terms, the composed budget
//          domain of each node and whether its live budget terms all lie in
//          it, the live rows from the carry, j = 0 on every node;
//   front  (per epoch, the block): the live gates, F_start and F_hi, ip_raw
//          and the SelectorSpread count (epoch_head :1586), and one stacked
//          vector of maxima over the block (:1996-2010): the maxima over
//          F_start and F_hi of [simon, nodeaff, taint, ip, pernode] and of
//          [-simon, -ip], of [-simon, -nodeaff, -taint, -ip] over F_hi, and
//          of each weighted carrier's domain and its negation over F_hi;
//   -- pmax of that vector over the ranks --
//   table  (per epoch, the block): the normalizers of F_start from the
//          reduced vector, the block's [B+1] score rows without the
//          SelectorSpread blend, and the payload row [table; F_start; F_hi;
//          min(avail, B+1); ip_raw; pernode0] (:2036-2046), then what the
//          tail reads of every node besides: simon_s, nodeaff, taint, the
//          zone, the budget domain, the AF_KEY / AF_SAME flags and every
//          term slot's domain (the fold's); the segment constants among
//          them ride every epoch, so that the epoch keeps its two
//          collectives;
//   -- all_gather of the payload rows, in rank order --
//   tail   (per epoch, full width, reading no table): the uniform-base,
//          domain and ip gates from the reduced vector, whether the budget
//          composes, the zone sums and the SelectorSpread blend post-gather
//          (apply_zone, as JAX: the zone sums are cross-node sums), then
//          K5's epoch tail: the cut, the top K_EP candidates, the rounds,
//          the sandwich, the head fallback and the fold into j and the live
//          rows.
// The host reads (placed, last) once per epoch to decide on the next.
//
// Exactness across the cut: the payload is f32 (avail clamped to B+1 packs
// exactly and every comparison against it has a left side <= B; ip_raw and
// the counts travel as the f32 values they are); a max is exact in any
// order and mins ride negated; the domain ids ride as f32, exact below
// 2^24; every tie breaks on the global node index, since the tail sees
// every node at its global position. A rank whose block has no F_start or
// F_hi node sends -inf, which every other rank's value beats. -0.0 from a
// negation reaches only guarded divisions.
//
// What bounds it on an H100: latency, as K5, plus the two collectives and
// the host's read per epoch (later work: overlap them and drop the read).
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "affinity.cuh"
#include "affinity_sharded.cuh"
#include "common.cuh"
#include "select.cuh"

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_sharded_setup(TablesView t, int g, int cap1, int B, int N, int lo, int hi, int* j,
                       float* fs, int* is, int* state) {
  __shared__ Ctx c;
  __shared__ PodCtx pc;
  __shared__ float s_red[16 * 32];
  const int D1 = t.D1, tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int n_rows = c.off[SK_SS] + 1;
  // the segment constants (K5's), each node's composed budget domain and
  // whether it has every live DoNotSchedule term's key
  pod_prologue(t, g, 0, &pc, s_red);
  for (int n = lo + tid; n < hi; n += bd) {
    float ip_unused;
    segment_node_constants<false, false>(t, &pc, g, n, cap1, 0, 0, &a.feas[n], &a.cap[n],
                                         &ip_unused, &a.simon_s[n], &a.stat[n]);
    a.ip_pref[n] = interpod_pref_at(t, g, n);
    aff_budget_node(t, c, n, a);
  }
  for (int n = tid; n < N; n += bd) j[n] = 0;
  for (size_t i = tid; i < (size_t)n_rows * D1; i += bd) {
    const int r = (int)(i / D1);
    int k = 0;
    while (k + 1 < N_KINDS && r >= c.off[k + 1]) ++k;
    const int id = c.slot[k][r - c.off[k]].id;
    const float* src = (k == SK_CAR || k == SK_CW) ? t.carrier : t.counter;
    a.rows[i] = src[(size_t)id * D1 + i % D1];
  }
  for (int d = tid; d < D1; d += bd) {
    int e = 0;
    for (int s = 0; s < c.n[SK_DNS]; ++s)
      if (c.slot[SK_DNS][s].live && t.dns_edom[((size_t)g * t.Sd + s) * D1 + d]) e = 1;
    a.edom_live[d] = e;
  }
  for (int z = tid; z < t.Z; z += bd) a.zone_sums[z] = 0.0f;
  if (tid == 0) {
    state[0] = 0;  // placed
    state[1] = 1;  // last
    state[2] = state[3] = state[4] = state[5] = state[6] = 0;
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_sharded_front(TablesView t, int g, int B, int N, int lo, int hi, const int* j,
                       float* fs, int* is, float* part, int* state) {
  __shared__ Ctx c;
  __shared__ float s_red[AS_FIXED * 32];
  const int D = t.D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const float* rows = a.rows;

  // ---- the DoNotSchedule minimum of every valid term, the bootstrap flag
  // (K5's, from the replicated live rows)
  const int boot = aff_front_prologue(t, c, g, rows, s_red);
  __syncthreads();

  // ---- the block's gates, live scores and maxima (epoch_head, then the
  // stacked vector of front_sharded)
  float v[AS_FIXED];
  for (int i = 0; i < AS_FIXED; ++i) v[i] = -INFINITY;
  for (int n = lo + tid; n < hi; n += bd) aff_front_node(t, c, a, g, n, j, boot, v);
  {
    int op[AS_FIXED];
    for (int i = 0; i < AS_FIXED; ++i) op[i] = OP_MAX;
    block_reduce<AS_FIXED>(v, op, s_red);
  }
  if (tid < AS_FIXED) part[tid] = v[tid];
  // each weighted carrier's domain over F_hi, and its negation
  for (int s = 0; s < c.n[SK_CW]; ++s) {
    const Slot& x = c.slot[SK_CW][s];
    float dv[2] = {-1.0f, -(float)(D + 2)};
    for (int n = lo + tid; n < hi; n += bd) {
      if (!(a.flags[n] & AF_HI)) continue;
      const float dom = (float)slot_dom(t, SK_CW, x.id, n);  // exact: domain ids < 2^24
      dv[0] = fmaxf(dv[0], dom);
      dv[1] = fmaxf(dv[1], -dom);
    }
    const int op2[2] = {OP_MAX, OP_MAX};
    block_reduce<2>(dv, op2, s_red);
    if (tid == 0) {
      part[AS_FIXED + s] = dv[0];
      part[AS_FIXED + c.n[SK_CW] + s] = dv[1];
    }
  }
  if (tid == 0) state[5] = boot;
}

// payload row of node n: [table (B+1); F_start; F_hi; min(avail, B+1);
// ip_raw; pernode0; simon_s; nodeaff; taint; zone; dom_live; flags], then
// every slot's domain (affinity_sharded.cuh AS_PAY_FIXED)
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_sharded_table(TablesView t, int g, int B, int N, int lo, int hi, const int* j, float* fs,
                       int* is, const float* red, float* pay) {
  __shared__ Ctx c;
  if (threadIdx.x == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int n_rows = c.off[SK_SS] + 1;
  const int R = t.R, B1 = B + 1, P = B + AS_PAY_FIXED + n_rows;
  const size_t gN = (size_t)g * t.N;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  // serial's normalizers over F_start (norms6 :2019)
  const Norms nm = {red[0], -red[5], fmaxf(red[1], 0.0f), fmaxf(red[2], 0.0f),
                    fmaxf(red[3], 0.0f), fminf(-red[6], 0.0f)};
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    float simon, nodeaff, taint, interpod;
    normalized_terms(nm, a.simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], a.ip_raw[n],
                     &simon, &nodeaff, &taint, &interpod);
    const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                           + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + a.stat[n];
    const float jf = (float)j[n];
    const float nz_c = t.nonzero[(size_t)n * 2 + 0], nz_m = t.nonzero[(size_t)n * 2 + 1];
    const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
    float* row = pay + (size_t)(n - lo) * P;
    for (int k = 0; k < B1; ++k) {
      const float copies = jf + (float)(k + 1);
      float least, bal;
      least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
      row[k] = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
    }
    const int fl = a.flags[n];
    row[B1] = (fl & AF_START) ? 1.0f : 0.0f;
    row[B1 + 1] = (fl & AF_HI) ? 1.0f : 0.0f;
    row[B1 + 2] = (float)min(a.cap[n] - j[n], B1);
    row[B1 + 3] = a.ip_raw[n];
    row[B1 + 4] = a.pn0[n];
    row[B1 + 5] = a.simon_s[n];
    row[B1 + 6] = t.nodeaff_raw[gN + n];
    row[B1 + 7] = t.taint_raw[gN + n];
    row[B1 + 8] = (float)t.node_zone[n];
    row[B1 + 9] = (float)a.dom_live[n];  // ids < 2^24: exact
    row[B1 + 10] = (float)(fl & (AF_KEY | AF_SAME));
    for (int k = 0; k < N_KINDS; ++k)
      for (int s = 0; s < c.n[k]; ++s)
        row[B1 + 11 + c.off[k] + s] = (float)slot_dom(t, k, c.slot[k][s].id, n);
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_sharded_tail(TablesView t, int g, int m, int ss_live, int B, int N, int* j, float* fs,
                      int* is, const float* red, const float* full, int* state) {
  __shared__ Ctx c;
  __shared__ float s_red[16 * 32];
  __shared__ int s_int[32];
  __shared__ u64 s_key[K_EP_MAX];
  __shared__ int s_occ[K_EP_MAX];
  __shared__ int hist[256];
  __shared__ int s_prise[LMAX + 2], s_prov[LMAX + 2], s_hist[LMAX + 2];
  __shared__ u64 s_prefix;
  __shared__ int s_rem, s_cnt, s_L, s_PL;
  const int D1 = t.D1, tid = threadIdx.x, bd = blockDim.x;
  const int B1 = B + 1, Z = t.Z;
  // the gathered rows stand for the tables: group offset 0
  const AffDims dm = {N, D1, D1 - 1, B, B1, Z, min(N * B, K_EP_MAX), N * B + 1, 0};
  if (tid == 0) affinity_slots(t, g, &c);
  if (tid < LMAX + 2) {
    s_prise[tid] = -1;
    s_prov[tid] = 0;
    s_hist[tid] = 0;
  }
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const AffGathered ga = aff_gathered(t, a, N);
  const int n_rows = c.off[SK_SS] + 1, P = B + AS_PAY_FIXED + n_rows;
  TablesView tg = t;  // the sandwich's lower set reads nodeaff and taint of every node
  tg.nodeaff_raw = ga.nodeaff;
  tg.taint_raw = ga.taint;
  float* table = a.table;
  float* ip_raw = a.ip_raw;
  float* pn0 = a.pn0;
  float* bound_s = a.bound;
  float* zone_sums = a.zone_sums;
  const int* avail_s = a.avail;
  int* u_s = a.u;
  int* flags = a.flags;
  const int placed = state[0], boot = state[5];
  const bool has_budget = c.n_budget >= 1, dns_live = c.n_dns > 0;
  const float inc_live = c.inc_live;
  const int Cw = c.n[SK_CW];

  // ---- the gathered rows: the epoch's sets, avail, ip_raw and pernode0 of
  // every node; the zone sums over F_start (apply_zone, post-gather)
  bool anyS = false, anyH = false, hz = false, same = true;
  for (int n = tid; n < N; n += bd) {
    const float* src = full + (size_t)n * P;
    const int fl = (int)src[B1 + 10] | (src[B1] > 0.0f ? AF_START : 0)
                   | (src[B1 + 1] > 0.0f ? AF_HI : 0);
    flags[n] = fl;
    a.avail[n] = (int)src[B1 + 2];
    ip_raw[n] = src[B1 + 3];
    pn0[n] = src[B1 + 4];
    a.simon_s[n] = src[B1 + 5];
    ga.nodeaff[n] = src[B1 + 6];
    ga.taint[n] = src[B1 + 7];
    ga.zone[n] = (int)src[B1 + 8];
    a.dom_live[n] = (int)src[B1 + 9];
    for (int r = 0; r < n_rows; ++r) ga.fdom[(size_t)r * N + n] = (int)src[B1 + 11 + r];
    same = same && (fl & AF_SAME);
    anyH |= (fl & AF_HI) != 0;
    if (fl & AF_START) {
      anyS = true;
      if (ss_live) {
        const int zone = ga.zone[n];
        if (zone > 0) hz = true;
        atomicAdd(&zone_sums[zone], pn0[n]);  // integer counts: exact
      }
    }
  }
  const bool any_start = __syncthreads_or(anyS);
  const bool any_hi = __syncthreads_or(anyH);
  const bool have_zones = __syncthreads_or(hz);
  const bool budget_composes = c.n_budget <= 1 || (c.n_dns == 0 && __syncthreads_and(same));
  // the reduced vector in K5's order: v[0..4] maxima over F_start, v[5], v[6]
  // minima (simon, ip); v[7..11], v[12], v[13] the same over F_hi
  float v[14];
  for (int i = 0; i < 14; ++i) v[i] = (i == 5 || i == 6 || i == 12 || i == 13) ? -red[i] : red[i];
  // uniform normalizer inputs over F_hi (maxes_h[:4] == the minima of the
  // same rows), and ip liveness from the carriers' domain extrema
  const bool uniform_base = v[7] == -red[14] && v[8] == -red[15] && v[9] == -red[16]
                            && v[10] == -red[17] && any_hi;
  bool dom_same = true;
  for (int s = 0; s < Cw; ++s)
    if (c.slot[SK_CW][s].live && red[AS_FIXED + s] != -red[AS_FIXED + Cw + s]) dom_same = false;
  const bool ip_safe = !c.has_live_cw || !any_hi || (dom_same && v[10] == v[13]);
  const float maxN = fmaxf(v[4], 0.0f);
  float maxZ = 0.0f;
  for (int z = 1; z < Z; ++z) maxZ = fmaxf(maxZ, zone_sums[z]);
  bool pre_norms_ok = uniform_base || (v[0] == v[7] && v[1] == v[8] && v[2] == v[9]
                                       && v[3] == v[10] && v[5] == v[12] && v[6] == v[13]);
  if (ss_live) pre_norms_ok = pre_norms_ok && v[4] == v[11];
  const bool ss_multi_ok = !ss_live || !have_zones;
  const bool use_multi_pre = budget_composes && !boot && ip_safe && ss_multi_ok && pre_norms_ok;

  // ---- each F_hi node's table row (the gathered row plus the
  // SelectorSpread blend), its usable prefix and its first hidden entry;
  // one column when the epoch takes one pod
  float b1 = -INFINITY;
  int i1 = 0x7fffffff;
  const int ncols = use_multi_pre ? B1 : 1;
  for (int n = tid; n < N; n += bd) {
    const int fl = flags[n];
    int u = 0;
    float bound = -INFINITY;
    if (fl & AF_HI) {
      const float* src = full + (size_t)n * P;
      const int zone = ga.zone[n];
      const bool blend = have_zones && zone > 0;
      const float zs = ss_live ? zone_sums[zone] : 0.0f;
      float* row = table + (size_t)n * B1;
      int first_bad = B;
      float prev = 0.0f;
      for (int k = 0; k < ncols; ++k) {
        float val = src[k];
        if (ss_live)
          val = val + t.w[W_SS] * floorf(selector_spread_blend(pn0[n] + (float)k, maxN, zs,
                                                               maxZ, blend));
        row[k] = val;
        if (k > 0 && k < B && first_bad == B && val > prev) first_bad = k;
        prev = val;
      }
      if (use_multi_pre) {
        const int avail = avail_s[n];
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

  // ---- K5's epoch tail (affinity.cuh), on the full-width rows
  const AffShared sh = {s_red, s_int, s_occ, hist, s_prise, s_prov, s_hist, &s_rem, &s_cnt,
                        &s_L, &s_PL, s_key, &s_prefix};
  const AvailGathered av = {avail_s};
  int heads = 0, rounds = 0;
  const int m_take = affinity_epoch_tail<AvailGathered, true>(
      tg, c, a, sh, av, dm, m, placed, ss_live, use_multi_pre, uniform_base, any_start,
      has_budget, dns_live, inc_live, v, b1, i1, j, heads, rounds, ga.fdom);
  if (tid == 0) {
    state[0] = placed + m_take;
    state[1] = m_take;
    state[2] += 1;
    state[3] += heads;
    state[4] += rounds;
  }
}

// ------------------------------------------------------------ C interface --

extern "C" {

static long long affinity_sharded_rows(const TablesView* t) {
  return (long long)(t->Sd + t->A + t->B + t->Ca + t->Cw + 1) * t->D1;
}

// (float scratch, int scratch, stacked vector, payload row) sizes of K9 at
// depth B for N nodes (the mesh's)
long long affinity_sharded_scratch_floats(const TablesView* t, int B, int N) {
  return (long long)N * (B + 1) + 6LL * N + affinity_sharded_rows(t) + 2LL * t->D1 + t->Z
         + 2LL * N;
}
long long affinity_sharded_scratch_ints(const TablesView* t, int N) {
  return 7LL * N + 4LL * t->D1 + N + (affinity_sharded_rows(t) / t->D1) * (long long)N;
}
int affinity_sharded_parts(const TablesView* t) { return AS_FIXED + 2 * t->Cw; }
int affinity_sharded_pay_floats(const TablesView* t, int B) {
  return B + AS_PAY_FIXED + (int)(affinity_sharded_rows(t) / t->D1);
}

// t: the block's view, rebased by lo (affinity_sharded.cuh); N: the mesh's
int affinity_sharded_setup_launch(const TablesView* t, int g, int cap1, int B, int N, int lo,
                                  int hi, int* j, float* fs, int* is, int* state,
                                  cudaStream_t stream) {
  affinity_sharded_setup<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, cap1, B, N, lo, hi, j, fs, is,
                                                          state);
  return (int)cudaGetLastError();
}

int affinity_sharded_front_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                  const int* j, float* fs, int* is, float* part, int* state,
                                  cudaStream_t stream) {
  affinity_sharded_front<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, j, fs, is, part,
                                                          state);
  return (int)cudaGetLastError();
}

int affinity_sharded_table_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                  const int* j, float* fs, int* is, const float* red, float* pay,
                                  cudaStream_t stream) {
  affinity_sharded_table<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, j, fs, is, red,
                                                          pay);
  return (int)cudaGetLastError();
}

int affinity_sharded_tail_launch(const TablesView* t, int g, int m, int ss_live, int B, int N,
                                 int* j, float* fs, int* is, const float* red, const float* full,
                                 int* state, cudaStream_t stream) {
  affinity_sharded_tail<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, ss_live, B, N, j, fs, is, red,
                                                         full, state);
  return (int)cudaGetLastError();
}

}  // extern "C"
