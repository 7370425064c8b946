// Hand-written Hopper kernel for the wave route.
//
// K3 schedule_wave_kernel replaces open_simulator_tpu/ops/kernels.py
//    `schedule_wave` (:1110/:1113, unsharded path :1273-1283, with
//    _wave_statics :868, _wave_norms :890, _wave_score_table_rows :904,
//    _wave_capacity :945, _wave_gpu_params :956, _gpu_capacity :963 and
//    _wave_candidates_from :1056): places up to m
//    interchangeable pods of one group exactly as m serial steps would, and
//    returns per-node counts; K3c (aggregate_commit.cu) commits them.
//
// gpu_live (a shared-GPU group without a pre-assigned gpu-index, the view's
// f_gpu): K3 adds the GPU filter to the base feasibility and clamps each
// node's capacity by floor(sum(units) / max(num, 1)); the scores do not
// move.
//
// One K3 iteration builds the table of the score each node gives its next
// copies, masks the entries a hidden entry could beat (the
// hidden-continuation guard), takes the best min(m_rem, kmax, usable)
// entries in serial's pick order (score desc, flat index asc: the order
// lax.top_k returns), and stops at the first node-exhausting pick when the
// normalizers over the shrunken feasible set differ; when it takes nothing,
// serial's next pick (the best head) alone.
//
// The table at its usable depth: no node takes more copies than its
// capacity, so the segment's table depth is A = max(1, min(B, the largest
// capacity of a base-feasible node)) and a row holds A + 1 entries. Each
// node's usable prefix, its first hidden entry and the entry that empties it
// depend only on its first min(capacity, B) + 1 entries, and the flat index
// n * A + k orders the usable entries as n * B + k does, so every take is
// the one at depth B (tests/test_torch_wave_depth.py). A cap1 wave builds 2
// entries a node, not B + 1, and selects over at most N.
//
// The selection is a radix select on a 64-bit key per entry: the high word
// the order-preserving bits of the score, the low word the complement of
// the flat index, so a larger key is an earlier serial pick and every key
// is distinct. A node's take is "how many of its entries are >= the key of
// the last entry taken": its usable entries form a prefix whose keys fall
// strictly. No sort or top-k of any library runs.
//
// What bounds it on an H100: latency. An iteration is a chain of dependent
// cross-node steps (normalizers, table, cut, count, selection, stop) over a
// few bytes a node; the table is N * (A + 1) entries of a few dozen f32
// operations. Design: each lane's whole wave loop runs on one persistent
// thread-block cluster of C CTAs of 512 threads (cluster.cuh, C from
// ops/cluster.py `choose`); CTA r owns a node slice and keeps its nodes'
// segment constants, loop state and table rows in shared memory (in its
// slice of global scratch where they do not fit: no N is refused). The
// cross-node values are cluster rounds (wave_cluster.cuh): (1) the six
// normalizers, anyF and the largest capacity; (2) the two largest first
// hidden entries, only where A > 1 (at A = 1 no node has one); (3) the
// usable count, the guarded count, and the smallest and largest usable key;
// the radix select only when fewer than all usable entries are taken, one
// round a byte from the first byte the keys do not share; (4) the end
// normalizers and the best node-exhausting key; the position count only when
// that key is not the first pick; the head only when nothing is taken. Each
// CTA adds its own nodes' takes to their counts.
//
// K3 over lanes (schedule_wave_lanes_kernel, one cluster per lane, then K3c
// over lanes, aggregate_commit.cu) replaces the fan-outs that vmap
// schedule_wave over S lanes, each lane with its own node-active mask: `probe_wave_fanout` (:2302, one group for every
// lane), `serve_wave_fanout` (:2412, a group, replica count and cap1 per
// lane: one K3-lanes launch, then one K3c-lanes launch) and
// `sweep_wave_fanout` (:2447 with `_sweep_wave_step` :2434: a chain of K
// segments per lane, run as K3 then K3c over lanes for each k, 2K launches,
// segment k's carry feeding k+1). Each of a lane's group, m and cap1 is a
// launch argument shared by every lane (the probe) or, where its device
// array is not null, that array's entry for the lane. A lane with m = 0 runs
// no wave iteration and commits nothing. Block and kmax are shared, from
// the largest m: the result does not depend on them, and each lane's
// cluster reduces its own usable depth. See common.cuh `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "common.cuh"
#include "wave_cluster.cuh"

// A lane's stats row (i32): placed, iterations, head fallbacks, guarded
// entries, cluster rounds
#define K3_STATS 5

// K3's per-node rows of a CTA: the table [chunk, B + 1] (rows at stride
// A + 1), then cap, j, u (usable prefix), c0 (first take), feas [chunk] i32
// and the interpod raw, floored Simon input and static terms [chunk] f32.
// They are the first part of its dynamic shared memory when they fit
// (cluster.cuh rows_on_chip), else its slice of scratch.
static __host__ __device__ inline long long k3_rows_bytes(int N, int B, int C) {
  const long long chunk = (N + C - 1) / C;
  return 4LL * chunk * (B + 1 + 8);
}

// The round slots [2][C][RX_WORDS]
static __host__ __device__ inline long long k3_rounds_bytes(int C) {
  return 4LL * 2 * C * RX_WORDS;
}

// K3's dynamic shared memory at C, the one formula of it (ops/cluster.py
// takes it from here), for EXT false and true alike
static __host__ __device__ inline long long k3_smem_bytes(int N, int B, int C) {
  return cluster_smem_bytes(k3_rows_bytes(N, B, C), k3_rounds_bytes(C));
}

// Floats of one lane's scratch: each CTA's per-node rows when they are not
// on chip
static __host__ __device__ inline long long k3_scratch_floats(int N, int B, int C) {
  const long long rows = k3_rows_bytes(N, B, C);
  return rows_on_chip(rows, k3_rounds_bytes(C)) ? 0 : C * rows / 4;
}

// One lane's wave loop on this CTA's cluster. `t_in` is the launch's view
// (lane 0's for the lane kernel, moved to lane s by lane_view); j_out [N] and
// stats [K3_STATS] are the lane's. EXT: the gpu_live instantiation (the
// view's f_gpu), picked by the launcher.
template <bool EXT, bool LANE>
static __device__ __forceinline__ void
schedule_wave_body(const TablesView& t_in, int s, int g, int m, int cap1, int B, int K,
                   int* j_out, int* stats, float* fs) {
  __shared__ TablesView t;
  __shared__ PodCtx pc;
  __shared__ uint64_t s_mbar[2];
  WARP_WORDS(s_rx);  // cta_prologue's warp words, then the rounds'
  __shared__ int s_fin[RX_KEYS + 2];
  __shared__ int s_hist[256];
  __shared__ int s_sel[CLUSTER_WARPS + 3];
  __shared__ u64 s_w64[CLUSTER_WARPS];
  // 4-byte words: a 16-byte alignment would pad the static shared memory
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int C = cluster_ctas(), rank = cluster_rank();
  if (tid == 0) t = LANE ? lane_view(t_in, s) : t_in;
  __syncthreads();
  WARP_BIND(s_rx, t);
  POD_BIND(pc, t);
  const int N = t.N, R = t.R;
  const int chunk = (N + C - 1) / C;
  const long long rows_b = k3_rows_bytes(N, B, C);
  const bool on_chip = rows_on_chip(rows_b, k3_rounds_bytes(C));
  float* tab = on_chip ? (float*)smem : fs + (size_t)rank * (rows_b / 4);
  int* cap_s = (int*)(tab + (size_t)chunk * (B + 1));
  int* j_s = cap_s + chunk;
  int* u_s = j_s + chunk;
  int* c0_s = u_s + chunk;
  int* feas_s = c0_s + chunk;
  float* ip_s = (float*)(feas_s + chunk);
  float* simon_s = ip_s + chunk;
  float* stat_s = simon_s + chunk;
  int* slots = (int*)(smem + (on_chip ? rows_b / 4 : 0));
  Cluster cx = cluster_setup(N, RX_WORDS, slots, s_mbar);
  const int lo = cx.lo, cnt = cx.hi - cx.lo;
  const size_t gN = (size_t)g * N;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];

  // ---- segment constants: base feasibility, capacity, static score terms
  cta_prologue(t, g, true, t.f_spread ? t.Sd : 0, &pc, s_rx);
  for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
    segment_node_constants<EXT, LANE>(t, &pc, g, lo + l, cap1, 1, 1, &feas_s[l], &cap_s[l],
                                      &ip_s[l], &simon_s[l], &stat_s[l]);
    j_s[l] = 0;
  }
  cluster_barrier_uncounted();  // every CTA started: its mbarriers are visible

  int placed = 0, last_w = 1, iters = 0, heads = 0, guarded = 0;
  while (last_w > 0 && placed < m) {
    // ---- round 1: the normalizers over F = base & (copies left > 0), anyF
    // and the largest capacity (0 off the base feasible set)
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float mn_simon = INFINITY, mn_ip = INFINITY;
    int anyF = 0, capmax = 0;
    for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
      capmax = max(capmax, cap_s[l]);
      if (!(feas_s[l] && cap_s[l] - j_s[l] > 0)) continue;
      const int n = lo + l;
      anyF = 1;
      mx[0] = fmaxf(mx[0], simon_s[l]);
      mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
      mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
      mx[3] = fmaxf(mx[3], ip_s[l]);
      mn_simon = fminf(mn_simon, simon_s[l]);
      mn_ip = fminf(mn_ip, ip_s[l]);
    }
    int r1[8] = {okey(mx[0]), okey(mx[1]), okey(mx[2]), okey(mx[3]),
                 okey(mn_simon), okey(mn_ip), anyF, capmax};
    const int op1[8] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MIN, RX_MIN, RX_MAX, RX_MAX};
    cluster_reduce<8>(cx, r1, op1, s_rx, s_fin);
    const bool anyF_b = r1[6];
    const int A = max(1, min(B, r1[7])), S = A + 1;
    const Norms nm = {ounkey(r1[0]), ounkey(r1[4]), fmaxf(ounkey(r1[1]), 0.0f),
                      fmaxf(ounkey(r1[2]), 0.0f), fmaxf(ounkey(r1[3]), 0.0f),
                      fminf(ounkey(r1[5]), 0.0f)};

    // ---- the table at depth A, each node's monotone usable prefix, and its
    // first hidden entry (past depth A or past a rise)
    float b1 = -INFINITY, b2 = -INFINITY;
    int i1 = INT_HI, i2 = INT_HI;
    for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
      const int n = lo + l;
      const int avail = cap_s[l] - j_s[l];
      const bool F = feas_s[l] && avail > 0;
      float simon, nodeaff, taint, interpod;
      normalized_terms(nm, simon_s[l], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_s[l],
                       &simon, &nodeaff, &taint, &interpod);
      const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                             + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + stat_s[l];
      const float jf = (float)j_s[l];
      const float nz_c = t.nonzero[(size_t)n * 2 + 0], nz_m = t.nonzero[(size_t)n * 2 + 1];
      const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
      float* row = tab + (size_t)l * S;
      int first_bad = A;
      float prev = 0.0f;
      for (int k = 0; k <= A; ++k) {
        const float copies = jf + (float)(k + 1);
        float least, bal;
        least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
        const float v = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
        row[k] = v;
        if (k > 0 && k < A && first_bad == A && v > prev) first_bad = k;
        prev = v;
      }
      u_s[l] = F ? min(avail, first_bad) : 0;
      top2_update((F && first_bad < avail) ? row[first_bad] : -INFINITY, n, b1, i1, b2, i2);
    }

    // ---- round 2, the guard: an entry is takeable only if its key beats
    // every OTHER node's first hidden entry; usable prefixes shrink to the
    // beating part. At A = 1 no node has a hidden entry within its capacity.
    int gsum = 0;
    if (A > 1) {
      cluster_top2(cx, b1, i1, b2, i2, s_rx, s_fin);
      for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
        const int n = lo + l;
        const float cut_s = n == i1 ? b2 : b1;
        const int cut_i = n == i1 ? i2 : i1;
        const float* row = tab + (size_t)l * S;
        const int u0 = u_s[l];
        int uu = 0;
        while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
        u_s[l] = uu;
        gsum += u0 - uu;
      }
    }

    // ---- round 3: the usable count, the guarded count and the usable keys'
    // range (the largest exactly; each node's keys fall along its prefix)
    int U = 0, hmin = INT_HI, lmin = INT_HI;
    u64 kmax = 0;
    for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
      const int u = u_s[l];
      if (u == 0) continue;
      const float* row = tab + (size_t)l * S;
      U += u;
      const u64 k0 = entry_key(row[0], lo + l, 0, A), kl = entry_key(row[u - 1], lo + l, u - 1, A);
      if (k0 > kmax) kmax = k0;
      hmin = min(hmin, uokey((uint32_t)(kl >> 32)));
      lmin = min(lmin, uokey((uint32_t)kl));
    }
    int r3[4] = {U, gsum, hmin, lmin};
    const int op3[4] = {RX_SUM, RX_SUM, RX_MIN, RX_MIN};
    cluster_reduce<4, true>(cx, r3, op3, s_rx, s_fin, &kmax, s_w64);
    U = r3[0];
    guarded += r3[1];

    // ---- the first min(m_rem, kmax, U) entries in pick order: all of them,
    // or those at or above the key T of the last
    const int m_rem = m - placed;
    const int m_cand = min(m_rem, min(K, U));
    const bool take_all = m_cand > 0 && m_cand == U;
    u64 T = 0;
    if (m_cand > 0 && !take_all) {
      const u64 kmin = ((u64)uounkey(r3[2]) << 32) | (u64)uounkey(r3[3]);
      const RowSet rs = {tab, S, u_s, lo, cnt, A, A};
      T = cluster_select_key(cx, rs, m_cand, kmin, kmax, s_hist, s_sel, s_rx, s_fin, s_w64);
    }

    // ---- round 4: the normalizers without the nodes the candidates
    // exhaust, and the best node-exhausting candidate
    float e_mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float e_simon = INFINITY, e_ip = INFINITY;
    u64 ex_best = 0;
    for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
      const int n = lo + l;
      const float* row = tab + (size_t)l * S;
      const int u = u_s[l];
      const int c0 = take_all ? u : (m_cand > 0 ? count_at_least(row, n, u, A, T) : 0);
      c0_s[l] = c0;
      const int avail = cap_s[l] - j_s[l];
      if (feas_s[l] && avail > 0 && c0 < max(avail, 1)) {
        e_mx[0] = fmaxf(e_mx[0], simon_s[l]);
        e_mx[1] = fmaxf(e_mx[1], t.nodeaff_raw[gN + n]);
        e_mx[2] = fmaxf(e_mx[2], t.taint_raw[gN + n]);
        e_mx[3] = fmaxf(e_mx[3], ip_s[l]);
        e_simon = fminf(e_simon, simon_s[l]);
        e_ip = fminf(e_ip, ip_s[l]);
      }
      // the entry that empties node n is usable iff its prefix reaches avail
      if (m_cand > 0 && avail >= 1 && u == avail) {
        const u64 kx = entry_key(row[avail - 1], n, avail - 1, A);
        if (kx >= T && kx > ex_best) ex_best = kx;
      }
    }
    int r4[6] = {okey(e_mx[0]), okey(e_mx[1]), okey(e_mx[2]), okey(e_mx[3]), okey(e_simon),
                 okey(e_ip)};
    const int op4[6] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MIN, RX_MIN};
    cluster_reduce<6, true>(cx, r4, op4, s_rx, s_fin, &ex_best, s_w64);
    const bool same = ounkey(r4[0]) == nm.simon_hi && ounkey(r4[4]) == nm.simon_lo
                      && fmaxf(ounkey(r4[1]), 0.0f) == nm.na_max
                      && fmaxf(ounkey(r4[2]), 0.0f) == nm.t_max
                      && fmaxf(ounkey(r4[3]), 0.0f) == nm.ip_max
                      && fminf(ounkey(r4[5]), 0.0f) == nm.ip_min;
    int m_take = m_cand;
    u64 cut = 0;  // 0: take the first m_cand entries (c0_s)
    if (!same && ex_best != 0) {
      // stop right after the first exhausting pick: its position is the
      // number of entries that come before it (none when it is the first)
      int above[1] = {0};
      if (ex_best != kmax) {
        for (int l = tid; l < cnt; l += CLUSTER_THREADS)
          above[0] += count_above(tab + (size_t)l * S, lo + l, u_s[l], A, ex_best);
        const int op[1] = {RX_SUM};
        cluster_reduce<1>(cx, above, op, s_rx, s_fin);
      }
      if (above[0] + 1 < m_cand) {
        m_take = above[0] + 1;
        cut = ex_best;
      }
    }

    // ---- guaranteed progress: serial's next pick is always the best head
    int head = -1;
    if (m_take == 0 && anyF_b && m_rem > 0) {
      float hv = -INFINITY;
      int hi = INT_HI;
      for (int l = tid; l < cnt; l += CLUSTER_THREADS)
        argmax_update((feas_s[l] && cap_s[l] - j_s[l] > 0) ? tab[(size_t)l * S] : -INFINITY,
                      lo + l, &hv, &hi);
      head = cluster_argmax(cx, hv, hi, s_rx, s_fin);
      m_take = 1;
      ++heads;
    }
    for (int l = tid; l < cnt; l += CLUSTER_THREADS) {
      const int n = lo + l;
      j_s[l] += head >= 0 ? (n == head)
                          : (cut ? count_at_least(tab + (size_t)l * S, n, u_s[l], A, cut)
                                 : c0_s[l]);
    }
    placed += m_take;
    last_w = m_take;
    ++iters;
  }
  for (int l = tid; l < cnt; l += CLUSTER_THREADS) j_out[lo + l] = j_s[l];
  if (rank == 0 && tid == 0) {
    stats[0] = placed;
    stats[1] = iters;
    stats[2] = heads;
    stats[3] = guarded;
    stats[4] = cx.rounds;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_wave_kernel(TablesView t, int g, int m, int cap1, int B, int K, int* j, int* stats,
                     float* fs) {
  schedule_wave_body<EXT, false>(t, 0, g, m, cap1, B, K, j, stats, fs);
}

// K3 over lanes: cluster s runs lane s's wave (g, m and cap1, or g_s[s],
// m_s[s] and cap1_s[s] for a non-null array) into its own j row [s, N],
// stats row [s, K3_STATS] and scratch slice.
template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_wave_lanes_kernel(TablesView t, int g, int m, int cap1, const int* g_s, const int* m_s,
                           const uint8_t* cap1_s, int B, int K, int* j, int* stats, float* fs,
                           long long fs_lane) {
  const int s = blockIdx.x / cluster_ctas();
  schedule_wave_body<EXT, true>(t, s, g_s ? g_s[s] : g, m_s ? m_s[s] : m,
                                cap1_s ? (int)cap1_s[s] : cap1, B, K, j + (size_t)s * t.N,
                                stats + K3_STATS * s, fs + s * fs_lane);
}

// ------------------------------------------------------------ C interface --

// ------------------------------------------------------------ C interface --

extern "C" {

// K3's dynamic shared memory at C, and the floats of one lane's scratch, at
// table depth B
long long schedule_wave_smem(int N, int B, int C) { return k3_smem_bytes(N, B, C); }
long long wave_scratch_floats(int N, int B, int C) { return k3_scratch_floats(N, B, C); }

// cluster_kernel_init (cluster.cuh) of K3's four kernels; schedule.cu
// cluster_kernels_init calls it
int wave_cluster_init() {
  cudaError_t e = cluster_kernel_init(schedule_wave_kernel<false>);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_wave_kernel<true>);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_wave_lanes_kernel<false>);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_wave_lanes_kernel<true>);
  return (int)e;
}

static bool k3_cluster_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

// One cluster of C CTAs with `smem` bytes each (schedule_wave_smem; any
// other value is refused). stats [K3_STATS].
int schedule_wave_launch(const TablesView* t, int g, int m, int cap1, int B, int K, int* j,
                         int* stats, float* fs, int C, long long smem, cudaStream_t stream) {
  if (!k3_cluster_size_ok(C) || smem != schedule_wave_smem(t->N, B, C))
    return (int)cudaErrorInvalidValue;
  if (t->f_gpu)
    return cluster_launch(schedule_wave_kernel<true>, C, 1, smem, stream, *t, g, m, cap1, B, K,
                          j, stats, fs);
  return cluster_launch(schedule_wave_kernel<false>, C, 1, smem, stream, *t, g, m, cap1, B, K, j,
                        stats, fs);
}

// S lanes, one cluster of C CTAs each: the view is lane 0's with
// `t->active` the [S, N] mask; g, m and cap1 shared by every lane, save
// where g_s, m_s or cap1_s (device arrays of S entries) is not null; j,
// stats [S, N], [S, K3_STATS]; fs S slices of wave_scratch_floats
int schedule_wave_lanes_launch(const TablesView* t, int g, int m, int cap1, const int* g_s,
                               const int* m_s, const uint8_t* cap1_s, int B, int K, int S, int* j,
                               int* stats, float* fs, int C, long long smem, cudaStream_t stream) {
  if (!k3_cluster_size_ok(C) || smem != schedule_wave_smem(t->N, B, C))
    return (int)cudaErrorInvalidValue;
  const long long fl = wave_scratch_floats(t->N, B, C);
  if (t->f_gpu)
    return cluster_launch(schedule_wave_lanes_kernel<true>, C, S, smem, stream, *t, g, m, cap1,
                          g_s, m_s, cap1_s, B, K, j, stats, fs, fl);
  return cluster_launch(schedule_wave_lanes_kernel<false>, C, S, smem, stream, *t, g, m, cap1,
                        g_s, m_s, cap1_s, B, K, j, stats, fs, fl);
}

// Clusters of C CTAs with `smem` bytes that can be resident at once, into
// *out, for the single-lane (lanes 0) or the lane kernel, EXT or not
int schedule_wave_occupancy(int lanes, int ext, int C, long long smem, int* out) {
  if (!k3_cluster_size_ok(C)) return (int)cudaErrorInvalidValue;
  if (lanes)
    return ext ? cluster_occupancy_of(schedule_wave_lanes_kernel<true>, C, smem, out)
               : cluster_occupancy_of(schedule_wave_lanes_kernel<false>, C, smem, out);
  return ext ? cluster_occupancy_of(schedule_wave_kernel<true>, C, smem, out)
             : cluster_occupancy_of(schedule_wave_kernel<false>, C, smem, out);
}

}  // extern "C"
