// Hand-written Hopper kernels for the wave route.
//
// K3 schedule_wave_kernel replaces open_simulator_tpu/ops/kernels.py
//    `schedule_wave` (:1110/:1113, unsharded path :1273-1283, with
//    _wave_statics :868, _wave_norms :890, _wave_score_table_rows :904,
//    _wave_capacity :945, _wave_gpu_params :956, _gpu_capacity :963 and
//    _wave_candidates_from :1056): places up to m
//    interchangeable pods of one group exactly as m serial steps would, and
//    returns per-node counts.
// K3c aggregate_commit_kernel replaces `_aggregate_commit` (:976): commits
//    those counts into the carry at once; with gpu_live it replays the GPU
//    device ledger copy by copy (:1007-1031).
//
// gpu_live (a shared-GPU group without a pre-assigned gpu-index, the view's
// f_gpu): K3 adds the GPU filter to the base feasibility and clamps each
// node's capacity by floor(sum(units) / max(num, 1)); the scores do not
// move. K3c then replays j[n] copies of the allocator (tightest fit for one
// GPU, in-order units for several) on every node: nodes are independent, so
// one thread per node loops j[n] times over its MAXDEV devices, exactly and
// without atomics.
//
// One K3 iteration builds the [N, B+1] table of the score each node gives
// its next B+1 copies, masks the entries a hidden entry could beat (the
// hidden-continuation guard), takes the best min(m_rem, kmax, usable)
// entries in serial's pick order (score desc, flat index n*B+k asc: the
// order lax.top_k returns), and stops at the first node-exhausting pick when
// the normalizers over the shrunken feasible set differ.
//
// The selection is a radix select (select.cuh) on a 64-bit key per entry:
// the high word is the order-preserving bits of the score, the low word the
// complement of the flat index, so a larger key is an earlier serial pick
// and every key is distinct. Eight 8-bit passes find the key of the r-th
// best usable entry; since each node's usable entries form a prefix whose
// keys fall strictly, a node's take is "how many of its entries are >= that
// key", and the rank of an entry is a count over the keys. No sort or top-k
// of any library runs.
//
// What bounds them on an H100: K3's work per iteration is the N*(B+1) table
// (a few dozen f32 operations per entry) and eight passes over the N*B keys,
// all in one block; the wave loop runs a handful of iterations per segment.
// Design: ONE persistent block of 1,024 threads runs the whole loop (no host
// round trip per iteration); the table lives in device memory (2.7 MB at
// N 10,240, B 64: L2 resident). Spreading the table and the histogram passes
// over the card's 132 SMs is later work. K3c touches the carry once
// ([N, R] rows, [T, D+1] counters) and is launch bound.
//
// K3 and K3c over lanes (schedule_wave_lanes_kernel, one block per lane;
// aggregate_commit_lanes_kernel, the lane on the grid's second dimension)
// replace the fan-outs that vmap schedule_wave over S lanes, each lane with
// its own node-active mask: `probe_wave_fanout` (:2302, one group for every
// lane), `serve_wave_fanout` (:2412, a group, replica count and cap1 per
// lane: one K3-lanes launch, then one K3c-lanes launch) and
// `sweep_wave_fanout` (:2447 with `_sweep_wave_step` :2434: a chain of K
// segments per lane, run as K3 then K3c over lanes for each k, 2K launches,
// segment k's carry feeding k+1). Each of a lane's group, m and cap1 is a
// launch argument shared by every lane (the probe) or, where its device
// array is not null, that array's entry for the lane. A lane with m = 0 runs
// no wave iteration and commits nothing.
// Block and kmax are shared, from the largest m: the result does not depend
// on them. See common.cuh `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "common.cuh"
#include "select.cuh"

// Float scratch: table [N, B+1], then ip_raw, simon_s, static, bound [N] each.
// Int scratch: cap, feas, u (usable prefix length), c0 (first take) [N] each.
// EXT: the gpu_live instantiation (the view's f_gpu), picked by the launcher.
// LANE: the lane kernel's body (the lane's active row folds into the static
// mask); the single-lane kernel runs LANE = false.
template <bool EXT, bool LANE>
static __device__ __forceinline__ void
schedule_wave_body(const TablesView& t, int g, int m, int cap1, int B, int K, int* j, int* stats,
                   float* fs, int* is) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  __shared__ int s_idx[32];
  __shared__ u64 s_u64[32];
  __shared__ int hist[256];
  __shared__ u64 s_prefix;
  __shared__ int s_rem;
  const int N = t.N, R = t.R, tid = threadIdx.x, bd = blockDim.x, B1 = B + 1;
  const size_t gN = (size_t)g * N;
  float* table = fs;
  float* ip_s = table + (size_t)N * B1;
  float* simon_s = ip_s + N;
  float* stat_s = simon_s + N;
  float* bound_s = stat_s + N;
  int* cap_s = is;
  int* feas_s = cap_s + N;
  int* u_s = feas_s + N;
  int* c0_s = u_s + N;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];

  // ---- segment constants: base feasibility, capacity, static score terms
  pod_prologue(t, g, 1, &pc, s_red);
  for (int n = tid; n < N; n += bd) {
    segment_node_constants<EXT, LANE>(t, &pc, g, n, cap1, 1, 1, &feas_s[n], &cap_s[n],
                                      &ip_s[n], &simon_s[n], &stat_s[n]);
    j[n] = 0;
  }
  __syncthreads();

  int placed = 0, last_w = 1, iters = 0, heads = 0, guarded = 0;
  while (last_w > 0 && placed < m) {
    // ---- normalizers over F = base & (copies left > 0)
    float v6[6] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, INFINITY, INFINITY};
    bool anyF = false;
    for (int n = tid; n < N; n += bd) {
      if (!(feas_s[n] && cap_s[n] - j[n] > 0)) continue;
      anyF = true;
      v6[0] = fmaxf(v6[0], simon_s[n]);
      v6[1] = fmaxf(v6[1], t.nodeaff_raw[gN + n]);
      v6[2] = fmaxf(v6[2], t.taint_raw[gN + n]);
      v6[3] = fmaxf(v6[3], ip_s[n]);
      v6[4] = fminf(v6[4], simon_s[n]);
      v6[5] = fminf(v6[5], ip_s[n]);
    }
    const int op6[6] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MIN};
    block_reduce<6>(v6, op6, s_red);
    const bool anyF_b = __syncthreads_or(anyF);
    const Norms nm = {v6[0], v6[4], fmaxf(v6[1], 0.0f), fmaxf(v6[2], 0.0f), fmaxf(v6[3], 0.0f),
                      fminf(v6[5], 0.0f)};

    // ---- the [N, B+1] table, each node's monotone usable prefix, and its
    // first hidden entry (past depth B or past a rise)
    float b1 = -INFINITY;
    int i1 = 0x7fffffff;
    for (int n = tid; n < N; n += bd) {
      const int avail = cap_s[n] - j[n];
      const bool F = feas_s[n] && avail > 0;
      float simon, nodeaff, taint, interpod;
      normalized_terms(nm, simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_s[n],
                       &simon, &nodeaff, &taint, &interpod);
      const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                             + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + stat_s[n];
      const float jf = (float)j[n];
      const float nz_c = t.nonzero[(size_t)n * 2 + 0], nz_m = t.nonzero[(size_t)n * 2 + 1];
      const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
      float* row = table + (size_t)n * B1;
      int first_bad = B;
      float prev = 0.0f;
      for (int k = 0; k <= B; ++k) {
        const float copies = jf + (float)(k + 1);
        float least, bal;
        least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
        const float v = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
        row[k] = v;
        if (k > 0 && k < B && first_bad == B && v > prev) first_bad = k;
        prev = v;
      }
      u_s[n] = F ? min(avail, first_bad) : 0;
      const float bound = (F && first_bad < avail) ? row[first_bad] : -INFINITY;
      bound_s[n] = bound;
      argmax_update(bound, n, &b1, &i1);
    }
    block_argmax(&b1, &i1, s_red, s_idx);
    float b2 = -INFINITY;
    int i2 = 0x7fffffff;
    for (int n = tid; n < N; n += bd) argmax_update(n == i1 ? -INFINITY : bound_s[n], n, &b2, &i2);
    block_argmax(&b2, &i2, s_red, s_idx);

    // ---- the guard: an entry is takeable only if its key beats every OTHER
    // node's first hidden entry; usable prefixes shrink to the beating part
    int U = 0, gsum = 0;
    for (int n = tid; n < N; n += bd) {
      const float cut_s = n == i1 ? b2 : b1;
      const int cut_i = n == i1 ? i2 : i1;
      const float* row = table + (size_t)n * B1;
      const int u0 = u_s[n];
      int uu = 0;
      while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
      u_s[n] = uu;
      U += uu;
      gsum += u0 - uu;
    }
    U = block_sum_int(U, s_idx);
    guarded += block_sum_int(gsum, s_idx);

    // ---- the first min(m_rem, kmax, U) entries in pick order
    const int m_rem = m - placed;
    const int m_cand = min(m_rem, min(K, U));
    const u64 T = m_cand > 0 ? select_key(table, u_s, N, B, m_cand, hist, &s_prefix, &s_rem) : 0;

    // ---- nodes the candidates exhaust, the normalizers without them, and
    // the best node-exhausting candidate
    float e6[6] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, INFINITY, INFINITY};
    u64 ex_best = 0;
    for (int n = tid; n < N; n += bd) {
      const float* row = table + (size_t)n * B1;
      const int c0 = m_cand > 0 ? count_at_least(row, n, u_s[n], B, T) : 0;
      c0_s[n] = c0;
      const int avail = cap_s[n] - j[n];
      if (feas_s[n] && avail > 0 && c0 < max(avail, 1)) {
        e6[0] = fmaxf(e6[0], simon_s[n]);
        e6[1] = fmaxf(e6[1], t.nodeaff_raw[gN + n]);
        e6[2] = fmaxf(e6[2], t.taint_raw[gN + n]);
        e6[3] = fmaxf(e6[3], ip_s[n]);
        e6[4] = fminf(e6[4], simon_s[n]);
        e6[5] = fminf(e6[5], ip_s[n]);
      }
      // the entry that empties node n is usable iff its prefix reaches avail
      if (m_cand > 0 && avail >= 1 && u_s[n] == avail) {
        const u64 kx = entry_key(row[avail - 1], n, avail - 1, B);
        if (kx >= T && kx > ex_best) ex_best = kx;
      }
    }
    block_reduce<6>(e6, op6, s_red);
    ex_best = block_max_u64(ex_best, s_u64);
    const bool same = e6[0] == nm.simon_hi && e6[4] == nm.simon_lo
                      && fmaxf(e6[1], 0.0f) == nm.na_max && fmaxf(e6[2], 0.0f) == nm.t_max
                      && fmaxf(e6[3], 0.0f) == nm.ip_max && fminf(e6[5], 0.0f) == nm.ip_min;
    int m_take = m_cand;
    u64 cut = 0;  // 0: take the first m_cand entries (c0_s)
    if (!same && ex_best != 0) {
      // stop right after the first exhausting pick: its position is the
      // number of entries that come before it
      int above = 0;
      for (int n = tid; n < N; n += bd)
        above += count_above(table + (size_t)n * B1, n, u_s[n], B, ex_best);
      const int p_ex = block_sum_int(above, s_idx);
      if (p_ex + 1 < m_cand) {
        m_take = p_ex + 1;
        cut = ex_best;
      }
    }

    // ---- guaranteed progress: serial's next pick is always the best head
    int head = -1;
    if (m_take == 0 && anyF_b && m_rem > 0) {
      float hv = -INFINITY;
      int hi = 0x7fffffff;
      for (int n = tid; n < N; n += bd) {
        const bool F = feas_s[n] && cap_s[n] - j[n] > 0;
        argmax_update(F ? table[(size_t)n * B1] : -INFINITY, n, &hv, &hi);
      }
      block_argmax(&hv, &hi, s_red, s_idx);
      head = hi;
      m_take = 1;
      ++heads;
    }
    for (int n = tid; n < N; n += bd) {
      const int c = head >= 0 ? (n == head)
                    : (cut ? count_at_least(table + (size_t)n * B1, n, u_s[n], B, cut) : c0_s[n]);
      j[n] += c;
    }
    __syncthreads();
    placed += m_take;
    last_w = m_take;
    ++iters;
  }
  if (tid == 0) {
    stats[0] = placed;
    stats[1] = iters;
    stats[2] = heads;
    stats[3] = guarded;
  }
}

template <bool EXT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_wave_kernel(TablesView t, int g, int m, int cap1, int B, int K, int* j, int* stats,
                     float* fs, int* is) {
  schedule_wave_body<EXT, false>(t, g, m, cap1, B, K, j, stats, fs, is);
}

// K3 over lanes: block s runs lane s's wave (g, m and cap1, or g_s[s],
// m_s[s] and cap1_s[s] for a non-null array) into its own j row [s, N],
// stats row [s, 4] and scratch slices.
template <bool EXT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_wave_lanes_kernel(TablesView t, int g, int m, int cap1, const int* g_s, const int* m_s,
                           const uint8_t* cap1_s, int B, int K, int* j, int* stats, float* fs,
                           int* is, long long fs_lane, long long is_lane) {
  const int s = blockIdx.x;
  LANE_VIEW(lt, t, s)
  schedule_wave_body<EXT, true>(lt, g_s ? g_s[s] : g, m_s ? m_s[s] : m,
                                cap1_s ? (int)cap1_s[s] : cap1, B, K, j + (size_t)s * t.N,
                                stats + 4 * s, fs + s * fs_lane, is + s * is_lane);
}

// ---------------------------------------------------------------- K3c ------

// Commit j[n] copies of group g on every node n into the carry `t` points at.
// seg: [U, D+1] scratch for the per-topology domain sums.
static __device__ __forceinline__ void
aggregate_commit_body(const TablesView& t, int g, const int* j, const int* topo_dom,
                      const int* counter_topo, const int* carr_topo, int U, int gpu_live,
                      float* seg) {
  const int N = t.N, R = t.R, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  for (size_t i = tid; i < (size_t)U * D1; i += bd) seg[i] = 0.0f;
  // requested and nonzero: one multiply, then one add
  for (size_t i = tid; i < (size_t)N * R; i += bd)
    t.requested[i] = t.requested[i] + t.grp_requests[(size_t)g * R + i % R] * (float)j[i / R];
  for (size_t i = tid; i < (size_t)N * 2; i += bd)
    t.nonzero[i] = t.nonzero[i] + t.grp_nonzero[g * 2 + i % 2] * (float)j[i / 2];
  // a placed copy claims the group's host ports on its node (bits set with max)
  for (int n = tid; n < N; n += bd) {
    if (j[n] <= 0) continue;
    for (int k = 0; k < t.PP; ++k) {
      const int pid = t.grp_ports[g * t.PP + k];
      if (pid > 0) t.port_used[(size_t)n * t.PORT1 + pid] = 1;
    }
  }
  __syncthreads();
  // per-topology domain counts: integer sums, exact in any order
  for (size_t i = tid; i < (size_t)U * N; i += bd) {
    const int n = (int)(i % N), d = topo_dom[i];
    if (d < D && j[n] != 0) atomicAdd(&seg[(i / N) * D1 + d], (float)j[n]);
  }
  __syncthreads();
  for (size_t i = tid; i < (size_t)t.T * D1; i += bd) {
    const size_t r = i / D1, d = i % D1;
    t.counter[i] = t.counter[i] + (float)t.counter_sel_match_g[r * t.G + g]
                                  * seg[(size_t)counter_topo[r] * D1 + d];
  }
  for (size_t i = tid; i < (size_t)t.Tc * D1; i += bd) {
    const size_t r = i / D1, d = i % D1;
    t.carrier[i] = t.carrier[i] + t.grp_carries[(size_t)g * t.Tc + r]
                                  * seg[(size_t)carr_topo[r] * D1 + d];
  }
  // the GPU device ledger: j[n] copies of the allocator, one after another
  const float gmem = t.grp_gpu_mem[g];
  if (gpu_live && gmem > 0.0f) {
    const float gnum = fmaxf(t.grp_gpu_num[g], 1.0f), safe_mem = fmaxf(gmem, 1.0f);
    const bool single = t.grp_gpu_num[g] == 1.0f;
    float take[MAX_NODE_DEVS];
    for (int n = tid; n < N; n += bd) {
      float* used = t.dev_used + (size_t)n * t.MAXDEV;
      for (int k = 0; k < j[n]; ++k) {
        gpu_take_at(t, used, n, gmem, gnum, safe_mem, single, take);
        for (int d = 0; d < t.MAXDEV; ++d) used[d] = used[d] + take[d] * gmem;
      }
    }
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
aggregate_commit_kernel(TablesView t, int g, const int* j, const int* topo_dom,
                        const int* counter_topo, const int* carr_topo, int U, int gpu_live,
                        float* seg) {
  aggregate_commit_body(t, g, j, topo_dom, counter_topo, carr_topo, U, gpu_live, seg);
}

// K3c over lanes, the lane on the grid's second dimension: block (0, s)
// commits j row [s, N] of group g (g_s[s] for a non-null g_s) into lane s's
// carry, with its own seg slice.
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
aggregate_commit_lanes_kernel(TablesView t, int g, const int* g_s, const int* j,
                              const int* topo_dom, const int* counter_topo, const int* carr_topo,
                              int U, int gpu_live, float* seg) {
  const int s = blockIdx.y;
  LANE_VIEW(lt, t, s)
  aggregate_commit_body(lt, g_s ? g_s[s] : g, j + (size_t)s * t.N, topo_dom, counter_topo,
                        carr_topo, U, gpu_live, seg + (size_t)s * U * t.D1);
}

// ------------------------------------------------------------ C interface --

extern "C" {

// (float scratch, int scratch) sizes of K3 for N nodes at depth B
long long wave_scratch_floats(int N, int B) { return (long long)N * (B + 1) + 4LL * N; }
long long wave_scratch_ints(int N) { return 4LL * N; }

int schedule_wave_launch(const TablesView* t, int g, int m, int cap1, int B, int K, int* j,
                         int* stats, float* fs, int* is, cudaStream_t stream) {
  if (t->f_gpu)
    schedule_wave_kernel<true><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, cap1, B, K, j, stats,
                                                                fs, is);
  else
    schedule_wave_kernel<false><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, cap1, B, K, j, stats,
                                                                 fs, is);
  return (int)cudaGetLastError();
}

int aggregate_commit_launch(const TablesView* t, int g, const int* j, const int* topo_dom,
                            const int* counter_topo, const int* carr_topo, int U, int gpu_live,
                            float* seg, cudaStream_t stream) {
  aggregate_commit_kernel<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, j, topo_dom, counter_topo,
                                                           carr_topo, U, gpu_live, seg);
  return (int)cudaGetLastError();
}

// S lanes: the view is lane 0's with `t->active` the [S, N] mask; g, m and
// cap1 shared by every lane, save where g_s, m_s or cap1_s (device arrays of
// S entries) is not null; j, stats [S, N], [S, 4]; fs, is S slices of
// wave_scratch_floats / wave_scratch_ints
int schedule_wave_lanes_launch(const TablesView* t, int g, int m, int cap1, const int* g_s,
                               const int* m_s, const uint8_t* cap1_s, int B, int K, int S, int* j,
                               int* stats, float* fs, int* is, cudaStream_t stream) {
  const long long fl = wave_scratch_floats(t->N, B), il = wave_scratch_ints(t->N);
  if (t->f_gpu)
    schedule_wave_lanes_kernel<true><<<S, BLOCK_THREADS, 0, stream>>>(
        *t, g, m, cap1, g_s, m_s, cap1_s, B, K, j, stats, fs, is, fl, il);
  else
    schedule_wave_lanes_kernel<false><<<S, BLOCK_THREADS, 0, stream>>>(
        *t, g, m, cap1, g_s, m_s, cap1_s, B, K, j, stats, fs, is, fl, il);
  return (int)cudaGetLastError();
}

// S lanes of K3c: the view is lane 0's carry of [S, ...] tensors; group g
// for every lane, or g_s[s] where g_s (a device array of S entries) is not
// null; j [S, N]; seg S slices of [U, D+1]
int aggregate_commit_lanes_launch(const TablesView* t, int g, const int* g_s, const int* j,
                                  const int* topo_dom, const int* counter_topo,
                                  const int* carr_topo, int U, int gpu_live, int S, float* seg,
                                  cudaStream_t stream) {
  aggregate_commit_lanes_kernel<<<dim3(1, S), BLOCK_THREADS, 0, stream>>>(
      *t, g, g_s, j, topo_dom, counter_topo, carr_topo, U, gpu_live, seg);
  return (int)cudaGetLastError();
}

}  // extern "C"
