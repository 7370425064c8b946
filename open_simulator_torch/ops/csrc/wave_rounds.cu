// Hand-written Hopper kernels for the wave's per-round sharded path.
//
// K10 replaces the per-round form of open_simulator_tpu/ops/kernels.py
//    `schedule_wave` that the JAX package keeps above
//    OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES (the `else` at :1273-1283, whose
//    `body_tail` :1162-1198 XLA's GSPMD partitions over the node mesh). Rank
//    r of a node mesh of R ranks works on its node block [lo, hi), NL = N /
//    R; every stage reads the tables and the carry only on the block (each
//    rank holds only its block: the partitioned layout of parallel/mesh.py,
//    viewed as wave_sharded.cuh says), and the only full-width arrays are j
//    (the per-node counts, replicated) and the gathered candidates.
//
// One segment: `setup` once (the block's base feasibility, capacity and
// static score terms; j = 0), then per round six launches of one block
// each, four collectives (parallel/collectives.py) and one host read,
// launched by ops/kernels.py `schedule_wave_rounds_kernel`:
//   front    (K8's, the block): F and the six masked maxima;
//   -- pmax #1 of the six values --
//   table    (K8's, the block): the normalizers and the block's payload
//            rows [table (B+1); F; min(avail, B+1); K8's four normalizer
//            inputs, which this path does not gather];
//   summary  (the block): each node's usable prefix and first hidden
//            entry; the block's first two maxima of that bound and its
//            best head, as (value, global index), and its feasible count;
//   -- all_gather_rows #1 of the summaries, in rank order --
//   select   (the block): the guard from the global pairs, then the radix
//            select of the block's top c = min(K, m - placed, NL*B) usable
//            entries and their compaction into [c] (key, exhaust) rows, 0
//            keys after the block's own, then (guarded, usable) in row c;
//   -- all_gather_rows #2 of the [c+1] rows --
//   merge    (the gathered rows, then the block): the radix select of the
//            top m_cand = min(m - placed, K, keys) of the R*c keys; the
//            best node-exhausting key among them and the count above it;
//            each block node's count in the top and the block's six
//            maxima over the nodes the top leaves feasible;
//   -- pmax #2 of those six --
//   finish   (replicated): the end normalizers against the epoch's, the
//            stop at the first exhausting pick, the head fallback from the
//            gathered heads, j += one per gathered key in the take, and the
//            loop state (placed, last, iterations, head fallbacks, guarded).
// The host reads (placed, last) once per round to decide on the next.
//
// Exactness against the unsharded selection (K3, `_wave_iteration`):
// - the per-node floats are K8's: the block's rows are the unsharded rows,
//   and the reduced maxima are the unsharded maxima (a max is exact in any
//   order, mins ride negated: -max(-x) == min(x), +-inf included);
// - ties break on global indices: the bound and head pairs by (value desc,
//   global node asc), the candidates by the distinct 64-bit key of
//   select.cuh with the global flat position n*B+k; the block's select runs
//   on local keys, whose order is the global keys' (a constant offset of
//   the flat position), and emits global keys;
// - the merge sees the same keys as an unsharded select would: the
//   unsharded top min(K, m - placed) holds at most c entries of any block,
//   and each block offers its own top c, so the top of the union of the
//   blocks' tops is the unsharded top; the exhausting key and the count
//   above it lie in that top too;
// - everything else is integers: counts, the guarded sum, j's updates (one
//   integer atomicAdd per taken key, order-free);
// - compiled with --fmad=false; no log or other transcendental is taken
//   here (setup's interpod term keeps common.cuh's f64 log, rounded once).
//
// What bounds it on an H100: latency. Each stage is one block of 1,024
// threads; the block's radix select makes 8 passes over its NL*B entries
// and the merge's 8 passes over R*c keys, on one SM each. Per round the host
// makes four collectives and one read. A multi-block select and the
// gathers overlapped with the table build are later work.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "common.cuh"
#include "merge.cuh"
#include "select.cuh"
#include "wave_sharded.cuh"

// the per-round merge state: the m_cand-th key, the best exhausting key in
// the top, the count of keys above it, m_cand
struct MergeState {
  u64 T, ex_best;
  long long p_ex, m_cand;
};

template <bool EXT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_rounds_setup(TablesView t, int g, int cap1, int N, int lo, int hi, int* j, float* fs,
                  int* is, int* state) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  const WaveScratch w = wave_scratch(N, fs, is);
  pod_prologue(t, g, 1, &pc, s_red);
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x)
    segment_node_constants<EXT, false>(t, &pc, g, n, cap1, 1, 1, &w.feas[n], &w.cap[n], &w.ip[n],
                                       &w.simon_s[n], &w.stat[n]);
  for (int n = threadIdx.x; n < N; n += blockDim.x) j[n] = 0;
  if (threadIdx.x < 5) state[threadIdx.x] = threadIdx.x == 1 ? 1 : 0;
}

// summary row: [b1, i1, b2, i2, head, head index, feasible count, 0]
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_rounds_summary(int N, int B, int lo, int hi, float* fs, int* is, const float* pay,
                    double* summ) {
  __shared__ float s_red[8 * 32];
  __shared__ int s_idx[32];
  const int tid = threadIdx.x, bd = blockDim.x, B1 = B + 1, P = B + WAVE_PAY_EXTRA;
  const WaveScratch w = wave_scratch(N, fs, is);
  float b1 = -INFINITY, hv = -INFINITY;
  int i1 = 0x7fffffff, ih = 0x7fffffff, nF = 0;
  for (int n = lo + tid; n < hi; n += bd) {
    const float* row = pay + (size_t)(n - lo) * P;
    const bool F = row[B1] > 0.0f;
    const int avail = (int)row[B1 + 1];
    int first_bad = B;
    float prev = 0.0f;
    for (int k = 0; k <= B; ++k) {
      const float v = row[k];
      if (k > 0 && k < B && first_bad == B && v > prev) first_bad = k;
      prev = v;
    }
    w.F[n] = F;
    w.avail[n] = avail;
    w.u[n] = F ? min(avail, first_bad) : 0;
    const float bound = (F && first_bad < avail) ? row[first_bad] : -INFINITY;
    w.bound[n] = bound;
    argmax_update(bound, n, &b1, &i1);
    argmax_update(F ? row[0] : -INFINITY, n, &hv, &ih);
    nF += F;
  }
  block_argmax(&b1, &i1, s_red, s_idx);
  float b2 = -INFINITY;
  int i2 = 0x7fffffff;
  for (int n = lo + tid; n < hi; n += bd) argmax_update(n == i1 ? -INFINITY : w.bound[n], n, &b2, &i2);
  block_argmax(&b2, &i2, s_red, s_idx);
  block_argmax(&hv, &ih, s_red, s_idx);
  nF = block_sum_int(nF, s_idx);
  if (tid == 0) {
    summ[0] = b1;
    summ[1] = i1;
    summ[2] = b2;
    summ[3] = i2;
    summ[4] = hv;
    summ[5] = ih;
    summ[6] = nF;
    summ[7] = 0.0;
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_rounds_select(int N, int B, int lo, int hi, int c, int R, float* fs, int* is,
                   const float* pay, const double* summ_all, long long* cand) {
  __shared__ int s_idx[32];
  __shared__ int hist[256];
  __shared__ u64 s_prefix;
  __shared__ int s_rem;
  const int tid = threadIdx.x, bd = blockDim.x, P = B + WAVE_PAY_EXTRA, NL = hi - lo;
  const WaveScratch w = wave_scratch(N, fs, is);

  // ---- the global pairs: the best block first, then the best of the other
  // blocks' firsts and the winner's second
  int win = 0;
  double b1 = summ_all[0], g1 = summ_all[1];
  for (int r = 1; r < R; ++r) {
    const double v = summ_all[r * 8], i = summ_all[r * 8 + 1];
    if (v > b1 || (v == b1 && i < g1)) {
      b1 = v;
      g1 = i;
      win = r;
    }
  }
  double b2 = summ_all[win * 8 + 2], g2 = summ_all[win * 8 + 3];
  for (int r = 0; r < R; ++r)
    if (r != win) pair_update(summ_all[r * 8], summ_all[r * 8 + 1], &b2, &g2);
  const float f1 = (float)b1, f2 = (float)b2;
  const int i1 = (int)g1, i2 = (int)g2;

  // ---- the guard on the block
  int U = 0, gsum = 0;
  for (int n = lo + tid; n < hi; n += bd) {
    const float cut_s = n == i1 ? f2 : f1;
    const int cut_i = n == i1 ? i2 : i1;
    const float* row = pay + (size_t)(n - lo) * P;
    const int u0 = w.u[n];
    int uu = 0;
    while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
    w.u[n] = uu;
    U += uu;
    gsum += u0 - uu;
  }
  U = block_sum_int(U, s_idx);
  gsum = block_sum_int(gsum, s_idx);

  // ---- the block's top r = min(c, U) on local keys, emitted as global keys
  const int r = min(c, U);
  const u64 T = r > 0 ? select_key(pay, P, w.u + lo, NL, B, r, hist, &s_prefix, &s_rem) : 0;
  int base = 0;
  for (int n0 = 0; n0 < NL; n0 += bd) {  // uniform trip count: every thread scans
    const int nl = n0 + tid;
    const float* row = pay + (size_t)nl * P;
    const int cnt = (r > 0 && nl < NL) ? count_at_least(row, nl, w.u[lo + nl], B, T) : 0;
    int total;
    const int off = base + block_exclusive_scan(cnt, s_idx, &total);
    for (int k = 0; k < cnt; ++k) {
      long long* out = cand + (size_t)(off + k) * 2;
      out[0] = (long long)entry_key(row[k], lo + nl, k, B);
      out[1] = k == w.avail[lo + nl] - 1;
    }
    base += total;
  }
  for (int s = r + tid; s < c; s += bd) {
    cand[(size_t)s * 2] = 0;
    cand[(size_t)s * 2 + 1] = 0;
  }
  if (tid == 0) {
    cand[(size_t)c * 2] = gsum;
    cand[(size_t)c * 2 + 1] = U;
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_rounds_merge(TablesView t, int g, int m, int K, int B, int N, int lo, int hi, int c, int R,
                  float* fs, int* is, const float* pay, const long long* rows, const int* state,
                  MergeState* ms, float* part) {
  __shared__ float s_red[8 * 32];
  __shared__ int s_idx[32];
  __shared__ u64 s_u64[32];
  __shared__ int hist[256];
  __shared__ u64 s_prefix;
  __shared__ int s_rem;
  const int tid = threadIdx.x, bd = blockDim.x, P = B + WAVE_PAY_EXTRA;
  const WaveScratch w = wave_scratch(N, fs, is);
  const size_t gN = (size_t)g * t.N;  // the block's rows, rebased
  const int total = R * c;

  // ---- the global top: m_cand = min(m - placed, K, keys)
  int nk = 0;
  for (int e = tid; e < total; e += bd) {
    const int rk = e / c, s = e - rk * c;
    nk += rows[((size_t)rk * (c + 1) + s) * 2] != 0;
  }
  nk = block_sum_int(nk, s_idx);
  const int m_cand = min(m - state[0], min(K, nk));
  const u64 T = m_cand > 0 ? select_gathered(rows, R, c, m_cand, hist, &s_prefix, &s_rem) : 0;
  u64 ex_best = 0;
  if (m_cand > 0) {
    for (int e = tid; e < total; e += bd) {
      const int rk = e / c, s = e - rk * c;
      const long long* row = rows + ((size_t)rk * (c + 1) + s) * 2;
      const u64 key = (u64)row[0];
      if (row[1] && key >= T && key > ex_best) ex_best = key;
    }
  }
  ex_best = block_max_u64(ex_best, s_u64);
  int above = 0;
  if (ex_best != 0) {
    for (int e = tid; e < total; e += bd) {
      const int rk = e / c, s = e - rk * c;
      above += (u64)rows[((size_t)rk * (c + 1) + s) * 2] > ex_best;
    }
  }
  above = block_sum_int(above, s_idx);

  // ---- the block: counts in the top, the maxima over the nodes it leaves
  float e6[6] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n = lo + tid; n < hi; n += bd) {
    const float* row = pay + (size_t)(n - lo) * P;
    const int c0 = m_cand > 0 ? count_at_least(row, n, w.u[n], B, T) : 0;
    const int avail = w.avail[n];
    if (w.F[n] && c0 < max(avail, 1)) {
      e6[0] = fmaxf(e6[0], w.simon_s[n]);
      e6[1] = fmaxf(e6[1], t.nodeaff_raw[gN + n]);
      e6[2] = fmaxf(e6[2], t.taint_raw[gN + n]);
      e6[3] = fmaxf(e6[3], w.ip[n]);
      e6[4] = fmaxf(e6[4], -w.simon_s[n]);
      e6[5] = fmaxf(e6[5], -w.ip[n]);
    }
  }
  const int op6[6] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX};
  block_reduce<6>(e6, op6, s_red);
  if (tid < 6) part[tid] = e6[tid];
  if (tid == 0) *ms = MergeState{T, ex_best, (long long)above, (long long)m_cand};
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_rounds_finish(int m, int B, int c, int R, int* j, const float* red, const float* red2,
                   const double* summ_all, const long long* rows, const MergeState* ms,
                   int* state) {
  const int tid = threadIdx.x, bd = blockDim.x;
  const Norms a = reduced_norms(red), b = reduced_norms(red2);
  const bool same = a.simon_hi == b.simon_hi && a.simon_lo == b.simon_lo && a.na_max == b.na_max
                    && a.t_max == b.t_max && a.ip_max == b.ip_max && a.ip_min == b.ip_min;
  const MergeState s = *ms;
  const int placed = state[0], m_rem = m - placed, m_cand = (int)s.m_cand;
  int m_take = m_cand;
  u64 cut = s.T;
  if (!same && s.ex_best != 0 && s.p_ex + 1 < m_cand) {
    m_take = (int)s.p_ex + 1;
    cut = s.ex_best;
  }
  int head = -1;
  if (m_take == 0 && m_rem > 0) {
    double hv = -INFINITY, hi = 2147483647.0, nF = 0.0;
    for (int r = 0; r < R; ++r) {
      pair_update(summ_all[r * 8 + 4], summ_all[r * 8 + 5], &hv, &hi);
      nF += summ_all[r * 8 + 6];
    }
    if (nF > 0.0) {
      head = (int)hi;
      m_take = 1;
    }
  }
  if (head >= 0) {
    if (tid == 0) j[head] += 1;
  } else if (m_take > 0) {
    const int total = R * c;
    for (int e = tid; e < total; e += bd) {
      const int rk = e / c, sl = e - rk * c;
      const u64 key = (u64)rows[((size_t)rk * (c + 1) + sl) * 2];
      if (key != 0 && key >= cut) atomicAdd(&j[key_node(key, B)], 1);
    }
  }
  __syncthreads();  // every thread has read state[0]
  if (tid == 0) {
    long long guarded = 0;
    for (int r = 0; r < R; ++r) guarded += rows[((size_t)r * (c + 1) + c) * 2];
    state[0] = placed + m_take;
    state[1] = m_take;
    state[2] += 1;
    state[3] += head >= 0;
    state[4] += (int)guarded;
  }
}

// ------------------------------------------------------------ C interface --

extern "C" {

long long wave_rounds_merge_state_bytes() { return (long long)sizeof(MergeState); }

// t: the block's view, rebased by lo (wave_sharded.cuh); N: the mesh's nodes
int wave_rounds_setup_launch(const TablesView* t, int g, int cap1, int N, int lo, int hi, int* j,
                             float* fs, int* is, int* state, cudaStream_t stream) {
  if (t->f_gpu)
    wave_rounds_setup<true><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, cap1, N, lo, hi, j, fs, is,
                                                             state);
  else
    wave_rounds_setup<false><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, cap1, N, lo, hi, j, fs, is,
                                                              state);
  return (int)cudaGetLastError();
}

int wave_rounds_summary_launch(int N, int B, int lo, int hi, float* fs, int* is,
                               const float* pay, double* summ, cudaStream_t stream) {
  wave_rounds_summary<<<1, BLOCK_THREADS, 0, stream>>>(N, B, lo, hi, fs, is, pay, summ);
  return (int)cudaGetLastError();
}

int wave_rounds_select_launch(int N, int B, int lo, int hi, int c, int R, float* fs, int* is,
                              const float* pay, const double* summ_all, long long* cand,
                              cudaStream_t stream) {
  wave_rounds_select<<<1, BLOCK_THREADS, 0, stream>>>(N, B, lo, hi, c, R, fs, is, pay,
                                                      summ_all, cand);
  return (int)cudaGetLastError();
}

int wave_rounds_merge_launch(const TablesView* t, int g, int m, int K, int B, int N, int lo,
                             int hi, int c, int R, float* fs, int* is, const float* pay,
                             const long long* rows, const int* state, void* ms, float* part,
                             cudaStream_t stream) {
  wave_rounds_merge<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, K, B, N, lo, hi, c, R, fs, is,
                                                     pay, rows, state, (MergeState*)ms, part);
  return (int)cudaGetLastError();
}

int wave_rounds_finish_launch(int m, int B, int c, int R, int* j, const float* red,
                              const float* red2, const double* summ_all, const long long* rows,
                              const void* ms, int* state, cudaStream_t stream) {
  wave_rounds_finish<<<1, BLOCK_THREADS, 0, stream>>>(m, B, c, R, j, red, red2, summ_all, rows,
                                                      (const MergeState*)ms, state);
  return (int)cudaGetLastError();
}

}  // extern "C"
