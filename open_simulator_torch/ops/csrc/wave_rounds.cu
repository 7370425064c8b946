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
// Every stage is one thread-block cluster of C CTAs of 512 threads (C from
// ops/cluster.py `choose` over the block's NL nodes), CTA r owning the node
// slice [r * chunk, (r + 1) * chunk) of the block; the cross-node values are
// cluster rounds (wave_cluster.cuh, merge.cuh). The setup and the front are
// K8's too (wave_sharded.cu launches them at its shape), and the table's
// payload rows are K8's table's body (wave_sharded.cuh
// wave_payload_rows). One segment: `setup` once
// (the block's base feasibility, capacity and static score terms; j = 0),
// then per round five launches, four collectives (parallel/collectives.py)
// and one host read, launched by ops/kernels.py `schedule_wave_rounds_kernel`:
//   front    F and the six masked maxima over the block (one round);
//   -- pmax #1 of the six values --
//   table    the normalizers and the block's payload rows [table (B+1); F;
//            min(avail, B+1); K8's four normalizer inputs, which this path
//            does not gather], then each node's usable prefix and first
//            hidden entry; the block's first two maxima of that bound and
//            its best head, as (value, global index), and its feasible
//            count (three rounds);
//   -- all_gather_rows #1 of the summaries, in rank order --
//   select   the guard from the global pairs, then the block's top c =
//            min(K, m - placed, NL*B) usable entries (merge.cuh
//            cluster_block_top: the cluster radix select a round a byte, from
//            the first byte the keys do not share) and their compaction into
//            [c] (key, exhaust) rows in node order at offsets from a cluster
//            scan, 0 keys after the block's own, then (guarded, usable) in
//            row c;
//   -- all_gather_rows #2 of the [c+1] rows --
//   merge    the gathered R*c keys split over the CTAs: the top m_cand =
//            min(m - placed, K, keys) (the cluster radix select on the flat
//            keys); the best node-exhausting key among them and the count
//            above it; each block node's count in the top and the block's
//            six maxima over the nodes the top leaves feasible;
//   -- pmax #2 of those six --
//   finish   (replicated) the end normalizers against the epoch's, the stop
//            at the first exhausting pick, the head fallback from the
//            gathered heads, j += one per gathered key in the take (the keys
//            split over the CTAs), and the loop state (placed, last,
//            iterations, head fallbacks, guarded).
// The host reads (placed, last) once per round to decide on the next.
//
// Exactness against the unsharded selection (K3, `_wave_iteration`):
// - the per-node floats are K8's: the block's rows are the unsharded rows,
//   and the reduced maxima are the unsharded maxima (a max is exact in any
//   order, as order-preserving integer keys (okey) too; mins ride negated:
//   -max(-x) == min(x), +-inf included);
// - ties break on global indices: the bound and head pairs by (value desc,
//   global node asc), the candidates by the distinct 64-bit key of
//   select.cuh with the global flat position n*B+k;
// - the merge sees the same keys as an unsharded select would: the
//   unsharded top min(K, m - placed) holds at most c entries of any block,
//   and each block offers its own top c, so the top of the union of the
//   blocks' tops is the unsharded top; the exhausting key and the count
//   above it lie in that top too. The rows leave each block in node order,
//   CTA by CTA, as the one-block form wrote them;
// - everything else is integers: counts, the guarded sum, j's updates (one
//   integer atomicAdd per taken key, order-free);
// - compiled with --fmad=false; no log or other transcendental is taken
//   here (setup's interpod term keeps common.cuh's f64 log, rounded once).
//
// What bounds it on an H100: latency. A round's stages are short passes
// over the block's NL * (B + 1) table entries and R * c gathered keys; each
// costs a launch, a start and an end cluster barrier and a few rounds, and
// the radix selects one round a byte. Per round the host makes four
// collectives and one read (parallel/collectives.py; moving them onto the
// device is later work).
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

// K10's dynamic shared memory at C: the round slots [2][C][RX_WORDS]
// (wave_sharded.cuh; K8's stages take the same)
static __host__ __device__ inline long long k10_smem_bytes(int C) {
  return wave_stage_smem_bytes(C);
}

template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_rounds_setup(TablesView t, int g, int cap1, int N, int lo, int hi, int* j, float* fs,
                  int* is, int* state) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  POD_BIND(pc, t);
  const int tid = threadIdx.x, C = cluster_ctas(), rank = cluster_rank();
  const WaveScratch w = wave_scratch(N, fs, is);
  int a, b;
  cta_slice(hi - lo, &a, &b);
  pod_prologue(t, g, 1, &pc, s_red);
  for (int n = lo + a + tid; n < lo + b; n += CLUSTER_THREADS)
    segment_node_constants<EXT, false>(t, &pc, g, n, cap1, 1, 1, &w.feas[n], &w.cap[n], &w.ip[n],
                                       &w.simon_s[n], &w.stat[n]);
  for (int n = rank * CLUSTER_THREADS + tid; n < N; n += C * CLUSTER_THREADS) j[n] = 0;
  if (rank == 0 && tid < 5) state[tid] = tid == 1 ? 1 : 0;
}

// F and the masked maxima of [simon, nodeaff, taint, ip, -simon, -ip] over
// the block (K8's front: JAX :1224)
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_rounds_front(TablesView t, int g, int N, int lo, int hi, const int* j, float* fs, int* is,
                  float* part) {
  __shared__ StageShared sh;
  extern __shared__ uint32_t smem[];
  Cluster cx = cluster_stage(hi - lo, RX_WORDS, (int*)smem, sh.mbar);
  const int tid = threadIdx.x;
  const WaveScratch w = wave_scratch(N, fs, is);
  const size_t gN = (size_t)g * t.N;
  float v6[6] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n = lo + cx.lo + tid; n < lo + cx.hi; n += CLUSTER_THREADS) {
    if (!(w.feas[n] && w.cap[n] - j[n] > 0)) continue;
    v6[0] = fmaxf(v6[0], w.simon_s[n]);
    v6[1] = fmaxf(v6[1], t.nodeaff_raw[gN + n]);
    v6[2] = fmaxf(v6[2], t.taint_raw[gN + n]);
    v6[3] = fmaxf(v6[3], w.ip[n]);
    v6[4] = fmaxf(v6[4], -w.simon_s[n]);
    v6[5] = fmaxf(v6[5], -w.ip[n]);
  }
  int r6[6];
  for (int k = 0; k < 6; ++k) r6[k] = okey(v6[k]);
  const int op6[6] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MAX};
  cluster_reduce<6>(cx, r6, op6, sh.rx, sh.fin);
  if (cx.rank == 0 && tid < 6) part[tid] = ounkey(r6[tid]);
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// The block's payload rows (wave_sharded.cuh wave_payload_rows, K8's
// table's body), then its summary row [b1, i1, b2, i2, head, head index,
// feasible count, 0]
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_rounds_table(TablesView t, int g, int B, int N, int lo, int hi, const int* j, float* fs,
                  int* is, const float* red, float* pay, double* summ) {
  __shared__ StageShared sh;
  extern __shared__ uint32_t smem[];
  Cluster cx = cluster_stage(hi - lo, RX_WORDS, (int*)smem, sh.mbar);
  const int tid = threadIdx.x;
  const WaveScratch w = wave_scratch(N, fs, is);
  float b1 = -INFINITY, b2 = -INFINITY, hv = -INFINITY, hv2 = -INFINITY;
  int i1 = INT_HI, i2 = INT_HI, ih = INT_HI, ih2 = INT_HI, nF = 0;
  wave_payload_rows(t, g, B, lo, lo + cx.lo, lo + cx.hi, j, w, reduced_norms(red), pay,
                    [&](int n, const float* row, bool F, int av, int first_bad) {
                      w.F[n] = F;
                      w.avail[n] = av;
                      w.u[n] = F ? min(av, first_bad) : 0;
                      const float bound = (F && first_bad < av) ? row[first_bad] : -INFINITY;
                      w.bound[n] = bound;
                      top2_update(bound, n, b1, i1, b2, i2);
                      top2_update(F ? row[0] : -INFINITY, n, hv, ih, hv2, ih2);
                      nF += F;
                    });
  cluster_top2(cx, b1, i1, b2, i2, sh.rx, sh.fin);
  cluster_top2(cx, hv, ih, hv2, ih2, sh.rx, sh.fin);
  int cnt[1] = {nF};
  const int op[1] = {RX_SUM};
  cluster_reduce<1>(cx, cnt, op, sh.rx, sh.fin);
  if (cx.rank == 0 && tid == 0) {
    summ[0] = b1;
    summ[1] = i1;
    summ[2] = b2;
    summ[3] = i2;
    summ[4] = hv;
    summ[5] = ih;
    summ[6] = cnt[0];
    summ[7] = 0.0;
  }
  cluster_barrier_uncounted();
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_rounds_select(int N, int B, int lo, int hi, int c, int R, float* fs, int* is,
                   const float* pay, const double* summ_all, long long* cand) {
  __shared__ StageShared sh;
  extern __shared__ uint32_t smem[];
  Cluster cx = cluster_stage(hi - lo, RX_WORDS, (int*)smem, sh.mbar);
  const int tid = threadIdx.x, P = B + WAVE_PAY_EXTRA, a = lo + cx.lo;
  const WaveScratch w = wave_scratch(N, fs, is);
  float f1, f2;
  int i1, i2;
  global_pairs(summ_all, R, 8, &f1, &i1, &f2, &i2);
  const RowSet rs = {pay + (size_t)cx.lo * P, P, w.u + a, a, cx.hi - cx.lo, B, B};
  const int* avail = w.avail + a;
  const BlockTop bt = cluster_block_top(cx, rs, w.u + a, w.c0 + a, f1, i1, f2, i2, c, sh,
                                        [&](int slot, int l, int k, u64 key) {
                                          long long* out = cand + (size_t)slot * 2;
                                          out[0] = (long long)key;
                                          out[1] = k == avail[l] - 1;
                                        });
  const int stride = cx.C * CLUSTER_THREADS;
  for (int s = bt.r + cx.rank * CLUSTER_THREADS + tid; s < c; s += stride) {
    cand[(size_t)s * 2] = 0;
    cand[(size_t)s * 2 + 1] = 0;
  }
  if (cx.rank == 0 && tid == 0) {
    cand[(size_t)c * 2] = bt.gsum;
    cand[(size_t)c * 2 + 1] = bt.U;
  }
  cluster_barrier_uncounted();
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_rounds_merge(TablesView t, int g, int m, int K, int B, int N, int lo, int hi, int c, int R,
                  float* fs, int* is, const float* pay, const long long* rows, const int* state,
                  MergeState* ms, float* part) {
  __shared__ StageShared sh;
  extern __shared__ uint32_t smem[];
  Cluster cx = cluster_stage(hi - lo, RX_WORDS, (int*)smem, sh.mbar);
  const int tid = threadIdx.x, P = B + WAVE_PAY_EXTRA;
  const WaveScratch w = wave_scratch(N, fs, is);
  const size_t gN = (size_t)g * t.N;  // the block's rows, rebased
  // this CTA's share of the R*c gathered keys
  const unsigned E = (unsigned)R * (unsigned)c, ec = (E + cx.C - 1) / cx.C;
  const unsigned e0 = min(E, (unsigned)cx.rank * ec), e1 = min(E, e0 + ec);
  const GatheredKeys gk = {rows, c, 2, e0, e1 - e0};

  // ---- the global top: m_cand = min(m - placed, K, keys), its last key T
  // (the smallest key exactly when every key is in it)
  int nk = 0, hmax = INT_LO, lmax = INT_LO;
  u64 ncomp = 0;  // the largest complement of a key: ~ the smallest key
  for (unsigned e = tid; e < gk.n; e += CLUSTER_THREADS) {
    const u64 key = (u64)gk.row(e)[0];
    if (key == 0) continue;
    ++nk;
    hmax = max(hmax, uokey((uint32_t)(key >> 32)));
    lmax = max(lmax, uokey((uint32_t)key));
    if (~key > ncomp) ncomp = ~key;
  }
  int r1[3] = {nk, hmax, lmax};
  const int op1[3] = {RX_SUM, RX_MAX, RX_MAX};
  cluster_reduce<3, true>(cx, r1, op1, sh.rx, sh.fin, &ncomp, sh.w64);
  nk = r1[0];
  const int m_cand = min(m - state[0], min(K, nk));
  u64 T = 0;
  if (m_cand > 0) {
    const u64 kmin = ~ncomp, kmax = ((u64)uounkey(r1[1]) << 32) | (u64)uounkey(r1[2]);
    T = m_cand == nk ? kmin
                     : cluster_select_key(cx, gk, m_cand, kmin, kmax, sh.hist, sh.sel, sh.rx,
                                          sh.fin, sh.w64);
  }

  // ---- the best exhausting key in the top; the block: counts in the top,
  // the maxima over the nodes it leaves feasible
  u64 ex_best = 0;
  if (m_cand > 0) {
    for (unsigned e = tid; e < gk.n; e += CLUSTER_THREADS) {
      const long long* row = gk.row(e);
      const u64 key = (u64)row[0];
      if (row[1] && key >= T && key > ex_best) ex_best = key;
    }
  }
  float e6[6] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n = lo + cx.lo + tid; n < lo + cx.hi; n += CLUSTER_THREADS) {
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
  int r6[6];
  for (int k = 0; k < 6; ++k) r6[k] = okey(e6[k]);
  const int op6[6] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MAX};
  cluster_reduce<6, true>(cx, r6, op6, sh.rx, sh.fin, &ex_best, sh.w64);
  int above[1] = {0};
  if (ex_best != 0) {
    for (unsigned e = tid; e < gk.n; e += CLUSTER_THREADS) above[0] += (u64)gk.row(e)[0] > ex_best;
    const int op[1] = {RX_SUM};
    cluster_reduce<1>(cx, above, op, sh.rx, sh.fin);
  }
  if (cx.rank == 0 && tid < 6) part[tid] = ounkey(r6[tid]);
  if (cx.rank == 0 && tid == 0) *ms = MergeState{T, ex_best, (long long)above[0], (long long)m_cand};
  cluster_barrier_uncounted();
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_rounds_finish(int m, int B, int c, int R, int* j, const float* red, const float* red2,
                   const double* summ_all, const long long* rows, const MergeState* ms,
                   int* state) {
  const int tid = threadIdx.x, C = cluster_ctas(), rank = cluster_rank();
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
    if (rank == 0 && tid == 0) j[head] += 1;
  } else if (m_take > 0) {
    const int total = R * c;
    for (int e = rank * CLUSTER_THREADS + tid; e < total; e += C * CLUSTER_THREADS) {
      const int rk = e / c, sl = e - rk * c;
      const u64 key = (u64)rows[((size_t)rk * (c + 1) + sl) * 2];
      if (key != 0 && key >= cut) atomicAdd(&j[key_node(key, B)], 1);
    }
  }
  cluster_barrier_uncounted();  // every CTA has read state[0]
  if (rank == 0 && tid == 0) {
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

// K10's dynamic shared memory at C (ops/cluster.py takes it from here)
long long wave_rounds_smem(int C) { return k10_smem_bytes(C); }

// cluster_kernel_init (cluster.cuh) of K10's kernels, once per device
int wave_rounds_init() {
  cudaError_t e = cluster_kernel_init(wave_rounds_setup<false>);
  if (e == cudaSuccess) e = cluster_kernel_init(wave_rounds_setup<true>);
  if (e == cudaSuccess) e = cluster_kernel_init(wave_rounds_front);
  if (e == cudaSuccess) e = cluster_kernel_init(wave_rounds_table);
  if (e == cudaSuccess) e = cluster_kernel_init(wave_rounds_select);
  if (e == cudaSuccess) e = cluster_kernel_init(wave_rounds_merge);
  if (e == cudaSuccess) e = cluster_kernel_init(wave_rounds_finish);
  return (int)e;
}

static bool k10_shape_ok(int C, long long smem) {
  return (C == 1 || C == 2 || C == 4 || C == 8 || C == 16) && smem == k10_smem_bytes(C);
}

// Clusters of C CTAs with `smem` bytes of K10's largest stage (the select)
// that can be resident at once, into *out
int wave_rounds_occupancy(int C, long long smem, int* out) {
  if (!k10_shape_ok(C, smem)) return (int)cudaErrorInvalidValue;
  return cluster_occupancy_of(wave_rounds_select, C, smem, out);
}

// Every launch: one cluster of C CTAs, `smem` = wave_rounds_smem(C) (any
// other shape is refused). t: the block's view, rebased by lo
// (wave_sharded.cuh); N: the mesh's nodes.
int wave_rounds_setup_launch(const TablesView* t, int g, int cap1, int N, int lo, int hi, int* j,
                             float* fs, int* is, int* state, int C, long long smem,
                             cudaStream_t stream) {
  if (!k10_shape_ok(C, smem)) return (int)cudaErrorInvalidValue;
  if (t->f_gpu)
    return cluster_launch(wave_rounds_setup<true>, C, 1, 0, stream, *t, g, cap1, N, lo, hi, j, fs,
                          is, state);
  return cluster_launch(wave_rounds_setup<false>, C, 1, 0, stream, *t, g, cap1, N, lo, hi, j, fs,
                        is, state);
}

int wave_rounds_front_launch(const TablesView* t, int g, int N, int lo, int hi, const int* j,
                             float* fs, int* is, float* part, int C, long long smem,
                             cudaStream_t stream) {
  if (!k10_shape_ok(C, smem)) return (int)cudaErrorInvalidValue;
  return cluster_launch(wave_rounds_front, C, 1, smem, stream, *t, g, N, lo, hi, j, fs, is, part);
}

int wave_rounds_table_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                             const int* j, float* fs, int* is, const float* red, float* pay,
                             double* summ, int C, long long smem, cudaStream_t stream) {
  if (!k10_shape_ok(C, smem)) return (int)cudaErrorInvalidValue;
  return cluster_launch(wave_rounds_table, C, 1, smem, stream, *t, g, B, N, lo, hi, j, fs, is,
                        red, pay, summ);
}

int wave_rounds_select_launch(int N, int B, int lo, int hi, int c, int R, float* fs, int* is,
                              const float* pay, const double* summ_all, long long* cand, int C,
                              long long smem, cudaStream_t stream) {
  if (!k10_shape_ok(C, smem)) return (int)cudaErrorInvalidValue;
  return cluster_launch(wave_rounds_select, C, 1, smem, stream, N, B, lo, hi, c, R, fs, is, pay,
                        summ_all, cand);
}

int wave_rounds_merge_launch(const TablesView* t, int g, int m, int K, int B, int N, int lo,
                             int hi, int c, int R, float* fs, int* is, const float* pay,
                             const long long* rows, const int* state, void* ms, float* part,
                             int C, long long smem, cudaStream_t stream) {
  if (!k10_shape_ok(C, smem)) return (int)cudaErrorInvalidValue;
  return cluster_launch(wave_rounds_merge, C, 1, smem, stream, *t, g, m, K, B, N, lo, hi, c, R, fs,
                        is, pay, rows, state, (MergeState*)ms, part);
}

int wave_rounds_finish_launch(int m, int B, int c, int R, int* j, const float* red,
                              const float* red2, const double* summ_all, const long long* rows,
                              const void* ms, int* state, int C, long long smem,
                              cudaStream_t stream) {
  if (!k10_shape_ok(C, smem)) return (int)cudaErrorInvalidValue;
  return cluster_launch(wave_rounds_finish, C, 1, 0, stream, m, B, c, R, j, red, red2, summ_all,
                        rows, (const MergeState*)ms, state);
}

}  // extern "C"
