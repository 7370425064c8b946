// Hand-written Hopper kernels for the wave's sharded epoch path.
//
// K8 replaces the `shard_map` epoch loop of open_simulator_tpu/ops/kernels.py
//    `schedule_wave` (:1204-1282, `loop_sharded` :1215-1260, the selection
//    `body_tail` :1162-1198) on the partitioned layout (`table_shardings`,
//    `carry_shardings`): every rank of a node mesh holds only its node block
//    [lo, hi) of the tables and the carry; it builds the segment constants
//    and the epoch front on it, the host makes the epoch's two collectives
//    (parallel/collectives.py), and the selection runs on every rank on the
//    gathered full-width rows, so the counts, `placed` and the statistics
//    are equal on every rank and equal to K3's.
//
// Four kernels, one block each, launched by ops/kernels.py
// `schedule_wave_sharded_kernel`:
//   setup  (once per segment, the block): base feasibility, capacity and
//          the static score terms of the block's nodes (K3's segment
//          constants; EXT: the gpu_live branch), j = 0 on every node;
//   front  (per epoch, the block): F = feas & (cap - j > 0) and the masked
//          max of [simon, nodeaff, taint, ip] and of [-simon, -ip] (:1224);
//   -- pmax of those six values over the ranks --
//   table  (per epoch, the block): the normalizers from the reduced vector
//          (:1233), the block's [B+1] score rows (_wave_score_table_rows
//          :904) and the payload row [table; F; min(avail, B+1)] (:1240)
//          with the four normalizer inputs the tail's end normalizers read
//          (simon_s, nodeaff, taint, ip: constant in the segment, carried
//          every epoch so that the epoch keeps its two collectives);
//   -- all_gather of the payload rows, in rank order --
//   tail   (per epoch, full width): body_tail on the gathered rows, read
//          in place (K3's selection, `wave_take` of wave.cuh: the guard,
//          the radix select, the end normalizers, the head fallback, then
//          j += counts), and the loop state. It reads no table.
// The host reads (placed, last) once per epoch to decide on the next.
//
// Exactness across the cut: the payload is f32 (avail clamped to B+1 packs
// exactly, and every comparison against it has a left side <= B); the
// reduced maxima are the unsharded maxima (a max is exact in any order,
// mins ride negated); ties break on the global node index, since the tail
// sees every node at its global position. -0.0 from a negation reaches only
// guarded divisions (normalized_terms divides by a range only where it is
// > 0).
//
// What bounds it on an H100: latency, as K3 (one block per stage), plus the
// two collectives and the host's read per epoch. Overlapping the collectives
// with the table build and dropping the host read is later work.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "common.cuh"
#include "select.cuh"
#include "wave.cuh"
#include "wave_sharded.cuh"

template <bool EXT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_sharded_setup(TablesView t, int g, int cap1, int N, int lo, int hi, int* j, float* fs,
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

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_sharded_front(TablesView t, int g, int B, int N, int lo, int hi, const int* j, float* fs,
                   int* is, float* part) {
  __shared__ float s_red[8 * 32];
  const WaveScratch w = wave_scratch(N, fs, is);
  const size_t gN = (size_t)g * t.N;
  float v6[6] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    if (!(w.feas[n] && w.cap[n] - j[n] > 0)) continue;
    v6[0] = fmaxf(v6[0], w.simon_s[n]);
    v6[1] = fmaxf(v6[1], t.nodeaff_raw[gN + n]);
    v6[2] = fmaxf(v6[2], t.taint_raw[gN + n]);
    v6[3] = fmaxf(v6[3], w.ip[n]);
    v6[4] = fmaxf(v6[4], -w.simon_s[n]);
    v6[5] = fmaxf(v6[5], -w.ip[n]);
  }
  const int op6[6] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX};
  block_reduce<6>(v6, op6, s_red);
  if (threadIdx.x < 6) part[threadIdx.x] = v6[threadIdx.x];
}

// payload row of node n: [table (B+1); F; min(avail, B+1); simon_s;
// nodeaff; taint; ip], P = B + WAVE_PAY_EXTRA floats
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_sharded_table(TablesView t, int g, int B, int N, int lo, int hi, const int* j, float* fs,
                   int* is, const float* red, float* pay) {
  const WaveScratch w = wave_scratch(N, fs, is);
  const int R = t.R, B1 = B + 1, P = B + WAVE_PAY_EXTRA;
  const size_t gN = (size_t)g * t.N;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  const Norms nm = reduced_norms(red);
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    const int avail = w.cap[n] - j[n];
    float simon, nodeaff, taint, interpod;
    normalized_terms(nm, w.simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], w.ip[n],
                     &simon, &nodeaff, &taint, &interpod);
    const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                           + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + w.stat[n];
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
    row[B1] = (w.feas[n] && avail > 0) ? 1.0f : 0.0f;
    row[B1 + 1] = (float)min(avail, B1);
    row[B1 + 2] = w.simon_s[n];
    row[B1 + 3] = t.nodeaff_raw[gN + n];
    row[B1 + 4] = t.taint_raw[gN + n];
    row[B1 + 5] = w.ip[n];
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wave_sharded_tail(TablesView t, int g, int m, int B, int K, int N, int* j, float* fs, int* is,
                  const float* red, const float* full, int* state) {
  __shared__ float s_red[8 * 32];
  __shared__ int s_idx[32];
  __shared__ u64 s_u64[32];
  __shared__ int hist[256];
  __shared__ u64 s_prefix;
  __shared__ int s_rem;
  const int tid = threadIdx.x, bd = blockDim.x, B1 = B + 1, P = B + WAVE_PAY_EXTRA;
  const WaveScratch w = wave_scratch(N, fs, is);
  const Norms nm = reduced_norms(red);
  // the selection's end normalizers read nodeaff and taint of every node:
  // a view whose rows are the gathered ones (group offset 0)
  TablesView tg = t;
  tg.nodeaff_raw = w.nodeaff;
  tg.taint_raw = w.taint;
  const int placed = state[0];

  // ---- the gathered rows: each node's table row, its monotone usable
  // prefix and its first hidden entry (past depth B or past a rise)
  float b1 = -INFINITY;
  int i1 = 0x7fffffff;
  bool anyF = false;
  for (int n = tid; n < N; n += bd) {
    const float* row = full + (size_t)n * P;
    const bool F = row[B1] > 0.0f;
    const int avail = (int)row[B1 + 1];
    int first_bad = B;
    float prev = 0.0f;
    for (int k = 0; k <= B; ++k) {
      const float v = row[k];
      if (k > 0 && k < B && first_bad == B && v > prev) first_bad = k;
      prev = v;
    }
    anyF |= F;
    w.F[n] = F;
    w.avail[n] = avail;
    w.simon_s[n] = row[B1 + 2];
    w.nodeaff[n] = row[B1 + 3];
    w.taint[n] = row[B1 + 4];
    w.ip[n] = row[B1 + 5];
    w.u[n] = F ? min(avail, first_bad) : 0;
    const float bound = (F && first_bad < avail) ? row[first_bad] : -INFINITY;
    w.bound[n] = bound;
    argmax_update(bound, n, &b1, &i1);
  }
  const bool anyF_b = __syncthreads_or(anyF);
  int heads = 0, guarded = 0;
  const WaveNodesGathered nd = {w.F, w.avail};
  const int m_take = wave_take(tg, nd, N, 0, m, placed, K, B, anyF_b, nm, full, P, w.bound,
                               w.simon_s, w.ip, w.u, w.c0, j, b1, i1, s_red, s_idx, s_u64, hist,
                               &s_prefix, &s_rem, heads, guarded);
  if (tid == 0) {
    state[0] = placed + m_take;
    state[1] = m_take;
    state[2] += 1;
    state[3] += heads;
    state[4] += guarded;
  }
}

// ------------------------------------------------------------ C interface --

extern "C" {

// (float scratch, int scratch) sizes of K8 for N nodes (the mesh's), and
// the floats of a node's payload row at depth B
long long wave_sharded_scratch_floats(int N) { return 6LL * N; }
long long wave_sharded_scratch_ints(int N) { return 6LL * N; }
int wave_sharded_pay_floats(int B) { return B + WAVE_PAY_EXTRA; }

// t: the block's view, rebased by lo (wave_sharded.cuh); N: the mesh's nodes
int wave_sharded_setup_launch(const TablesView* t, int g, int cap1, int N, int lo, int hi, int* j,
                              float* fs, int* is, int* state, cudaStream_t stream) {
  if (t->f_gpu)
    wave_sharded_setup<true><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, cap1, N, lo, hi, j, fs, is,
                                                              state);
  else
    wave_sharded_setup<false><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, cap1, N, lo, hi, j, fs, is,
                                                               state);
  return (int)cudaGetLastError();
}

int wave_sharded_front_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                              const int* j, float* fs, int* is, float* part,
                              cudaStream_t stream) {
  wave_sharded_front<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, j, fs, is, part);
  return (int)cudaGetLastError();
}

int wave_sharded_table_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                              const int* j, float* fs, int* is, const float* red, float* pay,
                              cudaStream_t stream) {
  wave_sharded_table<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, j, fs, is, red, pay);
  return (int)cudaGetLastError();
}

int wave_sharded_tail_launch(const TablesView* t, int g, int m, int B, int K, int N, int* j,
                             float* fs, int* is, const float* red, const float* full, int* state,
                             cudaStream_t stream) {
  wave_sharded_tail<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, B, K, N, j, fs, is, red, full,
                                                     state);
  return (int)cudaGetLastError();
}

}  // extern "C"
