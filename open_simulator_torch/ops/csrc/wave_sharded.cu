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
// Four stages, each one thread-block cluster of C CTAs of 512 threads
// (cluster.cuh), launched by ops/kernels.py `schedule_wave_sharded_kernel`:
//   setup  (once per segment; a cluster over the block, C from
//          ops/cluster.py `choose` over NL): K10's `wave_rounds_setup<EXT>`
//          itself (wave_rounds.cu): base feasibility, capacity and the
//          static score terms of each CTA's slice (K3's segment constants;
//          EXT: the gpu_live branch), j = 0 on every node;
//   front  (per epoch, the block's cluster): K10's `wave_rounds_front`:
//          F = feas & (cap - j > 0) and the masked max of [simon, nodeaff,
//          taint, ip] and of [-simon, -ip] (:1224), one round;
//   -- pmax of those six values over the ranks --
//   table  (per epoch, the block's cluster, no round): K10's table body
//          (wave_sharded.cuh wave_payload_rows) without its summaries: the
//          normalizers from the reduced vector (:1233), each node's [B+1]
//          score row (_wave_score_table_rows :904) and the payload row
//          [table; F; min(avail, B+1)] (:1240) with the four normalizer
//          inputs the tail's end normalizers read (simon_s, nodeaff,
//          taint, ip: constant in the segment, carried every epoch so that
//          the epoch keeps its two collectives);
//   -- all_gather of the payload rows, in rank order --
//   tail   (per epoch, one cluster over the mesh's N nodes, C from `choose`
//          over N; it reads no table): CTA r reads the gathered rows of its
//          node slice in place at stride P = B + WAVE_PAY_EXTRA, then K3's
//          selection as K3's cluster form runs it (wave.cu): each node's
//          usable prefix and first hidden entry; the two largest bounds
//          (cluster_top2, ties on the global node); the guard; the usable
//          and guarded counts, any feasible node and the usable keys'
//          range (one round); the radix select a round a byte from the
//          first byte the keys do not share (cluster_select_key), only when
//          fewer than all usable entries are taken; the end normalizers
//          over each CTA's slice and the best node-exhausting key (one
//          round); the count above it where it is not the first pick; the
//          head fallback (cluster_argmax, ties on the global node); each CTA
//          adds its nodes' takes to j; CTA 0 writes the loop state.
// The host reads (placed, last) once per epoch to decide on the next.
//
// Exactness across the cut: the payload is f32 (avail clamped to B+1 packs
// exactly, and every comparison against it has a left side <= B); the
// reduced maxima are the unsharded maxima (a max is exact in any order, as
// okey too; mins ride negated); ties break on the global node index, since
// the tail's cluster spans every node at its global position, and the
// candidates' flat order is n * B + k over global nodes (the key of
// select.cuh), the order in which the unsharded K3 and the plain version
// take them; the counts are integers. -0.0 from a negation reaches only
// guarded divisions (normalized_terms divides by a range only where it is
// > 0).
//
// What bounds it on an H100: latency. A stage is a launch, a start and an
// end cluster barrier and a few rounds over one or a few nodes a thread;
// the tail's radix select walks each CTA's N / C * B gathered entries once
// a byte. Per epoch the host makes two collectives and one read (moving
// them onto the device is later work).
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "common.cuh"
#include "merge.cuh"
#include "select.cuh"
#include "wave_sharded.cuh"

// The dynamic shared memory a K8 stage may ask for: its CTAs also hold
// StageShared in static shared memory (ops/cluster.py takes it from
// wave_sharded_smem_max)
#define K8_SMEM_MAX (CLUSTER_SMEM_MAX - 16384)

// payload row of node n: [table (B+1); F; min(avail, B+1); simon_s;
// nodeaff; taint; ip], P = B + WAVE_PAY_EXTRA floats; each CTA its slice
// of the block, no round
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_sharded_table(TablesView t, int g, int B, int N, int lo, int hi, const int* j, float* fs,
                   int* is, const float* red, float* pay) {
  int a, b;
  cta_slice(hi - lo, &a, &b);
  wave_payload_rows(t, g, B, lo, lo + a, lo + b, j, wave_scratch(N, fs, is), reduced_norms(red),
                    pay, [](int, const float*, bool, int, int) {});
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
wave_sharded_tail(TablesView t, int g, int m, int B, int K, int N, int* j, float* fs, int* is,
                  const float* red, const float* full, int* state) {
  __shared__ StageShared sh;
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x, B1 = B + 1, P = B + WAVE_PAY_EXTRA;
  const WaveScratch w = wave_scratch(N, fs, is);
  const Norms nm = reduced_norms(red);
  const int placed = state[0];  // read by every CTA before its first round
  Cluster cx = cluster_stage(N, RX_WORDS, (int*)smem, sh.mbar);
  const int lo = cx.lo, hi = cx.hi;

  // ---- the slice's gathered rows: each node's monotone usable prefix and
  // its first hidden entry (past depth B or past a rise); the two largest
  // of those bounds over the cluster
  float b1 = -INFINITY, b2 = -INFINITY;
  int i1 = INT_HI, i2 = INT_HI, anyF = 0;
  for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
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
    w.u[n] = F ? min(avail, first_bad) : 0;
    top2_update((F && first_bad < avail) ? row[first_bad] : -INFINITY, n, b1, i1, b2, i2);
  }
  cluster_top2(cx, b1, i1, b2, i2, sh.rx, sh.fin);

  // ---- the guard: an entry is takeable only if its key beats every OTHER
  // node's first hidden entry; usable prefixes shrink to the beating part.
  // Then the usable count, the guarded count, any feasible node and the
  // usable keys' range (the largest exactly; each node's keys fall along
  // its prefix)
  int U = 0, gsum = 0, hmin = INT_HI, lmin = INT_HI;
  u64 kmax = 0;
  for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
    const float cut_s = n == i1 ? b2 : b1;
    const int cut_i = n == i1 ? i2 : i1;
    const float* row = full + (size_t)n * P;
    const int u0 = w.u[n];
    int uu = 0;
    while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
    w.u[n] = uu;
    U += uu;
    gsum += u0 - uu;
    if (uu == 0) continue;
    const u64 k0 = entry_key(row[0], n, 0, B), kl = entry_key(row[uu - 1], n, uu - 1, B);
    if (k0 > kmax) kmax = k0;
    hmin = min(hmin, uokey((uint32_t)(kl >> 32)));
    lmin = min(lmin, uokey((uint32_t)kl));
  }
  int r3[5] = {U, gsum, hmin, lmin, anyF};
  const int op3[5] = {RX_SUM, RX_SUM, RX_MIN, RX_MIN, RX_MAX};
  cluster_reduce<5, true>(cx, r3, op3, sh.rx, sh.fin, &kmax, sh.w64);
  U = r3[0];
  const int guarded = r3[1];
  const bool anyF_b = r3[4];

  // ---- the first min(m_rem, kmax, U) entries in pick order: all of them,
  // or those at or above the key T of the last
  const int m_rem = m - placed;
  const int m_cand = min(m_rem, min(K, U));
  const bool take_all = m_cand > 0 && m_cand == U;
  u64 T = 0;
  if (m_cand > 0 && !take_all) {
    const u64 kmin = ((u64)uounkey(r3[2]) << 32) | (u64)uounkey(r3[3]);
    const RowSet rs = {full + (size_t)lo * P, P, w.u + lo, lo, hi - lo, B, B};
    T = cluster_select_key(cx, rs, m_cand, kmin, kmax, sh.hist, sh.sel, sh.rx, sh.fin, sh.w64);
  }

  // ---- the normalizers without the nodes the candidates exhaust, and the
  // best node-exhausting candidate
  float e_mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float e_simon = INFINITY, e_ip = INFINITY;
  u64 ex_best = 0;
  for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
    const float* row = full + (size_t)n * P;
    const int u = w.u[n];
    const int c0 = take_all ? u : (m_cand > 0 ? count_at_least(row, n, u, B, T) : 0);
    w.c0[n] = c0;
    const int avail = (int)row[B1 + 1];
    if (row[B1] > 0.0f && c0 < max(avail, 1)) {
      e_mx[0] = fmaxf(e_mx[0], row[B1 + 2]);
      e_mx[1] = fmaxf(e_mx[1], row[B1 + 3]);
      e_mx[2] = fmaxf(e_mx[2], row[B1 + 4]);
      e_mx[3] = fmaxf(e_mx[3], row[B1 + 5]);
      e_simon = fminf(e_simon, row[B1 + 2]);
      e_ip = fminf(e_ip, row[B1 + 5]);
    }
    // the entry that empties node n is usable iff its prefix reaches avail
    if (m_cand > 0 && avail >= 1 && u == avail) {
      const u64 kx = entry_key(row[avail - 1], n, avail - 1, B);
      if (kx >= T && kx > ex_best) ex_best = kx;
    }
  }
  int r4[6] = {okey(e_mx[0]), okey(e_mx[1]), okey(e_mx[2]), okey(e_mx[3]), okey(e_simon),
               okey(e_ip)};
  const int op4[6] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MIN, RX_MIN};
  cluster_reduce<6, true>(cx, r4, op4, sh.rx, sh.fin, &ex_best, sh.w64);
  const bool same = ounkey(r4[0]) == nm.simon_hi && ounkey(r4[4]) == nm.simon_lo
                    && fmaxf(ounkey(r4[1]), 0.0f) == nm.na_max
                    && fmaxf(ounkey(r4[2]), 0.0f) == nm.t_max
                    && fmaxf(ounkey(r4[3]), 0.0f) == nm.ip_max
                    && fminf(ounkey(r4[5]), 0.0f) == nm.ip_min;
  int m_take = m_cand;
  u64 cut = 0;  // 0: take the first m_cand entries (c0)
  if (!same && ex_best != 0) {
    // stop right after the first exhausting pick: its position is the
    // number of entries that come before it (none when it is the first)
    int above[1] = {0};
    if (ex_best != kmax) {
      for (int n = lo + tid; n < hi; n += CLUSTER_THREADS)
        above[0] += count_above(full + (size_t)n * P, n, w.u[n], B, ex_best);
      const int op[1] = {RX_SUM};
      cluster_reduce<1>(cx, above, op, sh.rx, sh.fin);
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
    int hn = INT_HI;
    for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
      const float* row = full + (size_t)n * P;
      argmax_update(row[B1] > 0.0f ? row[0] : -INFINITY, n, &hv, &hn);
    }
    head = cluster_argmax(cx, hv, hn, sh.rx, sh.fin);
    m_take = 1;
  }
  for (int n = lo + tid; n < hi; n += CLUSTER_THREADS)
    j[n] += head >= 0 ? (n == head)
                      : (cut ? count_at_least(full + (size_t)n * P, n, w.u[n], B, cut)
                             : w.c0[n]);
  if (cx.rank == 0 && tid == 0) {
    state[0] = placed + m_take;
    state[1] = m_take;
    state[2] += 1;
    state[3] += head >= 0;
    state[4] += guarded;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// cluster.cuh cluster_kernel_init with K8's shared-memory bound
template <typename... Params>
static cudaError_t k8_init(void (*kernel)(Params...)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K8_SMEM_MAX);
  return e;
}

// ------------------------------------------------------------ C interface --

static bool k8_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

#define K8_SHAPE_OK                                                                          \
  if (!k8_size_ok(C) || smem != wave_stage_smem_bytes(C) || smem > K8_SMEM_MAX) \
  return (int)cudaErrorInvalidValue

extern "C" {

// (float scratch, int scratch) sizes of K8 for N nodes (the mesh's), and
// the floats of a node's payload row at depth B
long long wave_sharded_scratch_floats(int N) { return 4LL * N; }
long long wave_sharded_scratch_ints(int N) { return 6LL * N; }
int wave_sharded_pay_floats(int B) { return B + WAVE_PAY_EXTRA; }

// The dynamic shared memory of every K8 stage at C (the block's: K10's
// setup and front, K8's table; the tail over N: the same round slots), and
// its bound (ops/cluster.py takes them from here)
long long wave_sharded_smem(int C) { return wave_stage_smem_bytes(C); }
long long wave_sharded_smem_max() { return K8_SMEM_MAX; }

// Allow K8's table and tail clusters of 16 and K8_SMEM_MAX bytes of
// dynamic shared memory, once per device (its setup and front are K10's:
// wave_rounds_init)
int wave_sharded_init() {
  cudaError_t e = k8_init(wave_sharded_table);
  if (e == cudaSuccess) e = k8_init(wave_sharded_tail);
  return (int)e;
}

// Clusters of C CTAs with `smem` bytes of the block stages' (tail 0: K8's
// table) or of the tail (tail 1) that can be resident at once, into *out
int wave_sharded_occupancy(int tail, int C, long long smem, int* out) {
  if (!k8_size_ok(C)) return (int)cudaErrorInvalidValue;
  return tail ? cluster_occupancy_of(wave_sharded_tail, C, smem, out)
              : cluster_occupancy_of(wave_sharded_table, C, smem, out);
}

// t: the block's view, rebased by lo (wave_sharded.cuh); N: the mesh's
// nodes. The table: one cluster of C CTAs over the block, the tail one over
// the N nodes; `smem` = wave_sharded_smem(C) (the table makes no round and
// takes none). Any other shape is refused.
int wave_sharded_table_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                              const int* j, float* fs, int* is, const float* red, float* pay,
                              int C, long long smem, cudaStream_t stream) {
  K8_SHAPE_OK;
  return cluster_launch(wave_sharded_table, C, 1, 0, stream, *t, g, B, N, lo, hi, j, fs, is, red,
                        pay);
}

int wave_sharded_tail_launch(const TablesView* t, int g, int m, int B, int K, int N, int* j,
                             float* fs, int* is, const float* red, const float* full, int* state,
                             int C, long long smem, cudaStream_t stream) {
  K8_SHAPE_OK;
  return cluster_launch(wave_sharded_tail, C, 1, smem, stream, *t, g, m, B, K, N, j, fs, is, red,
                        full, state);
}

}  // extern "C"
