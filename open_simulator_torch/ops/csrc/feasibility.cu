// Hand-written Hopper kernel for the serial route's diagnostics.
//
// K1 feasibility_kernel replaces open_simulator_tpu/ops/kernels.py
//    `feasibility_jit` (:743, wrapping `feasibility` :379): one pod group's [N]
//    feasible mask, the per-stage masks and fit_each, with the GPU-share and
//    Open-Local stages when the view's flags are on.
//
// Design: ONE launch of one thread-block cluster of C CTAs of
// CLUSTER_THREADS threads over the N nodes (C from ops/cluster.py `choose`
// over N items, 3N with EXT, cached per shape), CTA r owning the node slice
// [r * chunk, (r + 1) * chunk), in three steps:
// - A, the prologue split over the CTAs' domain shares (k1_prologue): each
//   CTA scans only its share of the D+1 domain columns, for every valid
//   DoNotSchedule term the minimum of its counter row over the eligible
//   domains, carried as the maximum of its negation (okey: a share without
//   an eligible domain pushes -inf, which merges as nothing), and for
//   required self-affinity whether any of the A counter rows is nonzero in
//   the share (the sentinel column excluded; a maximum of 0 / 1). After one
//   cluster barrier, ONE cluster round (merge.cuh cluster_row_round) merges
//   them, so every CTA holds pod_prologue's PodCtx: a term without an
//   eligible domain, or with id < 0, gets 0. A pod with neither makes no
//   cluster-wide step. (pod_prologue scanned all D+1 columns in every CTA:
//   the whole [Sd, N] rows a CTA on a hostname topology.)
// - B, the nodes: each CTA walks its slice in passes, node_feasibility
//   unchanged. Without EXT, one thread a node (K1_PASS a pass). With EXT, a
//   node's three independent checks run on three threads at once (five
//   warps a role, K1_PASS_EXT nodes a pass): the base filters
//   (node_feasibility<false>), gpu_ok_at and storage_alloc_at with the null
//   outputs the base path passes it. After a CTA barrier they combine
//   through shared memory: the ST_GPU and ST_STORAGE bits are the two
//   checks, the feasible bit is the base's AND both, then `valid` and
//   `forced` once. So a node's chain is the longest of the three, not
//   their sum.
// - C, ONE packed output, [1 + N_STAGES + R, N] uint8 (ops/kernels.py
//   `unpack_feasibility`): row 0 the feasible mask, the stage bits in
//   STAGE_ROWS order, then fit_each transposed ([R, N]). A pass keeps its
//   nodes' bits and [pass, R] fit bytes in shared memory, and the CTA writes
//   them out row by row, neighbouring threads on neighbouring nodes.
//
// What bounds it on an H100: bytes, a few [N] rows read (with a hostname
// topology also the [Sd, D+1] counter and eligible rows, now read once over
// the cluster) and 13 + R bytes a node written: hundreds of kilobytes, far
// below a launch's latency spread over C SMs. A call is launch bound; the
// design takes the repeated prologue and the EXT chain out of it.
//
// The exactness contract with the plain PyTorch version is in common.cuh
// (the minima exact in any grouping: okey keeps every float bit for bit).

#include "common.cuh"
#include "merge.cuh"

// nodes a pass of one CTA: one a thread; with EXT, five warps a role
#define K1_PASS CLUSTER_THREADS
#define K1_PASS_EXT (5 * 32)

// The dynamic shared memory K1 may ask for: its CTAs also hold PodCtx and
// the mbarriers in static shared memory (ops/cluster.py takes it from
// feasibility_smem_max)
#define K1_SMEM_MAX (CLUSTER_SMEM_MAX - 16384)

// The prologue round's words: the Sd negated minima, then the flag
static __host__ __device__ inline int k1_words(const TablesView& t) { return t.Sd + 1; }

static __host__ __device__ inline int k1_pass(bool ext) { return ext ? K1_PASS_EXT : K1_PASS; }

// K1's dynamic shared memory at C: the round slots [2][C][W], fin [W] and
// the CTA's row [W] (i32), a pass's stage bits [pass] (u32), its fit_each
// bytes [pass, R] and with EXT its GPU and storage checks [2][pass] (u8)
static __host__ __device__ inline long long k1_smem_bytes(const TablesView& t, int C, bool ext) {
  const long long W = k1_words(t), P = k1_pass(ext);
  return 4LL * (2 * C * W + 2 * W) + 4 * P + P * t.R + (ext ? 2 * P : 0);
}

// pod_prologue's PodCtx on a cluster: each CTA over its share of the D+1
// domain columns, merged in ONE round after a cluster barrier (neither
// when the pod has no DoNotSchedule term to evaluate and no required
// self-affinity: the kernel then makes no cluster-wide step at all). Every
// thread of every CTA calls it (the control flow depends on g and the view
// only); `cx` comes from cluster_setup; acc and fin hold W words of this
// CTA's shared memory. Ends with a CTA barrier.
static __device__ void k1_prologue(const TablesView& t, int g, int include_dns, Cluster& cx,
                                   PodCtx* pc, int* acc, int* fin) {
  const int D1 = t.D1, D = D1 - 1, Sd = t.Sd, tid = threadIdx.x, lane = tid & 31;
  const bool dns = t.f_spread && include_dns;
  bool has_aff = false;
  if (t.f_interpod && t.grp_aff_self[g])
    for (int a = 0; a < t.A; ++a) has_aff = has_aff || t.req_aff_t[g * t.A + a] >= 0;
  if (!dns && !has_aff) {
    if (tid == 0) pc->bootstrap = 0;
    __syncthreads();
    return;
  }
  const int W = k1_words(t);
  // every CTA started, its mbarriers visible, before the round's pushes
  cluster_barrier_uncounted();
  for (int k = tid; k < W; k += CLUSTER_THREADS) acc[k] = k < Sd ? okey(-INFINITY) : 0;
  __syncthreads();
  const int dc = (D1 + cx.C - 1) / cx.C, d0 = min(D1, cx.rank * dc), d1 = min(D1, d0 + dc);
  if (dns) {
    for (int s = 0; s < Sd; ++s) {
      const int id = t.dns_t[g * Sd + s];
      if (id < 0) continue;
      const float* row = t.counter + (size_t)id * D1;
      const uint8_t* edom = t.dns_edom + ((size_t)g * Sd + s) * D1;
      float mn = INFINITY;
      for (int d = d0 + tid; d < d1; d += CLUSTER_THREADS)
        if (edom[d]) mn = fminf(mn, row[d]);
      const int r = __reduce_max_sync(FULL_MASK, okey(-mn));
      if (lane == 0) atomicMax(&acc[s], r);
    }
  }
  if (has_aff) {
    // counters are non-negative counts, so sum == 0 iff every entry is 0
    int nz = 0;
    for (int a = 0; a < t.A; ++a) {
      const int id = t.req_aff_t[g * t.A + a];
      if (id < 0) continue;
      const float* row = t.counter + (size_t)id * D1;
      for (int d = d0 + tid; d < min(d1, D); d += CLUSTER_THREADS)
        if (row[d] != 0.0f) nz = 1;
    }
    if (__any_sync(FULL_MASK, nz) && lane == 0) atomicMax(&acc[Sd], 1);
  }
  __syncthreads();
  cluster_row_round(cx, acc, W, W, fin);
  if (dns)
    for (int s = tid; s < Sd; s += CLUSTER_THREADS) {
      const float m = -ounkey(fin[s]);
      pc->dns_min[s] = (t.dns_t[g * Sd + s] >= 0 && isfinite(m)) ? m : 0.0f;
    }
  if (tid == 0) pc->bootstrap = has_aff && !fin[Sd];
  __syncthreads();
}

// ----------------------------------------------------------------- K1 ------

// out: [1 + N_STAGES + R, N] uint8
template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
feasibility_kernel(TablesView t, int g, int forced, int valid, int include_dns, uint8_t* out) {
  __shared__ PodCtx pc;
  __shared__ __align__(8) uint64_t mbar[2];
  extern __shared__ __align__(16) uint32_t smem[];
  POD_BIND(pc, t);
  const int N = t.N, R = t.R, tid = threadIdx.x, W = k1_words(t), P = k1_pass(EXT);
  Cluster cx = cluster_setup(N, W, (int*)smem, mbar);
  int* fin = (int*)smem + 2 * cx.C * W;
  int* acc = fin + W;                                // the CTA's row
  uint32_t* s_bits = (uint32_t*)(acc + W);           // [P] the stage bits
  uint8_t* s_fit = (uint8_t*)(s_bits + P);           // [P, R] fit_each
  uint8_t* s_chk = s_fit + (size_t)P * R;            // EXT: [2][P] gpu, storage
  k1_prologue(t, g, include_dns, cx, &pc, acc, fin);
  const int rows = 1 + N_STAGES + R;
  for (int n0 = cx.lo; n0 < cx.hi; n0 += P) {  // uniform trips: every thread meets the barriers
    const int np = min(P, cx.hi - n0);
    if (!EXT) {
      if (tid < np)
        s_bits[tid] = node_feasibility<false>(t, &pc, g, forced, valid, include_dns, 1, n0 + tid,
                                              s_fit + (size_t)tid * R);
    } else {
      const int role = tid / P, i = tid % P, n = n0 + i;
      if (role == 0 && i < np)
        s_bits[i] = node_feasibility<false>(t, &pc, g, -1, 1, include_dns, 1, n,
                                            s_fit + (size_t)i * R);
      else if (role == 1 && i < np)
        s_chk[i] = t.f_gpu ? gpu_ok_at(t, g, n) : 1;
      else if (role == 2 && i < np)
        s_chk[P + i] = t.f_storage ? storage_alloc_at(t, g, n, nullptr, nullptr, nullptr) : 1;
    }
    __syncthreads();
    for (int e = tid; e < rows * np; e += CLUSTER_THREADS) {
      const int r = e / np, i = e % np;
      uint32_t bits = s_bits[i];
      if (EXT) {  // the three roles' bits combined; valid and forced once
        const uint32_t gpu = s_chk[i], st = s_chk[P + i];
        const uint32_t f = (bits >> BIT_FEASIBLE) & gpu & st & (uint32_t)(valid != 0)
                           & (uint32_t)(forced < 0 || n0 + i == forced);
        bits = (bits & ~((1u << ST_GPU) | (1u << ST_STORAGE) | (1u << BIT_FEASIBLE)))
               | (gpu << ST_GPU) | (st << ST_STORAGE) | (f << BIT_FEASIBLE);
      }
      uint8_t v;
      if (r == 0)
        v = (bits >> BIT_FEASIBLE) & 1u;
      else if (r <= N_STAGES)
        v = (bits >> (r - 1)) & 1u;
      else
        v = s_fit[(size_t)i * R + (r - 1 - N_STAGES)];
      out[(size_t)r * N + n0 + i] = v;
    }
    __syncthreads();  // the pass's shared rows read before the next pass writes them
  }
}

// ------------------------------------------------------------ C interface --

static bool k1_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

extern "C" {

// K1's dynamic shared memory at C (ext: its EXT build) and its bound
// (ops/cluster.py takes them from here)
long long feasibility_smem(const TablesView* t, int C, int ext) {
  return k1_smem_bytes(*t, C, ext != 0);
}
long long feasibility_smem_max() { return K1_SMEM_MAX; }

// Allow K1 clusters of 16 and K1_SMEM_MAX bytes of dynamic shared memory,
// once per device
int feasibility_init() {
  cudaError_t e = cudaSuccess;
  for (int ext = 0; ext < 2 && e == cudaSuccess; ++ext) {
    void (*k)(TablesView, int, int, int, int, uint8_t*) =
        ext ? feasibility_kernel<true> : feasibility_kernel<false>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, K1_SMEM_MAX);
  }
  return (int)e;
}

// Clusters of C CTAs with `smem` bytes of K1 (ext: its EXT build) that can
// be resident at once, into *out
int feasibility_occupancy(int ext, int C, long long smem, int* out) {
  if (!k1_size_ok(C)) return (int)cudaErrorInvalidValue;
  return ext ? cluster_occupancy_of(feasibility_kernel<true>, C, smem, out)
             : cluster_occupancy_of(feasibility_kernel<false>, C, smem, out);
}

// out: [1 + N_STAGES + R, N] uint8. One cluster of C CTAs with `smem` =
// feasibility_smem(t, C, EXT), EXT when the view's f_gpu or f_storage is
// on; any other shape is refused.
int feasibility_launch(const TablesView* t, int g, int forced, int valid, int include_dns,
                       uint8_t* out, int C, long long smem, cudaStream_t stream) {
  const bool ext = t->f_gpu || t->f_storage;
  if (!k1_size_ok(C) || smem != k1_smem_bytes(*t, C, ext) || smem > K1_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (ext)
    return cluster_launch(feasibility_kernel<true>, C, 1, smem, stream, *t, g, forced, valid,
                          include_dns, out);
  return cluster_launch(feasibility_kernel<false>, C, 1, smem, stream, *t, g, forced, valid,
                        include_dns, out);
}

}  // extern "C"
