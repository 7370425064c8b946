// Hand-written Hopper kernel for the aggregate commit on a partitioned node
// mesh.
//
// K14 replaces open_simulator_tpu/ops/kernels.py `_aggregate_commit` (:976,
//    reached from `schedule_wave` :1284, `schedule_affinity_wave` :2097 and
//    `schedule_group_serial` :2262) as XLA partitions it over the nodes
//    under the layout of parallel/mesh.py: each rank holds only its block of
//    NL nodes of the [N, *] carry rows and the whole [*, D+1] domain
//    counters. It is K3c's commit (commit.cuh) cut at its one cross-node
//    sum, with one collective between the halves (ops/kernels.py
//    `aggregate_commit_sharded_kernel` drives them; its plain version is
//    `aggregate_commit_sharded_plain`).
//
// Design: two launches, out of place: they read the input carry and write
// a new one (the wrapper allocates it with torch.empty and clones nothing),
// so each carry element is read once and written once and the input stays
// as it was.
// - rows: ONE thread-block cluster of C CTAs of CLUSTER_THREADS threads over
//   the block's NL nodes (C from ops/cluster.py `choose` over NL, cached
//   per shape), K3c's commit_cluster without its column step: each CTA
//   clears its share of the [U, D+1] per-topology sums in global scratch;
//   writes its node slice's rows of the new carry (commit_rows_out: the
//   block's j[n] copies of group g into requested, nonzero and the ports,
//   the GPU device ledger replayed copy by copy with gpu_live, one thread a
//   node (:1007-1031), the other rows copied); a cluster barrier (every
//   share cleared before any add); adds its slice's counts into the sums
//   (commit_slice_counts: the sentinel column never counts;
//   integer-valued, exact in any order); a cluster barrier (every CTA's
//   atomics complete at cluster scope before any CTA ends);
// - one all_gather_rows of the [U, D+1] sums, every rank's in rank order;
// - domains: a grid over the (T + Tc) x (D+1) elements of counter and
//   carrier, one thread an element. Column d of a counter or carrier row
//   reads only column d of its topology's gathered sums, so no value
//   crosses between CTAs and every SM can take a share. Each thread sums
//   the R ranks' counts in rank order (integer-valued: exact), makes K3c's
//   one multiply and one add into its input element, and writes the new
//   carry's element (the sentinel column too: its sums are 0).
// So the block's rows and the counters equal K3c's full-width commit,
// assembled over the ranks, bit for bit.
//
// What bounds it on an H100: launch and collective latency; the bytes are
// the block's [NL, *] carry rows, its [U, NL] domain maps and the
// [T + Tc, D+1] counters, each read once and written once.

#include "commit.cuh"

// threads of a domains block
#define K14_DOMAIN_THREADS 256

// The rows stage on this CTA of a cluster over the block's NL nodes (the
// view's N): the new carry's node rows into `o`, the slice's counts into
// seg [U, D+1]
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
commit_sharded_rows(TablesView t, CarryOut o, int g, const int* j, const int* topo_dom, int U,
                    int gpu_live, float* seg) {
  const int C = cluster_ctas(), rank = cluster_rank();
  size_t a, b;
  cta_share((size_t)U * t.D1, rank, C, &a, &b);
  for (size_t i = a + threadIdx.x; i < b; i += blockDim.x) seg[i] = 0.0f;
  cta_share((size_t)t.N, rank, C, &a, &b);
  const int lo = (int)a, hi = (int)b;
  commit_rows_out(t, o, g, j, gpu_live, lo, hi);
  cluster_barrier_uncounted();
  commit_slice_counts(t, j, topo_dom, U, lo, hi, seg);
  cluster_barrier_uncounted();
}

// The domains stage: element i of the [T, D1] counter rows, then of the
// [Tc, D1] carrier rows, from the gathered sums rows [R, U, D1]
__global__ void __launch_bounds__(K14_DOMAIN_THREADS)
commit_sharded_domains(TablesView t, CarryOut o, int g, const float* rows, int R,
                       const int* counter_topo, const int* carr_topo, int U) {
  const size_t D1 = t.D1, nc = (size_t)t.T * D1, n = nc + (size_t)t.Tc * D1;
  const size_t W = (size_t)U * D1;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool ctr = i < nc;
    const size_t k = ctr ? i : i - nc, r = k / D1, d = k % D1;
    const size_t at = (size_t)(ctr ? counter_topo[r] : carr_topo[r]) * D1 + d;
    float x = rows[at];
    for (int q = 1; q < R; ++q) x = x + rows[(size_t)q * W + at];  // rank order
    if (ctr)
      o.counter[k] = t.counter[k] + (float)t.counter_sel_match_g[r * t.G + g] * x;
    else
      o.carrier[k] = t.carrier[k] + t.grp_carries[(size_t)g * t.Tc + r] * x;
  }
}

// ------------------------------------------------------------ C interface --

static bool k14_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

extern "C" {

// The rows stage's dynamic shared memory at any C: none (ops/cluster.py
// takes it from here)
long long commit_sharded_smem() { return 0; }

// Allow rows clusters of 16, once per device
int commit_sharded_init() { return (int)cluster_kernel_init(commit_sharded_rows); }

// Rows clusters of C CTAs with `smem` bytes that can be resident at once,
// into *out
int commit_sharded_occupancy(int C, long long smem, int* out) {
  if (!k14_size_ok(C)) return (int)cudaErrorInvalidValue;
  return cluster_occupancy_of(commit_sharded_rows, C, smem, out);
}

// t: the block's view of the input carry (its N is NL); o: the new carry (no
// input aliased); j [NL]; topo_dom [U, NL]; seg [U, D1] scratch. One cluster
// of C CTAs; `smem` must be commit_sharded_smem(): any other shape is
// refused.
int commit_sharded_rows_launch(const TablesView* t, const CarryOut* o, int g, const int* j,
                               const int* topo_dom, int U, int gpu_live, float* seg, int C,
                               long long smem, cudaStream_t stream) {
  if (!k14_size_ok(C) || smem != commit_sharded_smem()) return (int)cudaErrorInvalidValue;
  return cluster_launch(commit_sharded_rows, C, 1, smem, stream, *t, *o, g, j, topo_dom, U,
                        gpu_live, seg);
}

// rows: every rank's [U, D1] sums, [R, U, D1] in rank order; writes every
// element of o's counter and carrier. A grid of ceil((T + Tc) * D1 / 256)
// blocks (at most 4,096, each thread then striding).
int commit_sharded_domains_launch(const TablesView* t, const CarryOut* o, int g, const float* rows,
                                  int R, const int* counter_topo, const int* carr_topo, int U,
                                  cudaStream_t stream) {
  const long long n = (long long)(t->T + t->Tc) * t->D1;
  long long blocks = (n + K14_DOMAIN_THREADS - 1) / K14_DOMAIN_THREADS;
  blocks = blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks);
  commit_sharded_domains<<<(unsigned)blocks, K14_DOMAIN_THREADS, 0, stream>>>(
      *t, *o, g, rows, R, counter_topo, carr_topo, U);
  return (int)cudaGetLastError();
}

}  // extern "C"
