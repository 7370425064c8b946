// Hand-written Hopper kernel for the aggregate commit on a partitioned node
// mesh.
//
// K14 replaces open_simulator_tpu/ops/kernels.py `_aggregate_commit` (:976,
//    reached from `schedule_wave` :1284, `schedule_affinity_wave` :2097 and
//    `schedule_group_serial` :2262) as XLA partitions it over the nodes
//    under the layout of parallel/mesh.py: each rank holds only its block of
//    NL nodes of the [N, *] carry rows and the whole [*, D+1] domain
//    counters. It is the aggregate commit's one-block form (commit.cuh's
//    one-block functions; K3c, aggregate_commit.cu, runs their cluster form
//    commit_cluster) cut at its one cross-node sum, with one collective
//    between the halves
//    (ops/kernels.py `aggregate_commit_sharded_kernel` drives them; its
//    plain version is `aggregate_commit_sharded_plain`):
// - rows (the block): the block's j[n] copies of group g into requested,
//   nonzero and the ports, and with gpu_live the GPU device ledger replayed
//   copy by copy (:1007-1031), node-local; then the block's per-topology
//   domain counts [U, D+1] of j (integer-valued, atomics exact in any
//   order);
//   all_gather_rows of those counts;
// - domains (replicated): the counts summed in rank order (integer-valued:
//   exact), then K3c's update of every counter and carrier row.
// So the block's rows and the counters equal K3c's full-width commit,
// assembled over the ranks, bit for bit.
//
// What bounds it on an H100: launch and collective latency; the bytes are
// the block's [NL, R] rows and the [T + Tc, D+1] counters, read and written
// once.

#include "commit.cuh"
#include "common.cuh"

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
commit_sharded_rows(TablesView t, int g, const int* j, const int* topo_dom, int U, int gpu_live,
                    float* seg) {
  for (size_t i = threadIdx.x; i < (size_t)U * t.D1; i += blockDim.x) seg[i] = 0.0f;
  commit_node_rows(t, g, j, gpu_live);
  __syncthreads();
  commit_topo_counts(t, j, topo_dom, U, seg);
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
commit_sharded_domains(TablesView t, int g, const float* rows, int R, const int* counter_topo,
                       const int* carr_topo, int U, float* seg) {
  const size_t W = (size_t)U * t.D1;
  for (size_t i = threadIdx.x; i < W; i += blockDim.x) {
    float x = rows[i];
    for (int r = 1; r < R; ++r) x = x + rows[(size_t)r * W + i];  // rank order
    seg[i] = x;
  }
  __syncthreads();
  commit_domain_counters(t, g, counter_topo, carr_topo, seg);
}

// ------------------------------------------------------------ C interface --

extern "C" {

// t: the block's view (its N is NL), on a clone of the carry block that the
// kernels update in place; j [NL]; topo_dom [U, NL]; seg [U, D1] scratch
int commit_sharded_rows_launch(const TablesView* t, int g, const int* j, const int* topo_dom,
                               int U, int gpu_live, float* seg, cudaStream_t stream) {
  commit_sharded_rows<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, j, topo_dom, U, gpu_live, seg);
  return (int)cudaGetLastError();
}

// rows: every rank's [U, D1] counts, [R, U, D1] in rank order
int commit_sharded_domains_launch(const TablesView* t, int g, const float* rows, int R,
                                  const int* counter_topo, const int* carr_topo, int U,
                                  float* seg, cudaStream_t stream) {
  commit_sharded_domains<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, rows, R, counter_topo,
                                                          carr_topo, U, seg);
  return (int)cudaGetLastError();
}

}  // extern "C"
