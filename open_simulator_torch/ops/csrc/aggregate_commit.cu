// Hand-written Hopper kernel of the wave-like routes' commit.
//
// K3c aggregate_commit_kernel replaces open_simulator_tpu/ops/kernels.py
//    `_aggregate_commit` (:976): commits the per-node counts of K3, K4 or K5
//    into the carry at once; with gpu_live it replays the GPU device ledger
//    copy by copy (:1007-1031): j[n] copies of the allocator (tightest fit
//    for one GPU, in-order units for several) on every node. Nodes are
//    independent, so one thread per node loops j[n] times over its MAXDEV
//    devices, exactly and without atomics.
//
// What bounds it on an H100: it touches the carry once ([N, R] rows, [T, D+1]
// counters) and is launch bound; one block (device code in commit.cuh,
// shared with K14).
//
// K3c over lanes (aggregate_commit_lanes_kernel, the lane on the grid's
// second dimension) commits each lane's counts into its own carry, for the
// wave-like fan-outs (`probe_*_fanout`, `serve_wave_fanout`,
// `sweep_wave_fanout`: kernels.py:2302-2447); see common.cuh `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "commit.cuh"
#include "common.cuh"

// ---------------------------------------------------------------- K3c ------

// Commit j[n] copies of group g on every node n into the carry `t` points at
// (commit.cuh). seg: [U, D+1] scratch for the per-topology domain sums.
static __device__ __forceinline__ void
aggregate_commit_body(const TablesView& t, int g, const int* j, const int* topo_dom,
                      const int* counter_topo, const int* carr_topo, int U, int gpu_live,
                      float* seg) {
  for (size_t i = threadIdx.x; i < (size_t)U * t.D1; i += blockDim.x) seg[i] = 0.0f;
  commit_node_rows(t, g, j, gpu_live);
  __syncthreads();
  commit_topo_counts(t, j, topo_dom, U, seg);
  __syncthreads();
  commit_domain_counters(t, g, counter_topo, carr_topo, seg);
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

int aggregate_commit_launch(const TablesView* t, int g, const int* j, const int* topo_dom,
                            const int* counter_topo, const int* carr_topo, int U, int gpu_live,
                            float* seg, cudaStream_t stream) {
  aggregate_commit_kernel<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, j, topo_dom, counter_topo,
                                                           carr_topo, U, gpu_live, seg);
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
