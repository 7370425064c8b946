// Hand-written Hopper kernel of the wave-like routes' commit.
//
// K3c aggregate_commit_kernel replaces open_simulator_tpu/ops/kernels.py
//    `_aggregate_commit` (:976): commits the per-node counts of K3, K4 or K5
//    into the carry at once; with gpu_live it replays the GPU device ledger
//    copy by copy (:1007-1031): j[n] copies of the allocator (tightest fit
//    for one GPU, in-order units for several) on every node. Nodes are
//    independent, so the thread that owns a node loops j[n] times over its
//    MAXDEV devices, exactly and without atomics.
//
// Design: one thread-block cluster of C CTAs of CLUSTER_THREADS threads (C
// from ops/cluster.py `choose` over N, cached per shape), in ONE launch and
// out of place: the kernel reads the input carry and writes a fresh one
// (commit.cuh commit_cluster), so each carry element is read once and
// written once and the wrapper clones nothing. CTA r owns the node slice
// [r * chunk, (r + 1) * chunk) of every [N, *] row and a share of the D+1
// domain columns of every counter and carrier row. The per-topology domain
// sums [U, D+1] live in global scratch: each CTA clears its share, a
// cluster barrier, each CTA adds its nodes' counts with one warp-aggregated
// atomic per domain a warp touches (integer-valued: exact in any order), a
// cluster barrier, then each CTA updates its columns from the complete sums.
// It needs no dynamic shared memory (aggregate_commit_smem is 0).
//
// What bounds it on an H100: bytes (the carry read and written once, the
// [U, N] domain maps and the counts read once: 0.6-2.4 MB at 5,000-10,000
// nodes), at a few microseconds spread over C SMs; the launch and the two
// cluster barriers are most of a call.
//
// K3c over lanes (aggregate_commit_lanes_kernel, one cluster a lane: lane
// s = blockIdx.x / C) commits each lane's counts into its own new carry,
// with its own seg slice and group, for the wave-like fan-outs
// (`probe_*_fanout`, `serve_wave_fanout`, `sweep_wave_fanout`:
// kernels.py:2302-2447); see common.cuh `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "cluster.cuh"
#include "commit.cuh"
#include "common.cuh"

// ---------------------------------------------------------------- K3c ------

// Commit j[n] copies of group g on every node n of the carry `t` points at
// into the new carry `o`. seg: [U, D+1] scratch for the per-topology sums.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
aggregate_commit_kernel(TablesView t, CarryOut o, int g, const int* j, const int* topo_dom,
                        const int* counter_topo, const int* carr_topo, int U, int gpu_live,
                        float* seg) {
  commit_cluster(t, o, g, j, topo_dom, counter_topo, carr_topo, U, gpu_live, seg);
}

// K3c over lanes: cluster s commits j row [s, N] of group g (g_s[s] for a
// non-null g_s) from lane s's carry into lane s's new carry, with its own
// seg slice.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
aggregate_commit_lanes_kernel(TablesView t, CarryOut o, int g, const int* g_s, const int* j,
                              const int* topo_dom, const int* counter_topo, const int* carr_topo,
                              int U, int gpu_live, float* seg) {
  const int s = blockIdx.x / cluster_ctas();
  LANE_VIEW(lt, t, s)
  commit_cluster(lt, carry_out_lane(o, t, s), g_s ? g_s[s] : g, j + (size_t)s * t.N, topo_dom,
                 counter_topo, carr_topo, U, gpu_live, seg + (size_t)s * U * t.D1);
}

// ------------------------------------------------------------ C interface --

static bool k3c_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

extern "C" {

// K3c's dynamic shared memory at any C: none (ops/cluster.py takes it from
// here)
long long aggregate_commit_smem() { return 0; }

// Allow K3c clusters of 16, once per device
int aggregate_commit_init() {
  cudaError_t e = cluster_kernel_init(aggregate_commit_kernel);
  if (e == cudaSuccess) e = cluster_kernel_init(aggregate_commit_lanes_kernel);
  return (int)e;
}

// Clusters of C CTAs with `smem` bytes of K3c (lanes: its lane form) that
// can be resident at once, into *out
int aggregate_commit_occupancy(int lanes, int C, long long smem, int* out) {
  if (!k3c_size_ok(C)) return (int)cudaErrorInvalidValue;
  return lanes ? cluster_occupancy_of(aggregate_commit_lanes_kernel, C, smem, out)
               : cluster_occupancy_of(aggregate_commit_kernel, C, smem, out);
}

// One cluster of C CTAs; `smem` must be aggregate_commit_smem(): any other
// shape is refused. t: the input carry's view; o: the new carry (no input
// aliased); j [N]; seg [U, D1] scratch.
int aggregate_commit_launch(const TablesView* t, const CarryOut* o, int g, const int* j,
                            const int* topo_dom, const int* counter_topo, const int* carr_topo,
                            int U, int gpu_live, float* seg, int C, long long smem,
                            cudaStream_t stream) {
  if (!k3c_size_ok(C) || smem != aggregate_commit_smem()) return (int)cudaErrorInvalidValue;
  return cluster_launch(aggregate_commit_kernel, C, 1, smem, stream, *t, *o, g, j, topo_dom,
                        counter_topo, carr_topo, U, gpu_live, seg);
}

// S lanes of K3c, one cluster of C CTAs each: the view is lane 0's carry of
// [S, ...] tensors and o lane 0's new carry; group g for every lane, or
// g_s[s] where g_s (a device array of S entries) is not null; j [S, N]; seg
// S slices of [U, D+1]
int aggregate_commit_lanes_launch(const TablesView* t, const CarryOut* o, int g, const int* g_s,
                                  const int* j, const int* topo_dom, const int* counter_topo,
                                  const int* carr_topo, int U, int gpu_live, int S, float* seg,
                                  int C, long long smem, cudaStream_t stream) {
  if (!k3c_size_ok(C) || smem != aggregate_commit_smem()) return (int)cudaErrorInvalidValue;
  return cluster_launch(aggregate_commit_lanes_kernel, C, S, smem, stream, *t, *o, g, g_s, j,
                        topo_dom, counter_topo, carr_topo, U, gpu_live, seg);
}

}  // extern "C"
