// Hand-written Hopper kernel for the serial route's diagnostics.
//
// K1 feasibility_kernel replaces open_simulator_tpu/ops/kernels.py
//    `feasibility_jit` (:743, wrapping `feasibility` :379): one pod group's [N]
//    feasible mask, the per-stage masks and fit_each [N, R], with the
//    GPU-share and Open-Local stages when the view's flags are on.
//
// What bounds it on an H100: it reads a few [N] rows and is launch bound at
// the shapes of this route (N = 5,120): one thread per node.
//
// It has a file of its own: a module that also holds the cluster kernels
// (schedule.cu) gets 12 more bytes of shared memory for it from ptxas.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "common.cuh"

#define K1_THREADS 256

// ----------------------------------------------------------------- K1 ------

__global__ void __launch_bounds__(K1_THREADS)
feasibility_kernel(TablesView t, int g, int forced, int valid, int include_dns, uint8_t* feasible,
                   uint8_t* stages, uint8_t* fit_each) {
  __shared__ PodCtx pc;
  __shared__ float s_red[32];
  pod_prologue(t, g, include_dns, &pc, s_red);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= t.N) return;
  const uint32_t bits = node_feasibility<true>(t, &pc, g, forced, valid, include_dns, 1, n,
                                         fit_each + (size_t)n * t.R);
  feasible[n] = (bits >> BIT_FEASIBLE) & 1u;
  for (int s = 0; s < N_STAGES; ++s) stages[(size_t)s * t.N + n] = (bits >> s) & 1u;
}

// ------------------------------------------------------------ C interface --

extern "C" {

int feasibility_launch(const TablesView* t, int g, int forced, int valid, int include_dns,
                       uint8_t* feasible, uint8_t* stages, uint8_t* fit_each,
                       cudaStream_t stream) {
  const int blocks = (t->N + K1_THREADS - 1) / K1_THREADS;
  feasibility_kernel<<<blocks, K1_THREADS, 0, stream>>>(*t, g, forced, valid, include_dns,
                                                        feasible, stages, fit_each);
  return (int)cudaGetLastError();
}

}  // extern "C"
