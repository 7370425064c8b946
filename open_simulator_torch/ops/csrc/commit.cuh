// The aggregate commit's device code, shared by K3c (aggregate_commit.cu:
// every node on one block) and K14 (commit_sharded.cu: the rank's block of a partitioned
// node mesh, its per-domain counts summed over the ranks in between): j[n]
// copies of group g into the node rows, the per-topology domain counts of
// j, and the domain counters' update from those counts.

#pragma once

#include "common.cuh"

// The node rows of j[n] copies of group g on every node n of the view:
// requested and nonzero (one multiply, then one add), the group's host
// ports, and with gpu_live the GPU device ledger, j[n] copies of the
// allocator one after another (node-local: each thread owns its nodes).
static __device__ __forceinline__ void commit_node_rows(const TablesView& t, int g, const int* j,
                                                        int gpu_live) {
  const int N = t.N, R = t.R, tid = threadIdx.x, bd = blockDim.x;
  for (size_t i = tid; i < (size_t)N * R; i += bd)
    t.requested[i] = t.requested[i] + t.grp_requests[(size_t)g * R + i % R] * (float)j[i / R];
  for (size_t i = tid; i < (size_t)N * 2; i += bd)
    t.nonzero[i] = t.nonzero[i] + t.grp_nonzero[g * 2 + i % 2] * (float)j[i / 2];
  // a placed copy claims the group's host ports on its node (bits set with max)
  for (int n = tid; n < N; n += bd) {
    if (j[n] <= 0) continue;
    for (int k = 0; k < t.PP; ++k) {
      const int pid = t.grp_ports[g * t.PP + k];
      if (pid > 0) t.port_used[(size_t)n * t.PORT1 + pid] = 1;
    }
  }
  const float gmem = t.grp_gpu_mem[g];
  if (gpu_live && gmem > 0.0f) {
    const float gnum = fmaxf(t.grp_gpu_num[g], 1.0f), safe_mem = fmaxf(gmem, 1.0f);
    const bool single = t.grp_gpu_num[g] == 1.0f;
    float take[MAX_NODE_DEVS];
    for (int n = tid; n < N; n += bd) {
      float* used = t.dev_used + (size_t)n * t.MAXDEV;
      for (int k = 0; k < j[n]; ++k) {
        gpu_take_at(t, used, n, gmem, gnum, safe_mem, single, take);
        for (int d = 0; d < t.MAXDEV; ++d) used[d] = used[d] + take[d] * gmem;
      }
    }
  }
}

// Add the view's nodes' per-topology domain counts of j into seg [U, D+1]
// (topo_dom [U, N]; the sentinel column never counts): integer sums,
// exact in any order.
static __device__ __forceinline__ void commit_topo_counts(const TablesView& t, const int* j,
                                                          const int* topo_dom, int U,
                                                          float* seg) {
  const int N = t.N, D1 = t.D1, D = D1 - 1;
  for (size_t i = threadIdx.x; i < (size_t)U * N; i += blockDim.x) {
    const int n = (int)(i % N), d = topo_dom[i];
    if (d < D && j[n] != 0) atomicAdd(&seg[(i / N) * D1 + d], (float)j[n]);
  }
}

// The counter and carrier rows after the per-topology counts seg: rows of
// one topology key share its domain row.
static __device__ __forceinline__ void commit_domain_counters(const TablesView& t, int g,
                                                              const int* counter_topo,
                                                              const int* carr_topo,
                                                              const float* seg) {
  const int D1 = t.D1, tid = threadIdx.x, bd = blockDim.x;
  for (size_t i = tid; i < (size_t)t.T * D1; i += bd) {
    const size_t r = i / D1, d = i % D1;
    t.counter[i] = t.counter[i] + (float)t.counter_sel_match_g[r * t.G + g]
                                  * seg[(size_t)counter_topo[r] * D1 + d];
  }
  for (size_t i = tid; i < (size_t)t.Tc * D1; i += bd) {
    const size_t r = i / D1, d = i % D1;
    t.carrier[i] = t.carrier[i] + t.grp_carries[(size_t)g * t.Tc + r]
                                  * seg[(size_t)carr_topo[r] * D1 + d];
  }
}
