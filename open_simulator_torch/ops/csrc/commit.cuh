// The aggregate commit's device code, shared by K3c (aggregate_commit.cu:
// one thread-block cluster a lane over the N nodes) and K14
// (commit_sharded.cu: the rank's block of a partitioned node mesh, its
// rows stage a cluster over the block, its domains stage a grid over the
// counter and carrier elements, the per-domain counts summed over the
// ranks in between): j[n] copies of group g into the node rows, the
// per-topology domain counts of j, and the domain counters' update from
// those counts, each read from the input carry and written into a new one
// (out of place).

#pragma once

#include "cluster.cuh"
#include "common.cuh"

// ---- On a thread-block cluster: each CTA reads the input carry `t` and
// writes the new carry `o` (the same fields, no input aliased) for its node
// slice [lo, hi) and its share of the domain columns, so every carry
// element is read once and written once.

// The new carry an out-of-place commit writes: TablesView's carry fields,
// in its order (ops/kernels.py CarryOut)
struct CarryOut {
  float* requested;    // [N, R]
  float* nonzero;      // [N, 2]
  uint8_t* port_used;  // [N, PORT1]
  float* counter;      // [T, D1]
  float* carrier;      // [Tc, D1]
  float* dev_used;     // [N, MAXDEV]
  float* vg_req;       // [N, MAXVG]
  float* sdev_alloc;   // [N, MAXSD]
};

// Lane s's new carry of [S, ...] tensors (common.cuh lane_view's offsets)
static __device__ CarryOut carry_out_lane(const CarryOut& o, const TablesView& t, int s) {
  CarryOut v = o;
  const size_t N = (size_t)t.N, S = (size_t)s;
  v.requested += S * N * t.R;
  v.nonzero += S * N * 2;
  v.port_used += S * N * t.PORT1;
  v.counter += S * (size_t)t.T * t.D1;
  v.carrier += S * (size_t)t.Tc * t.D1;
  v.dev_used += S * N * t.MAXDEV;
  v.vg_req += S * N * t.MAXVG;
  v.sdev_alloc += S * N * t.MAXSD;
  return v;
}

// Share `rank` of n items cut into C contiguous shares: [*a, *b)
static __device__ __forceinline__ void cta_share(size_t n, int rank, int C, size_t* a, size_t* b) {
  const size_t w = (n + C - 1) / C, a0 = (size_t)rank * w;
  *a = a0 < n ? a0 : n;
  *b = *a + w < n ? *a + w : n;
}

// Copy rows [lo, hi) of a [N, w] field
static __device__ __forceinline__ void copy_rows(const float* in, float* out, int w, int lo,
                                                 int hi) {
  for (size_t i = (size_t)lo * w + threadIdx.x; i < (size_t)hi * w; i += blockDim.x)
    out[i] = in[i];
}

// The node rows of j[n] copies of group g on the node slice [lo, hi), out
// of place: requested and nonzero (one multiply, then one add), port_used copied then the group's
// port bits on nodes with a copy, vg_req and sdev_alloc copied, dev_used
// copied or, with gpu_live, replayed copy by copy from its input row
// (node-local: the thread that owns a node replays it whole).
static __device__ void commit_rows_out(const TablesView& t, const CarryOut& o, int g, const int* j,
                                       int gpu_live, int lo, int hi) {
  const int R = t.R, tid = threadIdx.x, bd = blockDim.x;
  for (size_t i = (size_t)lo * R + tid; i < (size_t)hi * R; i += bd)
    o.requested[i] = t.requested[i] + t.grp_requests[(size_t)g * R + i % R] * (float)j[i / R];
  for (size_t i = (size_t)lo * 2 + tid; i < (size_t)hi * 2; i += bd)
    o.nonzero[i] = t.nonzero[i] + t.grp_nonzero[g * 2 + i % 2] * (float)j[i / 2];
  for (size_t i = (size_t)lo * t.PORT1 + tid; i < (size_t)hi * t.PORT1; i += bd)
    o.port_used[i] = t.port_used[i];
  copy_rows(t.vg_req, o.vg_req, t.MAXVG, lo, hi);
  copy_rows(t.sdev_alloc, o.sdev_alloc, t.MAXSD, lo, hi);
  const float gmem = t.grp_gpu_mem[g];
  if (gpu_live && gmem > 0.0f) {
    const float gnum = fmaxf(t.grp_gpu_num[g], 1.0f), safe_mem = fmaxf(gmem, 1.0f);
    const bool single = t.grp_gpu_num[g] == 1.0f;
    NODE_DEVS(take, t, wt_take);
    for (int n = lo + tid; n < hi; n += bd) {
      const float* in = t.dev_used + (size_t)n * t.MAXDEV;
      float* used = o.dev_used + (size_t)n * t.MAXDEV;
      for (int d = 0; d < t.MAXDEV; ++d) used[d] = in[d];
      for (int k = 0; k < j[n]; ++k) {
        gpu_take_at(t, used, n, gmem, gnum, safe_mem, single, take);
        for (int d = 0; d < t.MAXDEV; ++d) used[d] = used[d] + take[d] * gmem;
      }
    }
  } else {
    copy_rows(t.dev_used, o.dev_used, t.MAXDEV, lo, hi);
  }
  __syncthreads();  // the copied port rows before the group's bits
  for (int n = lo + tid; n < hi; n += bd) {
    if (j[n] <= 0) continue;
    for (int k = 0; k < t.PP; ++k) {
      const int pid = t.grp_ports[g * t.PP + k];
      if (pid > 0) o.port_used[(size_t)n * t.PORT1 + pid] = 1;
    }
  }
}

// Add the per-topology domain counts of j on the node slice [lo, hi) into
// seg [U, D+1] in global memory (the sentinel column never counts): one
// warp-aggregated atomic per domain a warp touches (cluster.cuh
// warp_add_at), integer sums, exact in any order.
static __device__ void commit_slice_counts(const TablesView& t, const int* j, const int* topo_dom,
                                           int U, int lo, int hi, float* seg) {
  const int N = t.N, D1 = t.D1, D = D1 - 1;
  for (int u = 0; u < U; ++u) {
    const int* dom = topo_dom + (size_t)u * N;
    for (int n0 = lo; n0 < hi; n0 += blockDim.x) {  // uniform trips: every lane adds
      const int n = n0 + (int)threadIdx.x;
      int d = -1, c = 0;
      if (n < hi) {
        c = j[n];
        if (c != 0 && dom[n] < D) d = dom[n];
      }
      warp_add_at(seg + (size_t)u * D1, d, (float)c);
    }
  }
}

// The counter and carrier rows after the per-topology counts seg (rows of
// one topology key share its domain row) on the column share [d0, d1) of
// every row, out of place, from the complete seg (read past L1: the other
// CTAs' atomics land in L2)
static __device__ void commit_counters_share(const TablesView& t, const CarryOut& o, int g,
                                             const int* counter_topo, const int* carr_topo,
                                             const float* seg, int d0, int d1) {
  const int D1 = t.D1, nd = d1 - d0, tid = threadIdx.x, bd = blockDim.x;
  if (nd <= 0) return;
  for (size_t i = tid; i < (size_t)t.T * nd; i += bd) {
    const size_t r = i / nd, k = r * D1 + d0 + i % nd;
    o.counter[k] = t.counter[k] + (float)t.counter_sel_match_g[r * t.G + g]
                                  * __ldcg(&seg[(size_t)counter_topo[r] * D1 + d0 + i % nd]);
  }
  for (size_t i = tid; i < (size_t)t.Tc * nd; i += bd) {
    const size_t r = i / nd, k = r * D1 + d0 + i % nd;
    o.carrier[k] = t.carrier[k] + t.grp_carries[(size_t)g * t.Tc + r]
                                  * __ldcg(&seg[(size_t)carr_topo[r] * D1 + d0 + i % nd]);
  }
}

// K3c's commit on this CTA of a cluster over the N nodes: the CTA's share
// of seg cleared; its node slice's rows; a cluster barrier (every share
// cleared before any add); its slice's counts added into seg; a cluster
// barrier (release / acquire at cluster scope: every CTA's atomics before
// any read); its share of the domain columns of counter and carrier.
static __device__ void commit_cluster(const TablesView& t, const CarryOut& o, int g, const int* j,
                                      const int* topo_dom, const int* counter_topo,
                                      const int* carr_topo, int U, int gpu_live, float* seg) {
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
  cta_share((size_t)t.D1, rank, C, &a, &b);
  commit_counters_share(t, o, g, counter_topo, carr_topo, seg, (int)a, (int)b);
}
