// The scratch layout, the reduced normalizers, the stages' shared memory
// and the payload rows of the wave's sharded paths, shared by K8
// (wave_sharded.cu: the epoch path, which launches K10's setup and front
// and builds its table with K10's body) and K10 (wave_rounds.cu: the
// per-round path).

#pragma once

#include "common.cuh"
#include "wave_cluster.cuh"

// The kernels read the tables through a view of the rank's block (parallel/
// mesh.py `to_device_sharded`: its N is the block's NL) whose node-axis
// pointers ops/kernels.py rebases by the block's first node `lo`, so that
// global node n of [lo, hi) addresses the block's row n - lo. The scratch
// is indexed by global node over all N of the mesh (the argument N, not the
// view's): the setup fills the block's part, K8's tail its usable prefixes
// and first takes over every node from the gathered rows.
//
// Float scratch: ip, simon_s, static, bound [N] each. Int scratch: feas,
// cap (the segment's), F, avail (K10's epoch rows), u, c0 [N] each. State:
// placed, last, iterations, head fallbacks, guarded. K8's tail reads the
// payload rows where the all-gather put them.
struct WaveScratch {
  float *ip, *simon_s, *stat, *bound;
  int *feas, *cap, *F, *avail, *u, *c0;
};

// the payload row of a node: [table (B+1); F; min(avail, B+1); simon_s;
// nodeaff; taint; ip]: B + WAVE_PAY_EXTRA floats
#define WAVE_PAY_EXTRA 7

static __device__ __forceinline__ WaveScratch wave_scratch(int N, float* fs, int* is) {
  WaveScratch w;
  w.ip = fs;
  w.simon_s = w.ip + N;
  w.stat = w.simon_s + N;
  w.bound = w.stat + N;
  w.feas = is;
  w.cap = w.feas + N;
  w.F = w.cap + N;
  w.avail = w.F + N;
  w.u = w.avail + N;
  w.c0 = w.u + N;
  return w;
}

// The dynamic shared memory of a K8 or K10 stage at C: the round slots
// [2][C][RX_WORDS] (ops/cluster.py takes it from wave_rounds_smem and
// wave_sharded_smem)
static __host__ __device__ inline long long wave_stage_smem_bytes(int C) {
  return 4LL * 2 * C * RX_WORDS;
}

// The normalizers from the reduced vector [max simon, nodeaff, taint, ip,
// max -simon, max -ip] (JAX :1233-1235)
static __device__ __forceinline__ Norms reduced_norms(const float* red) {
  return {red[0], -red[4], fmaxf(red[1], 0.0f), fmaxf(red[2], 0.0f), fmaxf(red[3], 0.0f),
          fminf(-red[5], 0.0f)};
}

// The payload rows of the block's nodes [a, b) (global nodes; the view
// rebased by lo), each CTA its slice: the normalizers `nm` of the reduced
// vector (JAX :1233), the [B+1] score rows (_wave_score_table_rows :904)
// and [F; min(avail, B+1); simon_s; nodeaff; taint; ip] (:1240), then
// per_node(n, row, F, min(avail, B+1), first_bad), first_bad the node's
// first entry past depth B or past a rise: K10's summaries; K8's table
// passes a callback that does nothing.
template <class PerNode>
static __device__ __forceinline__ void wave_payload_rows(const TablesView& t, int g, int B, int lo,
                                                         int a, int b, const int* j,
                                                         const WaveScratch& w, const Norms& nm,
                                                         float* pay, const PerNode& per_node) {
  const int R = t.R, B1 = B + 1, P = B + WAVE_PAY_EXTRA;
  const size_t gN = (size_t)g * t.N;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  for (int n = a + (int)threadIdx.x; n < b; n += CLUSTER_THREADS) {
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
    int first_bad = B;
    float prev = 0.0f;
    for (int k = 0; k < B1; ++k) {
      const float copies = jf + (float)(k + 1);
      float least, bal;
      least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
      const float v = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
      row[k] = v;
      if (k > 0 && k < B && first_bad == B && v > prev) first_bad = k;
      prev = v;
    }
    const bool F = w.feas[n] && avail > 0;
    const int av = min(avail, B1);
    row[B1] = F ? 1.0f : 0.0f;
    row[B1 + 1] = (float)av;
    row[B1 + 2] = w.simon_s[n];
    row[B1 + 3] = t.nodeaff_raw[gN + n];
    row[B1 + 4] = t.taint_raw[gN + n];
    row[B1 + 5] = w.ip[n];
    per_node(n, row, F, av, first_bad);
  }
}
