// The scratch layout and the reduced normalizers of the wave's sharded
// paths, shared by K8 (wave_sharded.cu: the epoch path) and K10
// (wave_rounds.cu: the per-round path, which launches K8's front and table
// on the same scratch).

#pragma once

#include "common.cuh"

// The kernels read the tables through a view of the rank's block (parallel/
// mesh.py `to_device_sharded`: its N is the block's NL) whose node-axis
// pointers ops/kernels.py rebases by the block's first node `lo`, so that
// global node n of [lo, hi) addresses the block's row n - lo. The scratch
// is indexed by global node over all N of the mesh (the argument N, not the
// view's): the setup fills the block's part, the tail the rest from the
// gathered rows.
//
// Float scratch: ip, simon_s, static, bound, nodeaff, taint [N] each. Int
// scratch: feas, cap (the segment's), F, avail (the epoch's gathered rows),
// u, c0 [N] each. State: placed, last, iterations, head fallbacks,
// guarded. The tail reads the table rows where the all-gather put them.
struct WaveScratch {
  float *ip, *simon_s, *stat, *bound, *nodeaff, *taint;
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
  w.nodeaff = w.bound + N;
  w.taint = w.nodeaff + N;
  w.feas = is;
  w.cap = w.feas + N;
  w.F = w.cap + N;
  w.avail = w.F + N;
  w.u = w.avail + N;
  w.c0 = w.u + N;
  return w;
}

// The normalizers from the reduced vector [max simon, nodeaff, taint, ip,
// max -simon, max -ip] (JAX :1233-1235)
static __device__ __forceinline__ Norms reduced_norms(const float* red) {
  return {red[0], -red[4], fmaxf(red[1], 0.0f), fmaxf(red[2], 0.0f), fmaxf(red[3], 0.0f),
          fminf(-red[5], 0.0f)};
}
