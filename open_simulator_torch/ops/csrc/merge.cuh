// The merge of per-rank block tops, shared by the per-round sharded paths
// (K10 wave_rounds.cu, K11 affinity_rounds.cu): each rank of a node mesh
// gathers every rank's rows of (64-bit key of select.cuh, payload) pairs, R
// blocks of c + 1 rows whose first c hold the block's best keys (0 after
// them) and whose last holds the block's own counts; the radix select finds
// the r-th best key of the union, which is the unsharded selection's, and
// (value, global index) pairs break ties as argmax does.

#pragma once

#include "common.cuh"
#include "select.cuh"

// (value, index) first-max of two pairs: value desc, index asc
static __device__ __forceinline__ void pair_update(double v, double i, double* bv, double* bi) {
  if (v > *bv || (v == *bv && i < *bi)) {
    *bv = v;
    *bi = i;
  }
}

// Block-wide exclusive prefix sum; every thread gets its offset and the
// block's total. `s_int` holds 32 ints.
static __device__ int block_exclusive_scan(int x, int* s_int, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();  // the previous call's readers are done with s_int
  if (lane == 31) s_int[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int v = lane < nw ? s_int[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, v, o);
      if (lane >= o) v += y;
    }
    s_int[lane] = v;
  }
  __syncthreads();
  *total = s_int[nw - 1];
  return (wid > 0 ? s_int[wid - 1] : 0) + incl - x;
}

// The key of the r-th best nonzero key (r >= 1, at most their count) among
// the gathered rows: R blocks of c + 1 rows of W entries (the key, then its
// payload), keys in the first c. An 8-pass MSB-first radix select as
// select.cuh's select_key.
static __device__ u64 select_gathered(const long long* rows, int R, int c, int r, int* hist,
                                      u64* s_prefix, int* s_rem, int W = 2) {
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  const unsigned total = (unsigned)R * (unsigned)c;
  u64 prefix = 0, mask = 0;
  int rem = r;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int d = tid; d < 256; d += bd) hist[d] = 0;
    __syncthreads();
    for (unsigned e0 = 0; e0 < total; e0 += bd) {  // uniform trip count
      const unsigned e = e0 + tid;
      int digit = 256;
      if (e < total) {
        const unsigned rk = e / (unsigned)c, s = e - rk * (unsigned)c;
        const u64 key = (u64)rows[((size_t)rk * (c + 1) + s) * W];
        if (key != 0 && (key & mask) == prefix) digit = (int)((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(FULL_MASK, digit);
      if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      int cum = 0, d = 255;
      for (; d > 0; --d) {
        if (cum + hist[d] >= rem) break;
        cum += hist[d];
      }
      *s_rem = rem - cum;
      *s_prefix = prefix | ((u64)d << shift);
    }
    __syncthreads();
    rem = *s_rem;
    prefix = *s_prefix;
    mask |= 255ull << shift;
  }
  return prefix;
}

// The global node of a gathered key (its low 32 bits hold ~(n*B + k))
static __device__ __forceinline__ int key_node(u64 key, int B) {
  return (int)((0xffffffffu - (uint32_t)key) / (uint32_t)B);
}
