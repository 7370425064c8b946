// Radix selection over a score table: the serial pick order of the table's
// entries (score desc, then flat index n*B+k asc, the order lax.top_k
// returns) as one distinct 64-bit key per entry, shared by every wave and
// affinity kernel, and a one-block MSB-first radix select that finds the key
// of the r-th best usable entry without sorting (K8's tail in wave.cuh, K9's
// in affinity.cuh, K10; K3 and K5 select across a cluster in
// wave_cluster.cuh).

#pragma once

#include "common.cuh"

typedef unsigned long long u64;

// Order-preserving bits of a score (-0 keys as +0; no table entry is NaN).
static __device__ __forceinline__ uint32_t order_bits(float x) {
  const uint32_t u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Selection key of table entry (n, k): score desc, then flat index asc.
// Never 0 (order bits of a number are never 0), so 0 means "no entry".
static __device__ __forceinline__ u64 entry_key(float v, int n, int k, int B) {
  return ((u64)order_bits(v) << 32) | (u64)(0xffffffffu - (uint32_t)(n * B + k));
}

// Leading entries of a node's usable prefix with key >= T (the keys fall
// strictly along the prefix, so these are all its entries >= T).
static __device__ __forceinline__ int count_at_least(const float* row, int n, int u, int B, u64 T) {
  int c = 0;
  while (c < u && entry_key(row[c], n, c, B) >= T) ++c;
  return c;
}

static __device__ __forceinline__ int count_above(const float* row, int n, int u, int B, u64 X) {
  int c = 0;
  while (c < u && entry_key(row[c], n, c, B) > X) ++c;
  return c;
}

// The key of the r-th best usable entry (r >= 1, at most the usable count)
// of a table whose row n starts at table + n * S: an 8-pass MSB-first radix
// select over the keys, with warp-aggregated shared-memory histograms.
// Block-uniform; every thread gets the key.
static __device__ u64 select_key(const float* table, int S, const int* u_s, int N, int B, int r,
                                 int* hist, u64* s_prefix, int* s_rem) {
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  const unsigned NB = (unsigned)N * (unsigned)B;
  u64 prefix = 0, mask = 0;
  int rem = r;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int d = tid; d < 256; d += bd) hist[d] = 0;
    __syncthreads();
    for (unsigned e0 = 0; e0 < NB; e0 += bd) {  // uniform trip count: the warp stays converged
      const unsigned e = e0 + tid;
      int digit = 256;
      if (e < NB) {
        const int n = (int)(e / (unsigned)B), k = (int)(e - (unsigned)n * B);
        if (k < u_s[n]) {
          const u64 key = entry_key(table[(size_t)n * S + k], n, k, B);
          if ((key & mask) == prefix) digit = (int)((key >> shift) & 255u);
        }
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
