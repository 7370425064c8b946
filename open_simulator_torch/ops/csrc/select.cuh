// The serial pick order of a score table's entries (score desc, then flat
// index n*B+k asc, the order lax.top_k returns) as one distinct 64-bit key
// per entry, shared by every wave and affinity kernel; the radix selects
// over these keys run on clusters (wave_cluster.cuh cluster_select_key) or
// on one CTA over gathered keys (merge.cuh select_gathered).

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
