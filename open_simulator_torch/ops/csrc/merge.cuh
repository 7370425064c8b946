// The cluster stages of the sharded paths (K8 wave_sharded.cu, K9
// affinity_sharded.cu, K10 wave_rounds.cu, K11 affinity_rounds.cu, K12
// batch_sharded.cu, K13 group_serial_sharded.cu): their
// static shared memory, a row of maxima and counts as one round, and the
// block tops and their merge of the per-round paths (K10, K11): each rank of a node mesh
// selects its block's best entries on a thread-block cluster
// (cluster_block_top) and gathers every rank's rows of (64-bit key of
// select.cuh, payload), R blocks of c + 1 rows whose first c hold the
// block's best keys (0 after them) and whose last holds the block's own
// counts; a radix select finds the r-th best key of the union, which is the
// unsharded selection's, and (value, global index) pairs break ties as
// argmax does.

#pragma once

#include "common.cuh"
#include "select.cuh"
#include "wave_cluster.cuh"

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
// select.cuh's select_key, each pass's digit found by a scan of the 256
// bins over the first 256 threads. `hist` holds 256 + 8 ints.
static __device__ u64 select_gathered(const long long* rows, int R, int c, int r, int* hist,
                                      u64* s_prefix, int* s_rem, int W = 2) {
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31, wid = tid >> 5;
  int* s_wsum = hist + 256;
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
    // thread t < 256 holds digit 255 - t: an inclusive scan in descending
    // digit order; the digit whose bin holds the rem-th key is the pass's
    const int tot = tid < 256 ? hist[255 - tid] : 0;
    int incl = tot;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (tid < 256 && lane == 31) s_wsum[wid] = incl;
    __syncthreads();
    if (tid < 256) {
      for (int w = 0; w < wid; ++w) incl += s_wsum[w];
      const int excl = incl - tot;
      if (excl < rem && rem <= incl) {
        *s_rem = rem - excl;
        *s_prefix = prefix | ((u64)(255 - tid) << shift);
      }
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

// A CTA's share [e0, e0 + n) of the gathered block tops: R blocks of c + 1
// rows of W words, a block's first c rows holding its best keys (0 after
// them), so flat entry e is row (e / c) * (c + 1) + e % c. A key source of
// wave_cluster.cuh cluster_select_key: its keys are the nonzero ones.
struct GatheredKeys {
  const long long* rows;
  int c, W;
  unsigned e0, n;
  __device__ __forceinline__ const long long* row(unsigned e) const {
    const unsigned g = e0 + e, rk = g / (unsigned)c;
    return rows + ((size_t)rk * (c + 1) + (g - rk * (unsigned)c)) * W;
  }
  __device__ __forceinline__ unsigned slots() const { return n; }
  __device__ __forceinline__ bool key_at(unsigned e, u64* key) const {
    *key = (u64)row(e)[0];
    return *key != 0;
  }
  __device__ __forceinline__ u64 max_comp(u64 mask, u64 prefix) const {
    u64 best = 0;
    for (unsigned e = threadIdx.x; e < n; e += CLUSTER_THREADS) {
      const u64 key = (u64)row(e)[0];
      if (key != 0 && (key & mask) == prefix && ~key > best) best = ~key;
    }
    return best;
  }
};

// The global pairs of the two-largest-bound cut from the gathered summary
// rows (stride SW; [b1, i1, b2, i2, ...] a rank): the best block's first,
// then the best of the other blocks' firsts and the winner's second.
static __device__ __forceinline__ void global_pairs(const double* summ_all, int R, int SW,
                                                    float* f1, int* i1, float* f2, int* i2) {
  int win = 0;
  double b1 = summ_all[0], g1 = summ_all[1];
  for (int r = 1; r < R; ++r) {
    const double v = summ_all[r * SW], i = summ_all[r * SW + 1];
    if (v > b1 || (v == b1 && i < g1)) {
      b1 = v;
      g1 = i;
      win = r;
    }
  }
  double b2 = summ_all[win * SW + 2], g2 = summ_all[win * SW + 3];
  for (int r = 0; r < R; ++r)
    if (r != win) pair_update(summ_all[r * SW], summ_all[r * SW + 1], &b2, &g2);
  *f1 = (float)b1;
  *f2 = (float)b2;
  *i1 = (int)g1;
  *i2 = (int)g2;
}

// The sum of `x` over the CTAs of lower rank (every thread of the CTA
// passes the same x and gets the sum). One round.
static __device__ int cluster_offset(Cluster& cx, int x, int* fin) {
  round_arm(cx, 1);
  if (threadIdx.x < 32) round_put(cx, 0, x);
  const int W = cx.W;
  const int* src = round_wait(cx);
  if (threadIdx.x == 0) {
    int s = 0;
    for (int q = 0; q < cx.rank; ++q) s += src[q * W];
    fin[0] = s;
  }
  __syncthreads();
  return fin[0];
}

// One round of a row of nw words from every CTA's `acc` (this CTA's
// shared memory, written before the call, then a CTA barrier): the first
// nmax words reduced by a signed maximum (floats as okey, flags as 0 / 1),
// the rest by an integer sum in rank order (counts: exact). Every CTA gets
// the cluster's row in fin[0, nw) (nw <= cx.W). Ends with a CTA barrier.
static __device__ void cluster_row_round(Cluster& cx, const int* acc, int nmax, int nw, int* fin) {
  round_arm(cx, nw);
  for (int k = threadIdx.x >> 5; k < nw; k += CLUSTER_WARPS) round_put(cx, k, acc[k]);
  const int W = cx.W;
  const int* src = round_wait(cx);
  for (int k = threadIdx.x; k < nw; k += CLUSTER_THREADS) {
    int x = src[k];
    for (int q = 1; q < cx.C; ++q) x = k < nmax ? max(x, src[q * W + k]) : x + src[q * W + k];
    fin[k] = x;
  }
  __syncthreads();
}

// The static shared memory of a CTA of a cluster stage (the round slots
// are its dynamic shared memory)
struct StageShared {
  uint64_t mbar[2];
  u64 w64[CLUSTER_WARPS];
  int rx[RX_SCRATCH];  // the rounds' warp words
  int fin[RX_KEYS + 2];
  int hist[256];
  int sel[CLUSTER_WARPS + 3];
  int idx[32];
};

// This CTA's node slice [*a, *b) of NL nodes (cluster_setup's cut), for the
// stages that make no round
static __device__ __forceinline__ void cta_slice(int NL, int* a, int* b) {
  const int C = cluster_ctas(), chunk = (NL + C - 1) / C;
  *a = min(NL, cluster_rank() * chunk);
  *b = min(NL, *a + chunk);
}

// What cluster_block_top leaves: the block's usable and guarded counts and
// its top's size r = min(c, usable)
struct BlockTop {
  int U, gsum, r;
};

// The guard and the block's top on a cluster, each CTA on its node slice
// `rs` (rs.u the slice's usable prefixes, rewritten in place by the guard):
// an entry stays usable only if its key beats every OTHER node's first
// hidden entry (the global pairs (f1, i1) > (f2, i2)); then the top r =
// min(c, U) usable entries in pick order (all of them when r = U, else
// those at or above the r-th key, cluster_select_key) and their compaction
// in node order, CTA by CTA: emit(slot, l, k, key) for each, slot the
// entry's rank in node order over the block. c0[l]: node l's entries in the
// top. Every thread of the CTA calls it; its rounds: the counts and the key
// range, the radix select where r < U, the CTAs' offsets.
template <class Emit>
static __device__ BlockTop cluster_block_top(Cluster& cx, const RowSet& rs, int* u, int* c0,
                                             float f1, int i1, float f2, int i2, int c,
                                             StageShared& sc, const Emit& emit) {
  const int tid = threadIdx.x;
  int U = 0, gsum = 0, hmin = INT_HI, lmin = INT_HI;
  u64 kmax = 0;  // exact; (hmin, lmin) bounds the smallest key from below
  for (int l = tid; l < rs.cnt; l += CLUSTER_THREADS) {
    const int n = rs.lo + l;
    const float cut_s = n == i1 ? f2 : f1;
    const int cut_i = n == i1 ? i2 : i1;
    const float* row = rs.tab + (size_t)l * rs.S;
    const int u0 = u[l];
    int uu = 0;
    while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
    u[l] = uu;
    U += uu;
    gsum += u0 - uu;
    if (uu == 0) continue;
    // a node's keys fall along its prefix: its largest is its first
    const u64 k0 = entry_key(row[0], n, 0, rs.Bk), kl = entry_key(row[uu - 1], n, uu - 1, rs.Bk);
    if (k0 > kmax) kmax = k0;
    hmin = min(hmin, uokey((uint32_t)(kl >> 32)));
    lmin = min(lmin, uokey((uint32_t)kl));
  }
  int r3[4] = {U, gsum, hmin, lmin};
  const int op3[4] = {RX_SUM, RX_SUM, RX_MIN, RX_MIN};
  cluster_reduce<4, true>(cx, r3, op3, sc.rx, sc.fin, &kmax, sc.w64);
  const BlockTop bt = {r3[0], r3[1], min(c, r3[0])};
  const bool all = bt.r == bt.U;
  u64 T = 0;
  if (bt.r > 0 && !all) {
    const u64 kmin = ((u64)uounkey(r3[2]) << 32) | (u64)uounkey(r3[3]);
    T = cluster_select_key(cx, rs, bt.r, kmin, kmax, sc.hist, sc.sel, sc.rx, sc.fin, sc.w64);
  }
  int mine = 0;
  for (int l = tid; l < rs.cnt; l += CLUSTER_THREADS) {
    const int cnt = bt.r == 0 ? 0
                    : (all ? u[l] : count_at_least(rs.tab + (size_t)l * rs.S, rs.lo + l, u[l],
                                                   rs.Bk, T));
    c0[l] = cnt;
    mine += cnt;
  }
  int base = cluster_offset(cx, block_sum_int(mine, sc.idx), sc.fin);
  for (int l0 = 0; l0 < rs.cnt; l0 += CLUSTER_THREADS) {  // uniform trips: every thread scans
    const int l = l0 + tid;
    const int cnt = l < rs.cnt ? c0[l] : 0;
    int total;
    const int off = base + block_exclusive_scan(cnt, sc.idx, &total);
    const float* row = rs.tab + (size_t)l * rs.S;
    for (int k = 0; k < cnt; ++k) emit(off + k, l, k, entry_key(row[k], rs.lo + l, k, rs.Bk));
    base += total;
  }
  return bt;
}

// A cluster stage's start: the cluster over `NL` nodes (CTA r owning [r *
// chunk, (r + 1) * chunk)), its round slots (words W) in the dynamic shared
// memory, and the cluster barrier after which every CTA's mbarriers are
// visible
static __device__ __forceinline__ Cluster cluster_stage(int NL, int W, int* slots,
                                                        uint64_t* mbar) {
  Cluster cx = cluster_setup(NL, W, slots, mbar);
  cluster_barrier_uncounted();
  return cx;
}
