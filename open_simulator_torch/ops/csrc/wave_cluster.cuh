// Device code of the cluster forms of K3 (wave.cu) and K5 (affinity_wave.cu):
// one lane's wave or epoch loop on a thread-block cluster of C CTAs
// (cluster.cuh), CTA r owning the node slice [r * chunk, (r + 1) * chunk).
// A loop step's cross-node values travel as cluster rounds (st.async into
// every CTA's slot, completing on its mbarrier; cluster.cuh):
//   - cluster_reduce: integer maxima and minima (floats as okey), integer
//     sums, and optionally one u64 maximum (a selection key), exact in any
//     grouping;
//   - cluster_top2: the two best (value, node) pairs in first-max order (the
//     wave's two-largest-bound cut), merged exactly from each CTA's two;
//   - cluster_select_key: the radix select of select.cuh as one cluster
//     round a byte, each CTA pushing its 256-bin histogram; it starts at the
//     first byte where the smallest and largest keys differ and stops early
//     once the remaining rank is the last entry of its bin.
// K8's and K9's tails select over the mesh's gathered rows with
// cluster_select_key, K10 and K11 their block tops, and K10 merges the
// gathered keys with it (merge.cuh GatheredKeys).

#pragma once

#include "cluster.cuh"
#include "select.cuh"

// Words of a CTA's slot in these rounds: a radix pass's histogram
#define RX_WORDS 256
// Most words of one cluster_reduce round
#define RX_KEYS 30
// The rounds' warp words in shared memory, also cta_prologue's s_warp
#define RX_SCRATCH ((MAX_SLOTS + 1) * CLUSTER_WARPS)

enum { RX_MAX = 0, RX_MIN = 1, RX_SUM = 2 };

// u32 -> i32 whose signed order is the unsigned order, and back
static __device__ __forceinline__ int uokey(uint32_t x) { return (int)(x ^ 0x80000000u); }
static __device__ __forceinline__ uint32_t uounkey(int k) { return (uint32_t)k ^ 0x80000000u; }

// okey with -0 as +0 (the order of argmax_update's float compares)
static __device__ __forceinline__ int okz(float x) { return okey(x == 0.0f ? 0.0f : x); }

static __device__ __forceinline__ int rx_warp(int x, int op) {
  return op == RX_SUM ? __reduce_add_sync(FULL_MASK, x)
                      : (op == RX_MIN ? __reduce_min_sync(FULL_MASK, x)
                                      : __reduce_max_sync(FULL_MASK, x));
}
static __device__ __forceinline__ int rx_ident(int op) {
  return op == RX_SUM ? 0 : (op == RX_MIN ? INT_HI : INT_LO);
}

// The warp's largest u64 (unsigned order); every lane gets it
static __device__ __forceinline__ u64 warp_max_u64(u64 x) {
  const int h = uokey((uint32_t)(x >> 32));
  const int mh = __reduce_max_sync(FULL_MASK, h);
  const int ml = __reduce_max_sync(FULL_MASK, h == mh ? uokey((uint32_t)x) : INT_LO);
  return ((u64)uounkey(mh) << 32) | (u64)uounkey(ml);
}

// One cluster round: each word k of this thread's v is reduced over the
// cluster by op[k] (signed max or min, or integer sum) and every thread gets
// the results back in v; with X64, *x64 becomes the cluster's largest u64 of
// every thread's *x64. Every thread of the CTA calls it. s_rx: RX_KEYS *
// CLUSTER_WARPS ints; fin: RX_KEYS + 2 ints; s_w64: CLUSTER_WARPS u64.
template <int NW, bool X64 = false>
static __device__ void cluster_reduce(Cluster& cx, int (&v)[NW], const int (&op)[NW], int* s_rx,
                                      int* fin, u64* x64 = nullptr, u64* s_w64 = nullptr) {
  static_assert(NW + (X64 ? 2 : 0) <= RX_KEYS, "too many words for one round");
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  round_arm(cx, NW + (X64 ? 2 : 0));
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int r = rx_warp(v[k], op[k]);
    if (lane == 0) s_rx[k * CLUSTER_WARPS + wid] = r;
  }
  if (X64) {
    const u64 w = warp_max_u64(*x64);
    if (lane == 0) s_w64[wid] = w;
  }
  __syncthreads();
  for (int k = wid; k < NW; k += CLUSTER_WARPS)
    round_put(cx, k, rx_warp(lane < CLUSTER_WARPS ? s_rx[k * CLUSTER_WARPS + lane]
                                                  : rx_ident(op[k]), op[k]));
  if (X64 && wid == CLUSTER_WARPS - 1) {
    const u64 w = warp_max_u64(lane < CLUSTER_WARPS ? s_w64[lane] : 0ull);
    round_put(cx, NW, (int)(uint32_t)(w >> 32));
    round_put(cx, NW + 1, (int)(uint32_t)w);
  }
  const int W = cx.W;
  const int* src = round_wait(cx);
  for (int k = wid; k < NW; k += CLUSTER_WARPS) {
    const int r = rx_warp(lane < cx.C ? src[lane * W + k] : rx_ident(op[k]), op[k]);
    if (lane == 0) fin[k] = r;
  }
  if (X64 && wid == CLUSTER_WARPS - 1) {
    const u64 w = warp_max_u64(
        lane < cx.C ? ((u64)(uint32_t)src[lane * W + NW] << 32) | (uint32_t)src[lane * W + NW + 1]
                    : 0ull);
    if (lane == 0) {
      fin[NW] = (int)(uint32_t)(w >> 32);
      fin[NW + 1] = (int)(uint32_t)w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NW; ++k) v[k] = fin[k];
  if (X64) *x64 = ((u64)(uint32_t)fin[NW] << 32) | (uint32_t)fin[NW + 1];
}

// Insert (v, n) into a thread's two best pairs in first-max order
// (argmax_update's: value desc, node asc): (b1, i1) the first max, (b2, i2)
// the first max without node i1.
static __device__ __forceinline__ void top2_update(float v, int n, float& b1, int& i1, float& b2,
                                                   int& i2) {
  if (v > b1 || (v == b1 && n < i1)) {
    b2 = b1;
    i2 = i1;
    b1 = v;
    i1 = n;
  } else if (v > b2 || (v == b2 && n < i2)) {
    b2 = v;
    i2 = n;
  }
}

// The two best of the warp's lanes' pairs (k1, n1) >= (k2, n2) (okz keys):
// the first max over the firsts, then over the others' firsts and the
// winner's second. Every lane gets them.
static __device__ __forceinline__ void warp_top2(int k1, int n1, int k2, int n2, int* out) {
  const int m1 = __reduce_max_sync(FULL_MASK, k1);
  const int j1 = __reduce_min_sync(FULL_MASK, k1 == m1 ? n1 : INT_HI);
  const bool own = k1 == m1 && n1 == j1;
  const int ka = own ? k2 : k1, na = own ? n2 : n1;
  const int m2 = __reduce_max_sync(FULL_MASK, ka);
  const int j2 = __reduce_min_sync(FULL_MASK, ka == m2 ? na : INT_HI);
  out[0] = m1;
  out[1] = j1;
  out[2] = m2;
  out[3] = j2;
}

// The cluster's two best (value, node) pairs from every thread's two (see
// top2_update); every thread gets them. One round; s_rx holds 4 *
// CLUSTER_WARPS ints.
static __device__ void cluster_top2(Cluster& cx, float& b1, int& i1, float& b2, int& i2,
                                    int* s_rx, int* fin) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  round_arm(cx, 4);
  int w[4];
  warp_top2(okz(b1), i1, okz(b2), i2, w);
  if (lane == 0)
    for (int k = 0; k < 4; ++k) s_rx[wid * 4 + k] = w[k];
  __syncthreads();
  if (wid == 0) {
    const bool ok = lane < CLUSTER_WARPS;
    warp_top2(ok ? s_rx[lane * 4] : INT_LO, ok ? s_rx[lane * 4 + 1] : INT_HI,
              ok ? s_rx[lane * 4 + 2] : INT_LO, ok ? s_rx[lane * 4 + 3] : INT_HI, w);
    for (int k = 0; k < 4; ++k) round_put(cx, k, w[k]);
  }
  const int W = cx.W;
  const int* src = round_wait(cx);
  if (wid == 0) {
    const bool ok = lane < cx.C;
    warp_top2(ok ? src[lane * W] : INT_LO, ok ? src[lane * W + 1] : INT_HI,
              ok ? src[lane * W + 2] : INT_LO, ok ? src[lane * W + 3] : INT_HI, w);
    if (lane == 0)
      for (int k = 0; k < 4; ++k) fin[k] = w[k];
  }
  __syncthreads();
  b1 = ounkey(fin[0]);
  i1 = fin[1];
  b2 = ounkey(fin[2]);
  i2 = fin[3];
}

// The usable entries of one CTA's nodes for the selection: `cnt` nodes from
// global node `lo`, node l's row at tab + l * S with usable prefix u[l]
// (at most A entries), entry (n, k) keyed entry_key(row[k], n, k, Bk).
// A key source of cluster_select_key: slots() flat slots, key_at(e, &key)
// whether slot e holds a key (and which), max_comp(mask, prefix) the
// largest complement of this thread's keys whose bits under mask equal
// prefix (0 for none).
struct RowSet {
  const float* tab;
  int S;
  const int* u;
  int lo, cnt, A, Bk;
  __device__ __forceinline__ unsigned slots() const { return (unsigned)cnt * (unsigned)A; }
  __device__ __forceinline__ bool key_at(unsigned e, u64* key) const {
    const int l = (int)(e / (unsigned)A), k = (int)(e - (unsigned)l * A);
    if (k >= u[l]) return false;
    *key = entry_key(tab[(size_t)l * S + k], lo + l, k, Bk);
    return true;
  }
  __device__ __forceinline__ u64 max_comp(u64 mask, u64 prefix) const {
    u64 best = 0;
    for (int l = threadIdx.x; l < cnt; l += CLUSTER_THREADS) {
      const float* row = tab + (size_t)l * S;
      for (int k = 0; k < u[l]; ++k) {
        const u64 key = entry_key(row[k], lo + l, k, Bk);
        if ((key & mask) == prefix && ~key > best) best = ~key;
      }
    }
    return best;
  }
};

// The smallest key of `ks` whose bits under `mask` equal `prefix`, over the
// cluster (at least one exists). One round.
template <class Keys>
static __device__ u64 cluster_min_match(Cluster& cx, const Keys& ks, u64 mask, u64 prefix,
                                        int* s_rx, int* fin, u64* s_w64) {
  u64 best = ks.max_comp(mask, prefix);  // the largest complement
  int none[1] = {0};
  const int op[1] = {RX_SUM};
  cluster_reduce<1, true>(cx, none, op, s_rx, fin, &best, s_w64);
  return ~best;
}

// The key of the r-th best key of the key source `ks` (a RowSet, or
// merge.cuh's GatheredKeys) over the cluster (1 <= r <= the key count),
// every key lying in [kmin, kmax]: an MSB-first radix
// select from the first byte where kmin and kmax differ, one cluster round
// a byte (each CTA's 256-bin histogram, warp-aggregated), ending with one
// cluster_min_match round where the remaining rank is the last entry of
// its bin. Every thread gets the key. s_hist: 256 ints; s_sel:
// CLUSTER_WARPS + 3 ints.
template <class Keys>
static __device__ u64 cluster_select_key(Cluster& cx, const Keys& ks, int r, u64 kmin, u64 kmax,
                                         int* s_hist, int* s_sel, int* s_rx, int* fin,
                                         u64* s_w64) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const u64 x = kmin ^ kmax;
  if (!x) return kmax;  // one key
  int shift = ((63 - __clzll((long long)x)) >> 3) << 3;
  u64 mask = shift >= 56 ? 0ull : ~0ull << (shift + 8);
  u64 prefix = kmax & mask;
  int rem = r;
  const unsigned E = ks.slots();
  for (; shift >= 0; shift -= 8) {
    for (int d = tid; d < 256; d += CLUSTER_THREADS) s_hist[d] = 0;
    __syncthreads();
    for (unsigned e0 = 0; e0 < E; e0 += CLUSTER_THREADS) {  // uniform trips: warps converged
      const unsigned e = e0 + tid;
      int digit = 256;
      if (e < E) {  // nested ifs: one && form costs K3 (EXT) 12 bytes more of spills
        u64 key;
        if (ks.key_at(e, &key)) {
          if ((key & mask) == prefix) digit = (int)((key >> shift) & 255u);
        }
      }
      const unsigned peers = __match_any_sync(FULL_MASK, digit);
      if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&s_hist[digit], __popc(peers));
    }
    __syncthreads();
    round_arm(cx, 256);
    for (int k = wid; k < 256; k += CLUSTER_WARPS) round_put(cx, k, s_hist[k]);
    const int W = cx.W;
    const int* src = round_wait(cx);
    // thread t < 256 holds digit 255 - t: the cluster's count, then an
    // inclusive scan in descending digit order
    int tot = 0;
    if (tid < 256)
      for (int q = 0; q < cx.C; ++q) tot += src[q * W + 255 - tid];
    int incl = tot;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (tid < 256 && lane == 31) s_sel[3 + wid] = incl;
    __syncthreads();
    if (tid < 256) {
      for (int w = 0; w < wid; ++w) incl += s_sel[3 + w];
      const int excl = incl - tot;
      if (excl < rem && rem <= incl) {
        s_sel[0] = 255 - tid;
        s_sel[1] = rem - excl;
        s_sel[2] = tot;
      }
    }
    __syncthreads();
    const int d = s_sel[0], in_bin = s_sel[2];
    rem = s_sel[1];
    prefix |= (u64)d << shift;
    mask |= 255ull << shift;
    if (shift > 0 && rem == in_bin)
      return cluster_min_match(cx, ks, mask, prefix, s_rx, fin, s_w64);
  }
  return prefix;
}
