// The selection of one wave iteration on one block, K8's tail
// (wave_sharded.cu: on the gathered rows of every rank; K3 runs it on a
// cluster, wave.cu): given each node's score row, its usable prefix and
// its first hidden entry, the hidden-continuation guard, the radix select of
// the first min(m_rem, kmax, usable) entries in serial's pick order, the
// stop at the first node-exhausting pick when the normalizers over the
// shrunken feasible set differ, the head fallback, and j += the counts.

#pragma once

#include "common.cuh"
#include "select.cuh"

// What the selection reads of node n besides its row: `avail(n)`, the copies
// it has left (clamped to B+1, which no comparison below can tell apart),
// and `F(n)` or `F(n, avail)`, whether it is in the epoch's feasible set,
// from the gathered rows:
struct WaveNodesGathered {
  const int *F_s, *avail_s;
  __device__ __forceinline__ int avail(int n) const { return avail_s[n]; }
  __device__ __forceinline__ bool F(int n, int) const { return F_s[n]; }
  __device__ __forceinline__ bool F(int n) const { return F_s[n]; }
};

// N nodes, gN = g * N for group g's [G, N] rows; m - placed pods to place;
// table: row n of node n at table + n * S (S >= B + 1); u_s: each node's
// usable prefix (shrunk here by the guard); bound_s, (b1, i1): each node's
// first hidden entry and this thread's best of them; simon_s, ip_s: the
// normalizer inputs; c0_s: [N] scratch. Adds the counts to j, the head
// fallbacks to `heads` and the guarded entries to `guarded`; returns the
// number of pods taken. Block-uniform.
template <class Nodes>
static __device__ __forceinline__ int
wave_take(const TablesView& t, const Nodes& nd, int N, size_t gN, int m, int placed, int K,
          int B, bool anyF_b, const Norms& nm, const float* table, int S, const float* bound_s,
          const float* simon_s, const float* ip_s, int* u_s, int* c0_s, int* j, float b1, int i1,
          float* s_red, int* s_idx, u64* s_u64, int* hist, u64* s_prefix, int* s_rem, int& heads,
          int& guarded) {
  const int tid = threadIdx.x, bd = blockDim.x;
  block_argmax(&b1, &i1, s_red, s_idx);
  float b2 = -INFINITY;
  int i2 = 0x7fffffff;
  for (int n = tid; n < N; n += bd) argmax_update(n == i1 ? -INFINITY : bound_s[n], n, &b2, &i2);
  block_argmax(&b2, &i2, s_red, s_idx);

  // ---- the guard: an entry is takeable only if its key beats every OTHER
  // node's first hidden entry; usable prefixes shrink to the beating part
  int U = 0, gsum = 0;
  for (int n = tid; n < N; n += bd) {
    const float cut_s = n == i1 ? b2 : b1;
    const int cut_i = n == i1 ? i2 : i1;
    const float* row = table + (size_t)n * S;
    const int u0 = u_s[n];
    int uu = 0;
    while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
    u_s[n] = uu;
    U += uu;
    gsum += u0 - uu;
  }
  U = block_sum_int(U, s_idx);
  guarded += block_sum_int(gsum, s_idx);

  // ---- the first min(m_rem, kmax, U) entries in pick order
  const int m_rem = m - placed;
  const int m_cand = min(m_rem, min(K, U));
  const u64 T = m_cand > 0 ? select_key(table, S, u_s, N, B, m_cand, hist, s_prefix, s_rem) : 0;

  // ---- nodes the candidates exhaust, the normalizers without them, and
  // the best node-exhausting candidate
  float e6[6] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, INFINITY, INFINITY};
  u64 ex_best = 0;
  for (int n = tid; n < N; n += bd) {
    const float* row = table + (size_t)n * S;
    const int c0 = m_cand > 0 ? count_at_least(row, n, u_s[n], B, T) : 0;
    c0_s[n] = c0;
    const int avail = nd.avail(n);
    if (nd.F(n, avail) && c0 < max(avail, 1)) {
      e6[0] = fmaxf(e6[0], simon_s[n]);
      e6[1] = fmaxf(e6[1], t.nodeaff_raw[gN + n]);
      e6[2] = fmaxf(e6[2], t.taint_raw[gN + n]);
      e6[3] = fmaxf(e6[3], ip_s[n]);
      e6[4] = fminf(e6[4], simon_s[n]);
      e6[5] = fminf(e6[5], ip_s[n]);
    }
    // the entry that empties node n is usable iff its prefix reaches avail
    if (m_cand > 0 && avail >= 1 && u_s[n] == avail) {
      const u64 kx = entry_key(row[avail - 1], n, avail - 1, B);
      if (kx >= T && kx > ex_best) ex_best = kx;
    }
  }
  const int op6[6] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MIN};
  block_reduce<6>(e6, op6, s_red);
  ex_best = block_max_u64(ex_best, s_u64);
  const bool same = e6[0] == nm.simon_hi && e6[4] == nm.simon_lo
                    && fmaxf(e6[1], 0.0f) == nm.na_max && fmaxf(e6[2], 0.0f) == nm.t_max
                    && fmaxf(e6[3], 0.0f) == nm.ip_max && fminf(e6[5], 0.0f) == nm.ip_min;
  int m_take = m_cand;
  u64 cut = 0;  // 0: take the first m_cand entries (c0_s)
  if (!same && ex_best != 0) {
    // stop right after the first exhausting pick: its position is the
    // number of entries that come before it
    int above = 0;
    for (int n = tid; n < N; n += bd)
      above += count_above(table + (size_t)n * S, n, u_s[n], B, ex_best);
    const int p_ex = block_sum_int(above, s_idx);
    if (p_ex + 1 < m_cand) {
      m_take = p_ex + 1;
      cut = ex_best;
    }
  }

  // ---- guaranteed progress: serial's next pick is always the best head
  int head = -1;
  if (m_take == 0 && anyF_b && m_rem > 0) {
    float hv = -INFINITY;
    int hi = 0x7fffffff;
    for (int n = tid; n < N; n += bd)
      argmax_update(nd.F(n) ? table[(size_t)n * S] : -INFINITY, n, &hv, &hi);
    block_argmax(&hv, &hi, s_red, s_idx);
    head = hi;
    m_take = 1;
    ++heads;
  }
  for (int n = tid; n < N; n += bd) {
    const int c = head >= 0 ? (n == head)
                  : (cut ? count_at_least(table + (size_t)n * S, n, u_s[n], B, cut) : c0_s[n]);
    j[n] += c;
  }
  return m_take;
}
