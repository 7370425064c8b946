// The scratch layout and the stacked vector of the affinity wave's sharded
// paths, shared by K9 (affinity_sharded.cu: the epoch path) and K11
// (affinity_rounds.cu: the sharded tail above the epoch limit, which
// launches K9's setup, front and table on the same scratch).

#pragma once

#include "affinity.cuh"
#include "common.cuh"

// the stacked vector: [0, 5) maxima over F_start of simon, nodeaff, taint,
// ip, pernode; [5, 7) of -simon, -ip; [7, 12), [12, 14) the same over F_hi;
// [14, 18) maxima over F_hi of -simon, -nodeaff, -taint, -ip; then Cw
// maxima of the weighted carriers' domains over F_hi and Cw of their
// negations
#define AS_FIXED 18

// The kernels read the tables through a view of the rank's block (its N is
// the block's NL) whose node-axis pointers ops/kernels.py rebases by the
// block's first node `lo` (wave_sharded.cuh); the scratch is indexed by
// global node over all N nodes of the mesh (the argument N).
//
// Float scratch (K5's layout): table [N, B+1]; ip_pref, simon_s, static,
// ip_raw, pernode0 [N] each; the live rows [slots, D1]; cnt_live, taken
// [D1] each; bound [N]; zone sums [Z]; then the gathered nodeaff, taint
// [N] each. Int scratch: feas, cap, dom_live, u, flags, counts, avail (the
// epoch's gathered, clamped) [N] each; edom_live, first_pos, consumed,
// everb [D1] each; then the gathered zone [N] and every slot's domain
// [slots, N] (the fold's). State: placed, last, epochs, head fallbacks,
// multi rounds, the epoch's bootstrap flag.
static __device__ __forceinline__ AffScratch aff_scratch(const TablesView& t, const Ctx& c, int B,
                                                         float* fs, int* is, int N) {
  const int D1 = t.D1, n_rows = c.off[SK_SS] + 1;
  AffScratch a;
  a.table = fs;
  a.ip_pref = a.table + (size_t)N * (B + 1);
  a.simon_s = a.ip_pref + N;
  a.stat = a.simon_s + N;
  a.ip_raw = a.stat + N;
  a.pn0 = a.ip_raw + N;
  a.rows = a.pn0 + N;
  a.cl = a.rows + (size_t)n_rows * D1;
  a.taken = a.cl + D1;
  a.bound = a.taken + D1;
  a.zone_sums = a.bound + N;
  a.feas = is;
  a.cap = a.feas + N;
  a.dom_live = a.cap + N;
  a.u = a.dom_live + N;
  a.flags = a.u + N;
  a.counts = a.flags + N;
  a.avail = a.counts + N;
  a.edom_live = a.avail + N;
  a.first_pos = a.edom_live + D1;
  a.consumed = a.first_pos + D1;
  a.everb = a.consumed + D1;
  return a;
}

// The rows the sharded paths gather for the tail (see aff_scratch)
struct AffGathered {
  float *nodeaff, *taint;
  int *zone, *fdom;
};

static __device__ __forceinline__ AffGathered aff_gathered(const TablesView& t, const AffScratch& a,
                                                           int N) {
  AffGathered x;
  x.nodeaff = a.zone_sums + t.Z;
  x.taint = x.nodeaff + N;
  x.zone = a.everb + t.D1;
  x.fdom = x.zone + N;
  return x;
}

// K9's payload row of a node: [table (B+1); F_start; F_hi; min(avail, B+1);
// ip_raw; pernode0; simon_s; nodeaff; taint; zone; dom_live; the AF_KEY and
// AF_SAME flags], then every slot's domain at the node: B + AS_PAY_FIXED +
// slots floats
#define AS_PAY_FIXED 12
