// Hand-written Hopper kernels for the affinity wave's sharded tail above the
// epoch limit.
//
// K11 replaces the form of open_simulator_tpu/ops/kernels.py
//    `schedule_affinity_wave` that the JAX package keeps above
//    OPEN_SIMULATOR_EPOCH_AMORTIZE_MAX_NODES on a node mesh (the `else` at
//    :2095-2096: the plain `while_loop` over the epoch body, whose front
//    `epoch_head` :1568, `apply_zone` :1680 and tail `epoch_tail`
//    :1714-1964 XLA's GSPMD partitions over the node-sharded inputs). Rank
//    r of a mesh of R ranks works on its node block [lo, hi), NL = N / R,
//    the only part of the tables and the carry it holds (the partitioned
//    layout, viewed as affinity_sharded.cuh says): every per-node stage
//    reads the block only; the rounds run on every rank on the merged
//    candidate list and the replicated [D+1] counters, and the fold reads
//    the term domains the candidates and the heads carried.
//    The rule (parallel/mesh.py `round_shards`): a 1-D node mesh of more
//    than one shard, N a multiple of it and N above the limit.
//
// One segment: K9's setup once (affinity_sharded.cu, on K9's scratch, the
// block), then
// per epoch, launched by ops/kernels.py
// `schedule_affinity_wave_rounds_kernel`, one block each:
//   front    (K9's, the block): the live gates, F_start, F_hi, ip_raw and
//            the SelectorSpread counts, and K9's stacked vector of maxima;
//   flags    (the block): any(F_hi), any(F_start), any(F_start on a zone),
//            whether a node's live budget terms leave its composed domain,
//            and with ss_live the block's [Z] zone sums of the counts over
//            F_start, after the stacked vector in the same row;
//   -- all_gather_rows #1 of the rows --
//   reduce   (replicated): the maxima by max, the zone sums by a
//            left-to-right sum in rank order; the epoch's gates (uniform
//            base, ip and zone liveness, the normalizer test, bootstrap) and
//            use_multi_pre;
//   table    (K9's, the block): the block's [B+1] score rows;
//   summary  (the block): the SelectorSpread blend into the table rows,
//            each node's usable prefix and first hidden entry, the block's
//            first two maxima of that bound and its best head as (value,
//            global node) with every term's domain at that head, and its
//            usable count;
//   -- all_gather_rows #2 of the summaries; the host reads use_multi_pre
//      and any(F_start); without use_multi_pre: finish (the head) --
//   select   (the block): the guard from the global pairs, the radix select
//            of the block's top c = min(K_EP, NL*B) entries, emitted as
//            [c] (global key, dom_live, every term's domain) rows, 0 keys
//            after the block's own, then (guarded usable count, 0, ...);
//   -- all_gather_rows #3 of the [c+1] rows --
//   merge    (replicated): the radix select of the top K_EP of the R*c keys,
//            their bitonic sort, each position's carried domain, and the
//            rounds (affinity.cuh `affinity_rounds`, K5's and K9's), with
//            no collective; the host reads the pods they took;
//   sandwich (the block, when they took pods): the lower set's maxima over
//            the block (the ever-blocked domains expanded to the block's
//            nodes, the exhausted nodes left out), the minima negated;
//   -- pmax #4 of those seven --
//   finish   (replicated): the sandwich's test, the head fallback from the
//            gathered heads, the fold into j and the live rows (the term
//            domains from the merged rows or the head's summary), the loop
//            state (placed, last, epochs, head fallbacks, multi rounds).
// Collectives per epoch: 2 (the head fallback without use_multi_pre), 3
// (rounds that took nothing), 4 (a sandwich); the host reads one to three
// small values per epoch.
//
// Exactness against K5 (and the plain `epoch` of ops/kernels.py):
// - the per-node floats are K9's: the block's rows are the unsharded rows;
// - maxima are exact in any order, and mins ride negated (-max(-x) ==
//   min(x), +-inf included); the flags ride as 0/1 maxima;
// - the zone sums and every count are integer-valued f32 below 2^24, so
//   their sums are exact in any order (the reduce adds them in rank order);
// - ties break on the global node index (the bound and head pairs, by
//   value desc, node asc) and the global flat position n*B+k (the 64-bit
//   key of select.cuh); the block's select runs on local keys, whose order
//   is the global keys', and emits global keys;
// - the merge sees the unsharded top K_EP keys: that top holds at most
//   min(K_EP, NL*B) = c entries of any block and each block offers its own
//   top c, so the top of the union of the blocks' tops is the unsharded
//   top; the domains travel with the keys and the pads (key 0) are no
//   candidates;
// - the rounds keep one "ever blocked" bit per domain where JAX ORs
//   blocked_d[dom_live] into a per-node mask: dom_live is fixed within an
//   epoch, so a node's bit is its domain's, and the sandwich reads it on
//   the block;
// - ROADMAP §B's invariants: compiled with --fmad=false, no log here (the
//   setup's interpod term keeps common.cuh's f64 log, rounded once), and
//   only integer-valued atomics. The rounds inherit K5's sentinel-domain
//   behaviour (ROADMAP §C3).
//
// What bounds it on an H100: latency. Every stage is one block of 1,024
// threads: the block's select makes 8 radix passes over its NL*B entries
// and the merge 8 over R*c keys, then the rounds' block-wide scans per
// round. Per epoch the host makes two to four collectives and one to three
// reads. The bytes it must move per epoch are the block's table and the
// merged list (ops: counted in chip_smoke.py `k11_cost`).
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "affinity.cuh"
#include "affinity_sharded.cuh"
#include "common.cuh"
#include "merge.cuh"
#include "select.cuh"

// K11's loop state after K9's seven: the epoch's use_multi_pre, any(F_start),
// uniform base and zoned-start flags, then the rounds' pods and productive
// rounds
enum { ST_MULTI_PRE = 7, ST_ANY_START, ST_UNIFORM, ST_ZONED, ST_GOT, ST_ROUNDS, ST_INTS = 16 };

// A position's budget domain as the merged entry carried it
struct DomCarried {
  const int* s_dom;
  __device__ __forceinline__ int operator()(int p, int) const { return s_dom[p]; }
};

// The epoch's normalizer vector in K5's order (maxima, then the minima of
// simon and ip, over F_start and over F_hi) from the reduced stacked vector
static __device__ __forceinline__ void k5_order(const float* red, float (&v)[14]) {
  for (int i = 0; i < 14; ++i) v[i] = (i == 5 || i == 6 || i == 12 || i == 13) ? -red[i] : red[i];
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_flags(TablesView t, int g, int B, int N, int lo, int hi, int ss_live, float* fs,
                      int* is, float* part, int p0) {
  __shared__ Ctx c;
  const int tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) affinity_slots(t, g, &c);
  float* zs = part + p0 + 4;
  if (ss_live)
    for (int z = tid; z < t.Z; z += bd) zs[z] = 0.0f;
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  bool h = false, s = false, hz = false, ns = false;
  for (int n = lo + tid; n < hi; n += bd) {
    const int fl = a.flags[n];
    h |= (fl & AF_HI) != 0;
    ns |= !(fl & AF_SAME);
    if (!(fl & AF_START)) continue;
    s = true;
    const int zone = t.node_zone[n];
    hz |= zone > 0;
    if (ss_live) atomicAdd(&zs[zone], a.pn0[n]);  // integer counts: exact
  }
  const bool any_hi = __syncthreads_or(h);
  const bool any_start = __syncthreads_or(s);
  const bool zoned = __syncthreads_or(hz);
  const bool not_same = __syncthreads_or(ns);
  if (tid == 0) {
    part[p0] = any_hi ? 1.0f : 0.0f;
    part[p0 + 1] = any_start ? 1.0f : 0.0f;
    part[p0 + 2] = zoned ? 1.0f : 0.0f;
    part[p0 + 3] = not_same ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_reduce(TablesView t, int g, int B, int N, int ss_live, int R, int P1,
                       const float* rows1, float* red, float* fs, int* is, int* state) {
  __shared__ Ctx c;
  const int tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int Cw = c.n[SK_CW], p0 = AS_FIXED + 2 * Cw;
  for (int i = tid; i < p0 + 4; i += bd) {
    float x = rows1[i];
    for (int r = 1; r < R; ++r) x = fmaxf(x, rows1[(size_t)r * P1 + i]);
    red[i] = x;
  }
  if (ss_live) {
    for (int z = tid; z < t.Z; z += bd) {
      float x = rows1[p0 + 4 + z];
      for (int r = 1; r < R; ++r) x = x + rows1[(size_t)r * P1 + p0 + 4 + z];
      a.zone_sums[z] = x;
    }
  }
  __syncthreads();
  if (tid != 0) return;
  // the gates of K9's tail, from the reduced values
  float v[14];
  k5_order(red, v);
  const bool any_hi = red[p0] > 0.0f, any_start = red[p0 + 1] > 0.0f;
  const bool zoned = red[p0 + 2] > 0.0f;
  const bool uniform_base = v[7] == -red[14] && v[8] == -red[15] && v[9] == -red[16]
                            && v[10] == -red[17] && any_hi;
  bool dom_same = true;
  for (int s = 0; s < Cw; ++s)
    if (c.slot[SK_CW][s].live && red[AS_FIXED + s] != -red[AS_FIXED + Cw + s]) dom_same = false;
  const bool ip_safe = !c.has_live_cw || !any_hi || (dom_same && v[10] == v[13]);
  bool pre_norms_ok = uniform_base || (v[0] == v[7] && v[1] == v[8] && v[2] == v[9]
                                       && v[3] == v[10] && v[5] == v[12] && v[6] == v[13]);
  if (ss_live) pre_norms_ok = pre_norms_ok && v[4] == v[11];
  const bool ss_multi_ok = !ss_live || !zoned;
  const bool doms_same = !(red[p0 + 3] > 0.0f);
  const bool budget_composes = c.n_budget <= 1 || (c.n_dns == 0 && doms_same);
  state[ST_MULTI_PRE] = budget_composes && !state[5] && ip_safe && ss_multi_ok && pre_norms_ok;
  state[ST_ANY_START] = any_start;
  state[ST_UNIFORM] = uniform_base;
  state[ST_ZONED] = zoned;
}

// summary row: [b1, i1, b2, i2, head, head node, usable count, 0], then
// every term slot's domain at the head node (K9's payload order)
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_summary(TablesView t, int g, int B, int N, int lo, int hi, int ss_live,
                        const int* j, float* fs, int* is, const float* red, const float* pay,
                        const int* state, double* summ) {
  __shared__ Ctx c;
  __shared__ float s_red[8 * 32];
  __shared__ int s_idx[32];
  const int tid = threadIdx.x, bd = blockDim.x, B1 = B + 1;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int P = B + AS_PAY_FIXED + c.off[SK_SS] + 1;
  const bool use_multi_pre = state[ST_MULTI_PRE], zoned = state[ST_ZONED];
  const float maxN = fmaxf(red[4], 0.0f);
  float maxZ = 0.0f;
  if (ss_live)
    for (int z = 1; z < t.Z; ++z) maxZ = fmaxf(maxZ, a.zone_sums[z]);
  const int ncols = use_multi_pre ? B1 : 1;
  float b1 = -INFINITY, hv = -INFINITY;
  int i1 = 0x7fffffff, ih = 0x7fffffff, nU = 0;
  for (int n = lo + tid; n < hi; n += bd) {
    const int fl = a.flags[n];
    int u = 0;
    float bound = -INFINITY;
    if (fl & AF_HI) {  // F_start is inside F_hi
      const float* src = pay + (size_t)(n - lo) * P;
      const int zone = t.node_zone[n];
      const bool blend = zoned && zone > 0;
      const float zs = ss_live ? a.zone_sums[zone] : 0.0f;
      float* row = a.table + (size_t)n * B1;
      int first_bad = B;
      float prev = 0.0f;
      for (int k = 0; k < ncols; ++k) {
        float val = src[k];
        if (ss_live)
          val = val + t.w[W_SS] * floorf(selector_spread_blend(a.pn0[n] + (float)k, maxN, zs,
                                                               maxZ, blend));
        row[k] = val;
        if (k > 0 && k < B && first_bad == B && val > prev) first_bad = k;
        prev = val;
      }
      if (use_multi_pre) {
        const int avail = a.cap[n] - j[n];
        const int k_cap = ss_live ? (int)fminf(fmaxf(maxN - a.pn0[n], 0.0f), (float)B) : B;
        u = max(0, min(min(avail, k_cap), first_bad));
        const int k_hid = min(first_bad, k_cap);
        if (k_hid < avail) bound = row[k_hid];
      }
      if (fl & AF_START) argmax_update(row[0], n, &hv, &ih);
    }
    a.u[n] = u;
    nU += u;
    if (use_multi_pre) {
      a.bound[n] = bound;
      argmax_update(bound, n, &b1, &i1);
    }
  }
  block_argmax(&b1, &i1, s_red, s_idx);
  float b2 = -INFINITY;
  int i2 = 0x7fffffff;
  if (use_multi_pre)
    for (int n = lo + tid; n < hi; n += bd)
      argmax_update(n == i1 ? -INFINITY : a.bound[n], n, &b2, &i2);
  block_argmax(&b2, &i2, s_red, s_idx);
  block_argmax(&hv, &ih, s_red, s_idx);
  nU = block_sum_int(nU, s_idx);
  if (tid == 0) {
    summ[0] = b1;
    summ[1] = i1;
    summ[2] = b2;
    summ[3] = i2;
    summ[4] = hv;
    summ[5] = ih;
    summ[6] = nU;
    summ[7] = 0.0;
  }
  const bool own = ih >= lo && ih < hi;  // no F_start node: no head, the domains unread
  for (int k = 0; k < N_KINDS; ++k)
    for (int s = tid; s < c.n[k]; s += bd)
      summ[8 + c.off[k] + s] = own ? (double)slot_dom(t, k, c.slot[k][s].id, ih) : 0.0;
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_select(TablesView t, int g, int B, int N, int lo, int hi, int c_, int R,
                       float* fs, int* is, const double* summ_all, long long* cand) {
  __shared__ Ctx c;
  __shared__ int s_idx[32];
  __shared__ int hist[256];
  __shared__ u64 s_prefix;
  __shared__ int s_rem;
  const int tid = threadIdx.x, bd = blockDim.x, B1 = B + 1, NL = hi - lo;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int n_rows = c.off[SK_SS] + 1, SW = 8 + n_rows, CW = 2 + n_rows;

  // ---- the global pairs: the best block first, then the best of the other
  // blocks' firsts and the winner's second
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
  const float f1 = (float)b1, f2 = (float)b2;
  const int i1 = (int)g1, i2 = (int)g2;

  // ---- the guard on the block: an entry is usable only if its key beats
  // every OTHER node's first hidden entry
  int U = 0;
  for (int n = lo + tid; n < hi; n += bd) {
    const float cut_s = n == i1 ? f2 : f1;
    const int cut_i = n == i1 ? i2 : i1;
    const float* row = a.table + (size_t)n * B1;
    const int u0 = a.u[n];
    int uu = 0;
    while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
    a.u[n] = uu;
    U += uu;
  }
  U = block_sum_int(U, s_idx);

  // ---- the block's top r = min(c, U) on local keys, emitted as global keys
  const float* tbl = a.table + (size_t)lo * B1;
  const int r = min(c_, U);
  const u64 T = r > 0 ? select_key(tbl, B1, a.u + lo, NL, B, r, hist, &s_prefix, &s_rem) : 0;
  int base = 0;
  for (int n0 = 0; n0 < NL; n0 += bd) {  // uniform trip count: every thread scans
    const int nl = n0 + tid;
    const float* row = tbl + (size_t)nl * B1;
    const int cnt = (r > 0 && nl < NL) ? count_at_least(row, nl, a.u[lo + nl], B, T) : 0;
    int total;
    const int off = base + block_exclusive_scan(cnt, s_idx, &total);
    for (int k = 0; k < cnt; ++k) {
      long long* out = cand + (size_t)(off + k) * CW;
      out[0] = (long long)entry_key(row[k], lo + nl, k, B);
      out[1] = a.dom_live[lo + nl];
      for (int q = 0; q < N_KINDS; ++q)
        for (int s = 0; s < c.n[q]; ++s)
          out[2 + c.off[q] + s] = slot_dom(t, q, c.slot[q][s].id, lo + nl);
    }
    base += total;
  }
  for (size_t i = (size_t)r * CW + tid; i < (size_t)c_ * CW; i += bd) cand[i] = 0;
  for (int i = tid; i < CW; i += bd) cand[(size_t)c_ * CW + i] = i == 0 ? U : 0;
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_merge(TablesView t, int g, int m, int B, int N, int c_, int R, float* fs, int* is,
                      const long long* rows, int* state) {
  __shared__ Ctx c;
  __shared__ float s_red[8 * 32];
  __shared__ int s_int[32];
  __shared__ u64 s_key[K_EP_MAX];
  __shared__ int s_occ[K_EP_MAX];
  __shared__ int s_dom[K_EP_MAX];
  __shared__ int hist[256];
  __shared__ int s_prise[LMAX + 2], s_prov[LMAX + 2], s_hist[LMAX + 2];
  __shared__ u64 s_prefix;
  __shared__ int s_rem, s_cnt, s_L, s_PL;
  const int D1 = t.D1, tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) {
    affinity_slots(t, g, &c);
    s_cnt = 0;
  }
  if (tid < LMAX + 2) {
    s_prise[tid] = -1;
    s_prov[tid] = 0;
    s_hist[tid] = 0;
  }
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const AffGathered ga = aff_gathered(t, a, N);
  const AffDims dm = {N, D1, D1 - 1, B, B + 1, t.Z, min(N * B, K_EP_MAX), N * B + 1, 0};
  const int total = R * c_, n_rows = c.off[SK_SS] + 1, CW = 2 + n_rows;

  // ---- the global top: the n_cand = min(K_EP, keys) best gathered keys
  int nk = 0;
  for (int e = tid; e < total; e += bd) {
    const int rk = e / c_, s = e - rk * c_;
    nk += rows[((size_t)rk * (c_ + 1) + s) * CW] != 0;
  }
  nk = block_sum_int(nk, s_int);
  const int n_cand = min(nk, dm.K_EP);
  const u64 T =
      n_cand > 0 ? select_gathered(rows, R, c_, n_cand, hist, &s_prefix, &s_rem, CW) : 0;
  for (int e = tid; e < total; e += bd) {
    const int rk = e / c_, s = e - rk * c_;
    const long long* row = rows + ((size_t)rk * (c_ + 1) + s) * CW;
    const u64 key = (u64)row[0];
    if (key == 0 || key < T) continue;
    s_key[atomicAdd(&s_cnt, 1)] = key;
    // the term domains at its node, for the fold (every key of a node
    // carries the same)
    const int node = key_node(key, B);
    for (int r = 0; r < n_rows; ++r) ga.fdom[(size_t)r * N + node] = (int)row[2 + r];
  }
  int L = 2;
  while (L < n_cand) L <<= 1;
  __syncthreads();
  for (int i = n_cand + tid; i < L; i += bd) s_key[i] = 0ull;
  bitonic_sort<u64, true>(s_key, L);
  // each merged key's position (the keys are distinct and sorted
  // descending), and the domain it carried there
  for (int e = tid; e < total; e += bd) {
    const int rk = e / c_, s = e - rk * c_;
    const long long* row = rows + ((size_t)rk * (c_ + 1) + s) * CW;
    const u64 key = (u64)row[0];
    if (key == 0 || key < T) continue;
    int lo_p = 0, hi_p = n_cand - 1;
    while (lo_p < hi_p) {
      const int mid = (lo_p + hi_p) >> 1;
      if (s_key[mid] > key) lo_p = mid + 1;
      else hi_p = mid;
    }
    s_dom[lo_p] = (int)row[1];
  }
  __syncthreads();

  // ---- the rounds, replicated, on the merged list
  const AffShared sh = {s_red, s_int, s_occ, hist, s_prise, s_prov, s_hist, &s_rem, &s_cnt,
                        &s_L, &s_PL, s_key, &s_prefix};
  int rounds = 0;
  const int got = affinity_rounds(c, a, sh, dm, m - state[0], n_cand, L, c.n_budget >= 1,
                                  c.n_dns > 0, c.inc_live, DomCarried{s_dom}, rounds);
  if (tid == 0) {
    state[ST_GOT] = got;
    state[ST_ROUNDS] = rounds;
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_sandwich(TablesView t, int g, int B, int N, int lo, int hi, const int* j,
                         float* fs, int* is, float* part) {
  __shared__ Ctx c;
  __shared__ float s_red[8 * 32];
  if (threadIdx.x == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  // the lower set reads the block's rows of the rebased view
  const AffDims dm = {N, t.D1, t.D1 - 1, B, B + 1, t.Z, min(N * B, K_EP_MAX), N * B + 1,
                      (size_t)g * t.N};
  float w7[7];
  affinity_lower_set(t, a, AvailLive{a.cap, j}, dm, lo, hi, c.n_budget >= 1, w7, s_red);
  if (threadIdx.x < 7) part[threadIdx.x] = threadIdx.x < 5 ? w7[threadIdx.x] : -w7[threadIdx.x];
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_finish(TablesView t, int g, int m, int ss_live, int B, int N, int R, int* j,
                       float* fs, int* is, const float* red, const float* red4,
                       const double* summ_all, int* state) {
  __shared__ Ctx c;
  if (threadIdx.x == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const AffGathered ga = aff_gathered(t, a, N);
  const AffDims dm = {N, t.D1, t.D1 - 1, B, B + 1, t.Z, min(N * B, K_EP_MAX), N * B + 1, 0};
  const int n_rows = c.off[SK_SS] + 1, SW = 8 + n_rows;
  const int placed = state[0], got = state[ST_GOT], rounds = state[ST_ROUNDS];
  // ---- the normalizer sandwich (red4: the lower set's maxima, the minima
  // negated; null when the rounds took nothing)
  bool use_multi = false;
  if (red4 != nullptr) {
    float v[14];
    k5_order(red, v);
    bool lo_ok = state[ST_UNIFORM] || (v[7] == red4[0] && v[8] == red4[1] && v[9] == red4[2]
                                       && v[10] == red4[3] && v[12] == -red4[5]
                                       && v[13] == -red4[6]);
    if (ss_live) lo_ok = lo_ok && v[11] == red4[4];
    use_multi = lo_ok;
  }
  // ---- the head fallback from the gathered heads (value desc, node asc)
  int head = -1, head_r = 0;
  if (!use_multi && state[ST_ANY_START] && placed < m) {
    double hv = -INFINITY, hn = 2147483647.0;
    for (int r = 0; r < R; ++r) {
      const double v = summ_all[r * SW + 4], i = summ_all[r * SW + 5];
      if (v > hv || (v == hv && i < hn)) {
        hv = v;
        hn = i;
        head_r = r;
      }
    }
    head = (int)hn;
  }
  // the head's term domains, from its block's summary (the merged
  // candidates' are in place from the merge)
  if (head >= 0)
    for (int r = threadIdx.x; r < n_rows; r += blockDim.x)
      ga.fdom[(size_t)r * N + head] = (int)summ_all[head_r * SW + 8 + r];
  __syncthreads();
  const int m_take = use_multi ? got : (head >= 0 ? 1 : 0);
  // ends with a barrier: state read above
  affinity_fold<true>(t, c, a, dm, use_multi, head, j, ga.fdom);
  if (threadIdx.x == 0) {
    state[0] = placed + m_take;
    state[1] = m_take;
    state[2] += 1;
    state[3] += head >= 0;
    state[4] += use_multi ? rounds : 0;
  }
}

// ------------------------------------------------------------ C interface --

extern "C" {

int affinity_rounds_state_ints() { return ST_INTS; }

// t: the block's view, rebased by lo (affinity_sharded.cuh); N: the mesh's
// nodes. The summary rows hold 8 + slots doubles and the candidate rows
// 2 + slots ints, slots = Sd + A + B + Ca + Cw + 1.
int affinity_rounds_flags_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                 int ss_live, float* fs, int* is, float* part, int p0,
                                 cudaStream_t stream) {
  affinity_rounds_flags<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, ss_live, fs, is,
                                                         part, p0);
  return (int)cudaGetLastError();
}

int affinity_rounds_reduce_launch(const TablesView* t, int g, int B, int N, int ss_live, int R,
                                  int P1, const float* rows1, float* red, float* fs, int* is,
                                  int* state, cudaStream_t stream) {
  affinity_rounds_reduce<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, ss_live, R, P1, rows1, red,
                                                          fs, is, state);
  return (int)cudaGetLastError();
}

int affinity_rounds_summary_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                   int ss_live, const int* j, float* fs, int* is,
                                   const float* red, const float* pay, const int* state,
                                   double* summ, cudaStream_t stream) {
  affinity_rounds_summary<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, ss_live, j, fs,
                                                           is, red, pay, state, summ);
  return (int)cudaGetLastError();
}

int affinity_rounds_select_launch(const TablesView* t, int g, int B, int N, int lo, int hi, int c,
                                  int R, float* fs, int* is, const double* summ_all,
                                  long long* cand, cudaStream_t stream) {
  affinity_rounds_select<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, c, R, fs, is,
                                                          summ_all, cand);
  return (int)cudaGetLastError();
}

int affinity_rounds_merge_launch(const TablesView* t, int g, int m, int B, int N, int c, int R,
                                 float* fs, int* is, const long long* rows, int* state,
                                 cudaStream_t stream) {
  affinity_rounds_merge<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, B, N, c, R, fs, is, rows,
                                                         state);
  return (int)cudaGetLastError();
}

int affinity_rounds_sandwich_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                    const int* j, float* fs, int* is, float* part,
                                    cudaStream_t stream) {
  affinity_rounds_sandwich<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, B, N, lo, hi, j, fs, is,
                                                            part);
  return (int)cudaGetLastError();
}

int affinity_rounds_finish_launch(const TablesView* t, int g, int m, int ss_live, int B, int N,
                                  int R, int* j, float* fs, int* is, const float* red,
                                  const float* red4, const double* summ_all, int* state,
                                  cudaStream_t stream) {
  affinity_rounds_finish<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, m, ss_live, B, N, R, j, fs, is,
                                                          red, red4, summ_all, state);
  return (int)cudaGetLastError();
}

}  // extern "C"
