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
// The per-node stages (setup, front, table, select, sandwich) and the
// finish are each one thread-block cluster of C CTAs of 512 threads (C from
// ops/cluster.py `choose` over the block's NL nodes), CTA r owning the node
// slice [r * chunk, (r + 1) * chunk) of the block, their cross-node values
// cluster rounds (wave_cluster.cuh, merge.cuh); the reduce and the merge
// work on replicated rows and run on one CTA. One segment: `setup` once
// (K9's segment constants on the block, the live rows, j = 0), then per
// epoch, launched by ops/kernels.py `schedule_affinity_wave_rounds_kernel`:
//   front    (K9's front and the flags) the live gates, F_start, F_hi,
//            ip_raw and the SelectorSpread counts, K9's stacked vector of
//            maxima, any(F_hi), any(F_start), any(F_start on a zone),
//            whether a node's live budget terms leave its composed domain,
//            and with ss_live the [Z] zone sums of the counts over F_start,
//            in one row (one round);
//   -- all_gather_rows #1 of the rows --
//   reduce   (one CTA, replicated) the maxima by max, the zone sums by a
//            left-to-right sum in rank order; the epoch's gates (uniform
//            base, ip and zone liveness, the normalizer test, bootstrap) and
//            use_multi_pre;
//   table    (K9's table and the summary) each F_hi node's score row with
//            the SelectorSpread blend (B+1 entries where use_multi_pre, the
//            head entry otherwise), its usable prefix and first hidden
//            entry; the block's first two maxima of that bound and its best
//            head as (value, global node) with every term's domain at that
//            head, and its usable count (three rounds);
//   -- all_gather_rows #2 of the summaries; the host reads use_multi_pre
//      and any(F_start); without use_multi_pre: finish (the head) --
//   select   the guard from the global pairs, the block's top c = min(K_EP,
//            NL*B) entries (merge.cuh cluster_block_top), emitted in node
//            order as [c] (global key, dom_live, every term's domain) rows,
//            0 keys after the block's own, then (guarded usable count, 0,
//            ...);
//   -- all_gather_rows #3 of the [c+1] rows --
//   merge    (one CTA, replicated) the radix select of the top K_EP of the
//            R*c keys, their bitonic sort, each position's carried domain,
//            and the rounds on the compacted domain state
//            (`affinity_rounds_compact`, below), with no collective; the
//            host reads the pods they took;
//   sandwich (when they took pods) the lower set's maxima over the block
//            (the ever-blocked domains expanded to the block's nodes, the
//            exhausted nodes left out), the minima negated (one round);
//   -- pmax #4 of those seven --
//   finish   (replicated) the sandwich's test, the head fallback from the
//            gathered heads, the fold into j and the live rows over the
//            merged candidates' nodes (the keys split over the CTAs; each
//            node's count taken and cleared at once) or the head, and the
//            loop state (placed, last, epochs, head fallbacks, multi rounds).
// Collectives per epoch: 2 (the head fallback without use_multi_pre), 3
// (rounds that took nothing), 4 (a sandwich); the host reads one to three
// small values per epoch.
//
// The rounds' compacted state. A round of K5 and K9 walks all D+1 domains
// four times (the minimum, the level histogram, the rise scan, the
// bookkeeping). Within an epoch only a candidate's domain changes (its
// taken count); an eligible domain that holds no candidate keeps its count,
// so its part of the minimum is one fixed value (smin), its part of the
// level histogram a histogram of its counts above smin shifted by smin -
// min_c, and it is at the minimum exactly when smin == min_c (with no
// candidate: its first position is never reached). Its sandwich bit is the
// one of the epoch's first round: the minimum never falls (counts only
// grow), a domain's budget never falls as the minimum grows (float sums are
// monotone), so a domain blocked in a later round was blocked in the first;
// and a multi-level round marks it when it is eligible. So each round walks
// the candidates' distinct domains only (at most K_EP), and the epoch walks
// all D+1 four times: counts, marks, the fixed minimum and histogram, the
// sandwich bits. The counts are integer-valued (pods and carried terms), so
// the shifted histogram bins equal the direct ones.
//
// Exactness against K5 (and the plain `epoch` of ops/kernels.py):
// - the per-node floats are K9's: the block's rows are the unsharded rows;
// - maxima are exact in any order (as order-preserving integer keys
//   too), and mins ride negated (-max(-x) == min(x), +-inf included); the
//   flags ride as 0/1 maxima;
// - the zone sums and every count are integer-valued and below 2^24, so
//   their sums are exact in any order (the reduce adds them in rank order);
// - ties break on the global node index (the bound and head pairs, by
//   value desc, node asc) and the global flat position n*B+k (the 64-bit
//   key of select.cuh);
// - the merge sees the unsharded top K_EP keys: that top holds at most
//   min(K_EP, NL*B) = c entries of any block and each block offers its own
//   top c, so the top of the union of the blocks' tops is the unsharded
//   top; the domains travel with the keys and the pads (key 0) are no
//   candidates;
// - the rounds keep one "ever blocked" bit per domain where JAX ORs
//   blocked_d[dom_live] into a per-node mask: dom_live is fixed within an
//   epoch, so a node's bit is its domain's, and the sandwich reads it on
//   the block; the compaction keeps every round's minimum, histogram, rise
//   and bit as above (tests/test_torch_rounds_compact.py holds a model of
//   it against the plain rounds);
// - ROADMAP §B's invariants: compiled with --fmad=false, no log here (the
//   setup's interpod term keeps common.cuh's f64 log, rounded once), and
//   only integer-valued atomics. The rounds keep K5's sentinel-domain
//   behaviour (ROADMAP §C3): domain D is never metered.
//
// What bounds it on an H100: latency. A per-node stage is a short pass over
// the block on C SMs plus a start and an end cluster barrier and its
// rounds; the merge is the rounds' block-wide scans over the candidates on
// one SM. Per epoch the host makes two to four collectives and one to three
// reads. The bytes it must move per epoch are the block's table and the
// merged list (counted in chip_smoke.py `k11_cost`).
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "affinity.cuh"
#include "affinity_sharded.cuh"
#include "common.cuh"
#include "merge.cuh"
#include "select.cuh"

// K11's loop state after K9's seven: the epoch's use_multi_pre, any(F_start),
// uniform base and zoned-start flags, then the rounds' pods and productive
// rounds, and the merged candidates' count
enum {
  ST_MULTI_PRE = 7, ST_ANY_START, ST_UNIFORM, ST_ZONED, ST_GOT, ST_ROUNDS, ST_NCAND, ST_INTS = 16
};

// The words of a CTA's round slot: a radix histogram, or the front's row
// (K9's stacked vector, the four flags and the zone sums)
static __host__ __device__ inline int k11_words(const TablesView& t) {
  const int row = AS_FIXED + 2 * t.Cw + 4 + t.Z;
  return row > RX_WORDS ? row : RX_WORDS;
}

// The dynamic shared memory a K11 stage may ask for: its CTAs also hold the
// term slots (Ctx, ~9.5 KB) and the rounds' words in static shared memory,
// 8 KB more than cluster.cuh leaves room for (ops/cluster.py takes it from
// affinity_rounds_smem_max)
#define K11_SMEM_MAX (CLUSTER_SMEM_MAX - 8192)

// K11's dynamic shared memory at C: the round slots [2][C][W], then the
// front's row partials [W]
static __host__ __device__ inline long long k11_smem_bytes(const TablesView& t, int C) {
  const long long W = k11_words(t);
  return 4LL * (2 * C * W + W);
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_rounds_setup(TablesView t, int g, int cap1, int B, int N, int lo, int hi, int* j,
                      float* fs, int* is, int* state) {
  aff_setup_stage(t, g, cap1, B, N, lo, hi, j, fs, is, state);
}

// The front's row: K9's stacked vector [0, p0), p0 = AS_FIXED + 2 Cw, the
// flags [p0, p0 + 4) and with ss_live the zone sums [p0 + 4, p0 + 4 + Z)
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_rounds_front(TablesView t, int g, int B, int N, int lo, int hi, int ss_live,
                      const int* j, float* fs, int* is, float* part, int* state) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  __shared__ StageShared sh;
  __shared__ float s_red[8 * 32];
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, D = t.D1 - 1, W = k11_words(t);
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  Cluster cx = cluster_stage(hi - lo, W, (int*)smem, sh.mbar);
  int* acc = (int*)smem + 2 * cx.C * W;
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int Cw = c.n[SK_CW], p0 = AS_FIXED + 2 * Cw, nw = p0 + 4 + (ss_live ? t.Z : 0);
  const int boot = aff_front_prologue(t, c, g, a.rows, s_red);
  // the CTA's row as integer keys: maxima as okey (the carriers' domains
  // start at K9's -1 and -(D + 2)), the flags as 0/1, the zone sums as counts
  for (int k = tid; k < nw; k += CLUSTER_THREADS)
    acc[k] = k < AS_FIXED ? okey(-INFINITY)
             : k < AS_FIXED + Cw ? okey(-1.0f)
             : k < p0 ? okey(-(float)(D + 2)) : 0;
  __syncthreads();
  float v[AS_FIXED];
  for (int i = 0; i < AS_FIXED; ++i) v[i] = -INFINITY;
  bool h = false, s = false, hz = false, ns = false;
  for (int n = lo + cx.lo + tid; n < lo + cx.hi; n += CLUSTER_THREADS) {
    aff_front_node(t, c, a, g, n, j, boot, v);
    const int fl = a.flags[n];
    h |= (fl & AF_HI) != 0;
    ns |= !(fl & AF_SAME);
    if (fl & AF_HI)
      for (int q = 0; q < Cw; ++q) {
        const float dom = (float)slot_dom(t, SK_CW, c.slot[SK_CW][q].id, n);  // ids < 2^24
        atomicMax(&acc[AS_FIXED + q], okey(dom));
        atomicMax(&acc[AS_FIXED + Cw + q], okey(-dom));
      }
    if (!(fl & AF_START)) continue;
    s = true;
    const int zone = t.node_zone[n];
    hz |= zone > 0;
    if (ss_live) atomicAdd(&acc[p0 + 4 + zone], (int)a.pn0[n]);  // integer counts: exact
  }
  for (int i = 0; i < AS_FIXED; ++i) {
    const int r = __reduce_max_sync(FULL_MASK, okey(v[i]));
    if (lane == 0) atomicMax(&acc[i], r);
  }
  const bool fl4[4] = {h, s, hz, ns};
  for (int i = 0; i < 4; ++i)
    if (__any_sync(FULL_MASK, fl4[i]) && lane == 0) atomicMax(&acc[p0 + i], 1);
  __syncthreads();
  round_arm(cx, nw);
  for (int k = threadIdx.x >> 5; k < nw; k += CLUSTER_WARPS) round_put(cx, k, acc[k]);
  const int* src = round_wait(cx);
  if (cx.rank == 0) {
    for (int k = tid; k < nw; k += CLUSTER_THREADS) {
      int x = src[k];
      if (k < p0 + 4) {
        for (int q = 1; q < cx.C; ++q) x = max(x, src[q * W + k]);
        part[k] = k < p0 ? ounkey(x) : (x ? 1.0f : 0.0f);
      } else {
        for (int q = 1; q < cx.C; ++q) x += src[q * W + k];
        part[k] = (float)x;
      }
    }
    if (tid == 0) state[5] = boot;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_reduce(TablesView t, int g, int B, int N, int ss_live, int R, int P1,
                       const float* rows1, float* red, float* fs, int* is, int* state) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
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
  state[ST_NCAND] = 0;  // the merge sets it when it runs
}

// Each F_hi node's score row (K9's table: serial's normalizers over F_start,
// norms6 :2019, the [B+1] rows :2036) with the SelectorSpread blend; the
// summary row [b1, i1, b2, i2, head, head node, usable count, 0], then every
// term slot's domain at the head node (K9's payload order)
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_rounds_table(TablesView t, int g, int B, int N, int lo, int hi, int ss_live,
                      const int* j, float* fs, int* is, const float* red, const int* state,
                      double* summ) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  __shared__ StageShared sh;
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x, R = t.R, B1 = B + 1;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  Cluster cx = cluster_stage(hi - lo, k11_words(t), (int*)smem, sh.mbar);
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const size_t gN = (size_t)g * t.N;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  const Norms nm = {red[0], -red[5], fmaxf(red[1], 0.0f), fmaxf(red[2], 0.0f),
                    fmaxf(red[3], 0.0f), fminf(-red[6], 0.0f)};
  const bool use_multi_pre = state[ST_MULTI_PRE], zoned = state[ST_ZONED];
  const float maxN = fmaxf(red[4], 0.0f);
  float maxZ = 0.0f;
  if (ss_live)
    for (int z = 1; z < t.Z; ++z) maxZ = fmaxf(maxZ, a.zone_sums[z]);
  const int ncols = use_multi_pre ? B1 : 1;
  float b1 = -INFINITY, b2 = -INFINITY, hv = -INFINITY, hv2 = -INFINITY;
  int i1 = INT_HI, i2 = INT_HI, ih = INT_HI, ih2 = INT_HI, nU = 0;
  for (int n = lo + cx.lo + tid; n < lo + cx.hi; n += CLUSTER_THREADS) {
    const int fl = a.flags[n];
    int u = 0;
    float bound = -INFINITY;
    if (fl & AF_HI) {  // F_start is inside F_hi
      float simon, nodeaff, taint, interpod;
      normalized_terms(nm, a.simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], a.ip_raw[n],
                       &simon, &nodeaff, &taint, &interpod);
      const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                             + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + a.stat[n];
      const float jf = (float)j[n];
      const float nz_c = t.nonzero[(size_t)n * 2 + 0], nz_m = t.nonzero[(size_t)n * 2 + 1];
      const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
      const int zone = t.node_zone[n];
      const bool blend = zoned && zone > 0;
      const float zs = ss_live ? a.zone_sums[zone] : 0.0f;
      float* row = a.table + (size_t)n * B1;
      int first_bad = B;
      float prev = 0.0f;
      for (int k = 0; k < ncols; ++k) {
        const float copies = jf + (float)(k + 1);
        float least, bal;
        least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
        float val = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
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
      if (fl & AF_START) top2_update(row[0], n, hv, ih, hv2, ih2);
    }
    a.u[n] = u;
    nU += u;
    if (use_multi_pre) {
      a.bound[n] = bound;
      top2_update(bound, n, b1, i1, b2, i2);
    }
  }
  if (use_multi_pre) cluster_top2(cx, b1, i1, b2, i2, sh.rx, sh.fin);
  cluster_top2(cx, hv, ih, hv2, ih2, sh.rx, sh.fin);
  int cnt[1] = {nU};
  const int op[1] = {RX_SUM};
  cluster_reduce<1>(cx, cnt, op, sh.rx, sh.fin);
  if (cx.rank == 0) {
    if (tid == 0) {
      summ[0] = b1;
      summ[1] = i1;
      summ[2] = b2;
      summ[3] = i2;
      summ[4] = hv;
      summ[5] = ih;
      summ[6] = cnt[0];
      summ[7] = 0.0;
    }
    const bool own = ih >= lo && ih < hi;  // no F_start node: no head, the domains unread
    for (int k = 0; k < N_KINDS; ++k)
      for (int s = tid; s < c.n[k]; s += CLUSTER_THREADS)
        summ[8 + c.off[k] + s] = own ? (double)slot_dom(t, k, c.slot[k][s].id, ih) : 0.0;
  }
  cluster_barrier_uncounted();
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_rounds_select(TablesView t, int g, int B, int N, int lo, int hi, int c_, int R,
                       float* fs, int* is, const double* summ_all, long long* cand) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  __shared__ StageShared sh;
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x, B1 = B + 1;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  Cluster cx = cluster_stage(hi - lo, k11_words(t), (int*)smem, sh.mbar);
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int n_rows = c.off[SK_SS] + 1, SW = 8 + n_rows, CW = 2 + n_rows, s0 = lo + cx.lo;
  float f1, f2;
  int i1, i2;
  global_pairs(summ_all, R, SW, &f1, &i1, &f2, &i2);
  // K9's gathered avail is not read on this path: it holds the block top's
  // per-node counts
  const RowSet rs = {a.table + (size_t)s0 * B1, B1, a.u + s0, s0, cx.hi - cx.lo, B, B};
  const BlockTop bt = cluster_block_top(cx, rs, a.u + s0, a.avail + s0, f1, i1, f2, i2, c_, sh,
                                        [&](int slot, int l, int, u64 key) {
                                          const int n = s0 + l;
                                          long long* out = cand + (size_t)slot * CW;
                                          out[0] = (long long)key;
                                          out[1] = a.dom_live[n];
                                          for (int q = 0; q < N_KINDS; ++q)
                                            for (int s = 0; s < c.n[q]; ++s)
                                              out[2 + c.off[q] + s] =
                                                  slot_dom(t, q, c.slot[q][s].id, n);
                                        });
  const int stride = cx.C * CLUSTER_THREADS;
  for (size_t i = (size_t)bt.r * CW + cx.rank * CLUSTER_THREADS + tid; i < (size_t)c_ * CW;
       i += stride)
    cand[i] = 0;
  if (cx.rank == 0)
    for (int i = tid; i < CW; i += CLUSTER_THREADS) cand[(size_t)c_ * CW + i] = i == 0 ? bt.U : 0;
  cluster_barrier_uncounted();
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
affinity_rounds_merge(TablesView t, int g, int m, int B, int N, int c_, int R, float* fs, int* is,
                      const long long* rows, int* kx, int* state) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  __shared__ float s_red[8 * 32];
  __shared__ int s_int[32];
  __shared__ u64 s_key[K_EP_MAX];
  __shared__ int s_occ[K_EP_MAX];
  __shared__ int s_dom[K_EP_MAX];
  __shared__ int hist[256 + 8];  // select_gathered's bins and warp sums
  __shared__ int s_prise[LMAX + 2], s_prov[LMAX + 2], s_hist[LMAX + 2], s_h0[LMAX + 2];
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
  const Compact cp = compact_of(kx);
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
  // descending), and the domain it carried there; the keys for the finish
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
  for (int i = tid; i < n_cand; i += bd) cp.keys[i] = s_key[i];
  __syncthreads();

  // ---- the rounds, replicated, on the merged list
  const AffShared sh = {s_red, s_int, s_occ, s_prise, s_prov, s_hist, &s_L, &s_PL, s_key};
  int rounds = 0;
  const int got = affinity_rounds_compact<2>(c, a, cp, sh, s_dom, s_h0, dm, m - state[0], n_cand,
                                             L, c.n_budget >= 1, c.n_dns > 0, c.inc_live, rounds);
  if (tid == 0) {
    state[ST_GOT] = got;
    state[ST_ROUNDS] = rounds;
    state[ST_NCAND] = n_cand;
  }
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_rounds_sandwich(TablesView t, int g, int B, int N, int lo, int hi, const int* j,
                         float* fs, int* is, float* part) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  __shared__ StageShared sh;
  __shared__ float s_red[8 * 32];
  extern __shared__ uint32_t smem[];
  if (threadIdx.x == 0) affinity_slots(t, g, &c);
  __syncthreads();
  Cluster cx = cluster_stage(hi - lo, k11_words(t), (int*)smem, sh.mbar);
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  // the lower set reads the block's rows of the rebased view
  const AffDims dm = {N, t.D1, t.D1 - 1, B, B + 1, t.Z, min(N * B, K_EP_MAX), N * B + 1,
                      (size_t)g * t.N};
  float w7[7];
  affinity_lower_set(t, a, AvailLive{a.cap, j}, dm, lo + cx.lo, lo + cx.hi, c.n_budget >= 1, w7,
                     s_red);
  int r7[7];
  for (int i = 0; i < 7; ++i) r7[i] = okey(w7[i]);
  const int op7[7] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MIN, RX_MIN};
  cluster_reduce<7>(cx, r7, op7, sh.rx, sh.fin);
  if (cx.rank == 0 && threadIdx.x < 7)
    part[threadIdx.x] = threadIdx.x < 5 ? ounkey(r7[threadIdx.x]) : -ounkey(r7[threadIdx.x]);
  cluster_barrier_uncounted();
}

// Fold `cn` pods on node n into j and every live row (the sentinel column
// never counts, as in commit()), slot (k, s)'s domain dom_of(k, s)
template <class DomOf>
static __device__ __forceinline__ void fold_node(const Ctx& c, const AffScratch& a, int D1, int n,
                                                 int cn, int* j, const DomOf& dom_of) {
  atomicAdd(&j[n], cn);
  for (int k = 0; k < N_KINDS; ++k)
    for (int s = 0; s < c.n[k]; ++s) {
      const Slot& x = c.slot[k][s];
      if (x.inc == 0.0f) continue;
      const int dom = dom_of(k, s);
      if (dom < D1 - 1) atomicAdd(&a.rows[(size_t)(c.off[k] + s) * D1 + dom], (float)cn * x.inc);
    }
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_rounds_finish(TablesView t, int g, int m, int ss_live, int B, int N, int R, int* j,
                       float* fs, int* is, const float* red, const float* red4,
                       const double* summ_all, const int* kx, int* state) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  const int tid = threadIdx.x, rank = cluster_rank(), D1 = t.D1;
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const AffGathered ga = aff_gathered(t, a, N);
  const u64* keys = reinterpret_cast<const u64*>(kx);
  const int n_rows = c.off[SK_SS] + 1, SW = 8 + n_rows;
  const int placed = state[0], got = state[ST_GOT], rounds = state[ST_ROUNDS];
  const int n_cand = state[ST_NCAND];
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
  const int m_take = use_multi ? got : (head >= 0 ? 1 : 0);
  // ---- the fold: each merged candidate's node once (its count taken and
  // cleared for the next epoch by the one exchange that finds it nonzero),
  // its term domains as the merge gathered them; or the head's, from its
  // block's summary
  for (int p = rank * CLUSTER_THREADS + tid; p < n_cand; p += cluster_ctas() * CLUSTER_THREADS) {
    const int n = key_node(keys[p], B);
    const int cn = atomicExch(&a.counts[n], 0);
    if (use_multi && cn > 0)
      fold_node(c, a, D1, n, cn, j,
                [&](int k, int s) { return ga.fdom[(size_t)(c.off[k] + s) * N + n]; });
  }
  if (head >= 0 && rank == 0 && tid == 0)
    fold_node(c, a, D1, head, 1, j,
              [&](int k, int s) { return (int)summ_all[head_r * SW + 8 + c.off[k] + s]; });
  cluster_barrier_uncounted();  // every CTA has read state
  if (rank == 0 && tid == 0) {
    state[0] = placed + m_take;
    state[1] = m_take;
    state[2] += 1;
    state[3] += head >= 0;
    state[4] += use_multi ? rounds : 0;
  }
}

// cluster.cuh cluster_kernel_init with K11's shared-memory bound
template <typename... Params>
static cudaError_t k11_init(void (*kernel)(Params...)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K11_SMEM_MAX);
  return e;
}

// ------------------------------------------------------------ C interface --

extern "C" {

int affinity_rounds_state_ints() { return ST_INTS; }
int affinity_rounds_compact_ints() { return K11_COMPACT_INTS; }

// K11's dynamic shared memory at C (ops/cluster.py takes it from here)
long long affinity_rounds_smem(const TablesView* t, int C) { return k11_smem_bytes(*t, C); }

long long affinity_rounds_smem_max() { return K11_SMEM_MAX; }

// Allow each K11 cluster kernel clusters of 16 and K11_SMEM_MAX bytes of
// dynamic shared memory, once per device
int affinity_rounds_init() {
  cudaError_t e = k11_init(affinity_rounds_setup);
  if (e == cudaSuccess) e = k11_init(affinity_rounds_front);
  if (e == cudaSuccess) e = k11_init(affinity_rounds_table);
  if (e == cudaSuccess) e = k11_init(affinity_rounds_select);
  if (e == cudaSuccess) e = k11_init(affinity_rounds_sandwich);
  if (e == cudaSuccess) e = k11_init(affinity_rounds_finish);
  return (int)e;
}

static bool k11_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

// Clusters of C CTAs with `smem` bytes of K11's largest stage (the select)
// that can be resident at once, into *out
int affinity_rounds_occupancy(int C, long long smem, int* out) {
  if (!k11_size_ok(C)) return (int)cudaErrorInvalidValue;
  return cluster_occupancy_of(affinity_rounds_select, C, smem, out);
}

#define K11_SHAPE_OK                                                                \
  if (!k11_size_ok(C) || smem != k11_smem_bytes(*t, C) || smem > K11_SMEM_MAX) \
  return (int)cudaErrorInvalidValue

// t: the block's view, rebased by lo (affinity_sharded.cuh); N: the mesh's
// nodes. Every cluster stage: one cluster of C CTAs, `smem` =
// affinity_rounds_smem(t, C) (any other shape is refused). The summary rows
// hold 8 + slots doubles and the candidate rows 2 + slots ints, slots = Sd +
// A + B + Ca + Cw + 1; kx: affinity_rounds_compact_ints ints.
int affinity_rounds_setup_launch(const TablesView* t, int g, int cap1, int B, int N, int lo,
                                 int hi, int* j, float* fs, int* is, int* state, int C,
                                 long long smem, cudaStream_t stream) {
  K11_SHAPE_OK;
  return cluster_launch(affinity_rounds_setup, C, 1, 0, stream, *t, g, cap1, B, N, lo, hi, j, fs,
                        is, state);
}

int affinity_rounds_front_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                 int ss_live, const int* j, float* fs, int* is, float* part,
                                 int* state, int C, long long smem, cudaStream_t stream) {
  K11_SHAPE_OK;
  return cluster_launch(affinity_rounds_front, C, 1, smem, stream, *t, g, B, N, lo, hi, ss_live, j,
                        fs, is, part, state);
}

int affinity_rounds_reduce_launch(const TablesView* t, int g, int B, int N, int ss_live, int R,
                                  int P1, const float* rows1, float* red, float* fs, int* is,
                                  int* state, cudaStream_t stream) {
  TablesView v = *t;
#if OSIM_WIDE
  WideScratch ws;
  if (const int e = wide_open(ws, 1, BLOCK_THREADS, stream, v)) return e;
#endif
  affinity_rounds_reduce<<<1, BLOCK_THREADS, 0, stream>>>(v, g, B, N, ss_live, R, P1, rows1, red,
                                                          fs, is, state);
  return (int)cudaGetLastError();
}

int affinity_rounds_table_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                 int ss_live, const int* j, float* fs, int* is, const float* red,
                                 const int* state, double* summ, int C, long long smem,
                                 cudaStream_t stream) {
  K11_SHAPE_OK;
  return cluster_launch(affinity_rounds_table, C, 1, smem, stream, *t, g, B, N, lo, hi, ss_live, j,
                        fs, is, red, state, summ);
}

int affinity_rounds_select_launch(const TablesView* t, int g, int B, int N, int lo, int hi, int c,
                                  int R, float* fs, int* is, const double* summ_all,
                                  long long* cand, int C, long long smem, cudaStream_t stream) {
  K11_SHAPE_OK;
  return cluster_launch(affinity_rounds_select, C, 1, smem, stream, *t, g, B, N, lo, hi, c, R, fs,
                        is, summ_all, cand);
}

int affinity_rounds_merge_launch(const TablesView* t, int g, int m, int B, int N, int c, int R,
                                 float* fs, int* is, const long long* rows, int* kx, int* state,
                                 cudaStream_t stream) {
  TablesView v = *t;
#if OSIM_WIDE
  WideScratch ws;
  if (const int e = wide_open(ws, 1, BLOCK_THREADS, stream, v)) return e;
#endif
  affinity_rounds_merge<<<1, BLOCK_THREADS, 0, stream>>>(v, g, m, B, N, c, R, fs, is, rows, kx,
                                                         state);
  return (int)cudaGetLastError();
}

int affinity_rounds_sandwich_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                    const int* j, float* fs, int* is, float* part, int C,
                                    long long smem, cudaStream_t stream) {
  K11_SHAPE_OK;
  return cluster_launch(affinity_rounds_sandwich, C, 1, smem, stream, *t, g, B, N, lo, hi, j, fs,
                        is, part);
}

int affinity_rounds_finish_launch(const TablesView* t, int g, int m, int ss_live, int B, int N,
                                  int R, int* j, float* fs, int* is, const float* red,
                                  const float* red4, const double* summ_all, const int* kx,
                                  int* state, int C, long long smem, cudaStream_t stream) {
  K11_SHAPE_OK;
  return cluster_launch(affinity_rounds_finish, C, 1, 0, stream, *t, g, m, ss_live, B, N, R, j, fs,
                        is, red, red4, summ_all, kx, state);
}

}  // extern "C"
