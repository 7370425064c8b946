// Hand-written Hopper kernels for the affinity wave's sharded epoch path.
//
// K9 replaces the `shard_map` epoch loop of open_simulator_tpu/ops/kernels.py
//    `schedule_affinity_wave` (:1977-2094: `front_sharded` :1982-2066,
//    `loop_sharded` :2068-2078, the shared `epoch_tail` :1714 and
//    `apply_zone` :1680) on the partitioned layout (`table_shardings`,
//    `carry_shardings`): every rank of a node mesh holds only its node
//    block [lo, hi) of the tables and the carry, and the live [slots, D+1]
//    rows whole; rank r builds the segment constants and the epoch front on
//    its block, the host makes the epoch's two collectives
//    (parallel/collectives.py), and the tail runs on every rank on the
//    gathered full-width rows, so the counts, the live rows, `placed` and
//    the statistics are equal on every rank and equal to K5's.
//
// Four stages, each one thread-block cluster of C CTAs of 512 threads
// (cluster.cuh), launched by ops/kernels.py
// `schedule_affinity_wave_sharded_kernel`:
//   setup  (once per segment; a cluster over the block, C from
//          ops/cluster.py `choose` over NL, CTA r owning a slice of it;
//          K11's body, affinity_sharded.cuh aff_setup_stage): the term
//          slots, base feasibility, capacity, static score terms, the
//          composed budget domain of each node and whether its live budget
//          terms all lie in it, the live rows from the carry, j = 0;
//   front  (per epoch, the block's cluster): the live gates, F_start and
//          F_hi, ip_raw and the SelectorSpread count (epoch_head :1586,
//          aff_front_node, K11's), and one stacked vector of maxima over the
//          block (:1996-2010): the maxima over F_start and F_hi of [simon,
//          nodeaff, taint, ip, pernode] and of [-simon, -ip], of [-simon,
//          -nodeaff, -taint, -ip] over F_hi, and of each weighted carrier's
//          domain and its negation over F_hi, as one cluster round of
//          order-preserving integer maxima; CTA 0 writes it;
//   -- pmax of that vector over the ranks --
//   table  (per epoch, the block's cluster, no round): the normalizers of
//          F_start from the reduced vector, each node's [B+1] score row
//          without the SelectorSpread blend, and the payload row [table;
//          F_start; F_hi; min(avail, B+1); ip_raw; pernode0] (:2036-2046),
//          then what the tail reads of every node besides: simon_s,
//          nodeaff, taint, the zone, the budget domain, the AF_KEY /
//          AF_SAME flags and every term slot's domain (the fold's); the
//          segment constants among them ride every epoch, so that the epoch
//          keeps its two collectives;
//   -- all_gather of the payload rows, in rank order --
//   tail   (per epoch, one cluster over the mesh's N nodes, C from `choose`
//          over N; reading no table): CTA r reads the gathered rows of its
//          node slice in place, then K5's epoch after its front, as K5's
//          cluster form runs it (affinity_wave.cu): round 1 (any_start,
//          any_hi, have_zones, whether every budget composes, and the zone
//          sums of the counts over F_start as integer sums); the uniform
//          base, domain and ip gates from the reduced vector; each F_hi
//          node's row with the SelectorSpread blend (apply_zone, post-gather
//          as JAX: the zone sums are cross-node sums); the two-largest-bound
//          cut (cluster_top2); the K_EP-th key by the cluster radix select
//          where more entries are usable; every CTA's candidates, compacted
//          at CTA-total offsets in node order, pushed into every CTA and
//          sorted there; the rounds on the candidates' distinct domains
//          (affinity_rounds_compact, K11's merge's) replicated on every CTA
//          with no exchange, each on its own copy of the round state; the
//          sandwich's lower set as one more round; the head fallback; then,
//          past one cluster barrier, the fold of each CTA's slice into j and
//          the rank's live rows (integer-valued atomics).
// The host reads (placed, last) once per epoch to decide on the next.
//
// Exactness across the cut: the payload is f32 (avail clamped to B+1 packs
// exactly and every comparison against it has a left side <= B; ip_raw and
// the counts travel as the f32 values they are); a max is exact in any
// order (as okey integers too) and mins ride negated; the domain ids ride
// as f32, exact below 2^24; every tie breaks on the global node index (the
// pairs of cluster_top2 and cluster_argmax carry global nodes) or the
// global flat position n*B+k (the 64-bit key of select.cuh); the zone sums
// and the row updates are integer-valued, exact in any grouping. A rank
// whose block has no F_start or F_hi node sends -inf, which every other
// rank's value beats. -0.0 from a negation reaches only guarded divisions.
//
// What bounds it on an H100: latency, as K5, plus the two collectives and
// the host's read per epoch. A stage is a short pass over C SMs' node
// slices plus its cluster rounds; the tail's rounds walk the candidates'
// distinct domains on every CTA.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "affinity.cuh"
#include "affinity_sharded.cuh"
#include "common.cuh"
#include "merge.cuh"
#include "select.cuh"

// The dynamic shared memory a K9 stage may ask for: its CTAs also hold the
// term slots (Ctx, ~9.5 KB), StageShared and the rounds' words in static
// shared memory (ops/cluster.py takes it from affinity_sharded_smem_max)
#define K9_SMEM_MAX (CLUSTER_SMEM_MAX - 16384)

// The block stages' round slot: the front's stacked vector
static __host__ __device__ inline int k9_words(const TablesView& t) { return AS_FIXED + 2 * t.Cw; }

// The block stages' dynamic shared memory at C (the front's): the round
// slots [2][C][W], then the CTA's maxima [W]
static __host__ __device__ inline long long k9_smem_bytes(const TablesView& t, int C) {
  const long long W = k9_words(t);
  return 4LL * (2 * C * W + W);
}

// The tail's round slot: a radix pass's histogram, or round 1's four flags
// and the zone sums
static __host__ __device__ inline int k9_tail_words(const TablesView& t) {
  const int row = 4 + t.Z;
  return row > RX_WORDS ? row : RX_WORDS;
}

// The tail's dynamic shared memory at C: the candidate keys [K_EP_MAX] u64,
// their ranks and domains [K_EP_MAX] i32 each, the round slots [2][C][W],
// fin [W] and round 1's row [4 + Z]
static __host__ __device__ inline long long k9_tail_smem_bytes(const TablesView& t, int C) {
  const long long W = k9_tail_words(t);
  return 16LL * K_EP_MAX + 4LL * (2 * C * W + W + 4 + t.Z);
}

// Ints of one tail CTA's copy of the rounds' state: the compacted state
// (K11_COMPACT_INTS, 8-byte aligned), then the takes [N], the live counts
// (f32) and the sandwich bits [D1] each
static __host__ __device__ inline long long k9_cta_ints(int N, int D1) {
  return ((long long)K11_COMPACT_INTS + N + 2LL * D1 + 1) & ~1LL;
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_sharded_setup(TablesView t, int g, int cap1, int B, int N, int lo, int hi, int* j,
                       float* fs, int* is, int* state) {
  aff_setup_stage(t, g, cap1, B, N, lo, hi, j, fs, is, state);
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_sharded_front(TablesView t, int g, int B, int N, int lo, int hi, const int* j,
                       float* fs, int* is, float* part, int* state) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  __shared__ StageShared sh;
  __shared__ float s_red[8 * 32];
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, D = t.D1 - 1, W = k9_words(t);
  if (tid == 0) affinity_slots(t, g, &c);
  __syncthreads();
  Cluster cx = cluster_stage(hi - lo, W, (int*)smem, sh.mbar);
  int* acc = (int*)smem + 2 * cx.C * W;
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int Cw = c.n[SK_CW];

  // ---- the DoNotSchedule minimum of every valid term, the bootstrap flag
  // (K5's, from the replicated live rows)
  const int boot = aff_front_prologue(t, c, g, a.rows, s_red);
  // the CTA's maxima as integer keys (the carriers' domains start at -1
  // and -(D + 2))
  for (int k = tid; k < W; k += CLUSTER_THREADS)
    acc[k] = k < AS_FIXED ? okey(-INFINITY) : k < AS_FIXED + Cw ? okey(-1.0f)
                                                                : okey(-(float)(D + 2));
  __syncthreads();

  // ---- the slice's gates, live scores and maxima (epoch_head, then the
  // stacked vector of front_sharded)
  float v[AS_FIXED];
  for (int i = 0; i < AS_FIXED; ++i) v[i] = -INFINITY;
  for (int n = lo + cx.lo + tid; n < lo + cx.hi; n += CLUSTER_THREADS) {
    aff_front_node(t, c, a, g, n, j, boot, v);
    if (!(a.flags[n] & AF_HI)) continue;
    for (int q = 0; q < Cw; ++q) {  // each weighted carrier's domain, and its negation
      const float dom = (float)slot_dom(t, SK_CW, c.slot[SK_CW][q].id, n);  // ids < 2^24
      atomicMax(&acc[AS_FIXED + q], okey(dom));
      atomicMax(&acc[AS_FIXED + Cw + q], okey(-dom));
    }
  }
  for (int i = 0; i < AS_FIXED; ++i) {
    const int r = __reduce_max_sync(FULL_MASK, okey(v[i]));
    if (lane == 0) atomicMax(&acc[i], r);
  }
  __syncthreads();
  round_arm(cx, W);
  for (int k = tid >> 5; k < W; k += CLUSTER_WARPS) round_put(cx, k, acc[k]);
  const int* src = round_wait(cx);
  if (cx.rank == 0) {
    for (int k = tid; k < W; k += CLUSTER_THREADS) {
      int x = src[k];
      for (int q = 1; q < cx.C; ++q) x = max(x, src[q * W + k]);
      part[k] = ounkey(x);
    }
    if (tid == 0) state[5] = boot;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// payload row of node n: [table (B+1); F_start; F_hi; min(avail, B+1);
// ip_raw; pernode0; simon_s; nodeaff; taint; zone; dom_live; flags], then
// every slot's domain (affinity_sharded.cuh AS_PAY_FIXED)
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_sharded_table(TablesView t, int g, int B, int N, int lo, int hi, const int* j, float* fs,
                       int* is, const float* red, float* pay) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  if (threadIdx.x == 0) affinity_slots(t, g, &c);
  __syncthreads();
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const int n_rows = c.off[SK_SS] + 1;
  const int R = t.R, B1 = B + 1, P = B + AS_PAY_FIXED + n_rows;
  const size_t gN = (size_t)g * t.N;
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  // serial's normalizers over F_start (norms6 :2019)
  const Norms nm = {red[0], -red[5], fmaxf(red[1], 0.0f), fmaxf(red[2], 0.0f),
                    fmaxf(red[3], 0.0f), fminf(-red[6], 0.0f)};
  int sa, sb;
  cta_slice(hi - lo, &sa, &sb);
  for (int n = lo + sa + threadIdx.x; n < lo + sb; n += CLUSTER_THREADS) {
    float simon, nodeaff, taint, interpod;
    normalized_terms(nm, a.simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], a.ip_raw[n],
                     &simon, &nodeaff, &taint, &interpod);
    const float static_n = t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff
                           + t.w[W_TAINT] * taint + t.w[W_INTERPOD] * interpod + a.stat[n];
    const float jf = (float)j[n];
    const float nz_c = t.nonzero[(size_t)n * 2 + 0], nz_m = t.nonzero[(size_t)n * 2 + 1];
    const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
    float* row = pay + (size_t)(n - lo) * P;
    for (int k = 0; k < B1; ++k) {
      const float copies = jf + (float)(k + 1);
      float least, bal;
      least_balanced(nz_c + gz_c * copies, nz_m + gz_m * copies, a_c, a_m, &least, &bal);
      row[k] = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal + static_n;
    }
    const int fl = a.flags[n];
    row[B1] = (fl & AF_START) ? 1.0f : 0.0f;
    row[B1 + 1] = (fl & AF_HI) ? 1.0f : 0.0f;
    row[B1 + 2] = (float)min(a.cap[n] - j[n], B1);
    row[B1 + 3] = a.ip_raw[n];
    row[B1 + 4] = a.pn0[n];
    row[B1 + 5] = a.simon_s[n];
    row[B1 + 6] = t.nodeaff_raw[gN + n];
    row[B1 + 7] = t.taint_raw[gN + n];
    row[B1 + 8] = (float)t.node_zone[n];
    row[B1 + 9] = (float)a.dom_live[n];  // ids < 2^24: exact
    row[B1 + 10] = (float)(fl & (AF_KEY | AF_SAME));
    for (int k = 0; k < N_KINDS; ++k)
      for (int s = 0; s < c.n[k]; ++s)
        row[B1 + 11 + c.off[k] + s] = (float)slot_dom(t, k, c.slot[k][s].id, n);
  }
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
affinity_sharded_tail(TablesView t, int g, int m, int ss_live, int B, int N, int* j, float* fs,
                      int* is, const float* red, const float* full, int* state, int* cs) {
  __shared__ Ctx c;
  CTX_BIND(c, t);
  __shared__ StageShared sh;
  __shared__ float s_red[8 * 32];
  __shared__ int s_int[32];
  __shared__ int s_prise[LMAX + 2], s_prov[LMAX + 2], s_hist[LMAX + 2], s_h0[LMAX + 2];
  __shared__ int s_L, s_PL;
  extern __shared__ __align__(16) uint32_t smem[];
  const int D1 = t.D1, tid = threadIdx.x, lane = tid & 31;
  const int B1 = B + 1, Z = t.Z, W = k9_tail_words(t);
  const int K_EP = min(N * B, K_EP_MAX);
  if (tid == 0) affinity_slots(t, g, &c);
  if (tid < LMAX + 2) {
    s_prise[tid] = -1;
    s_prov[tid] = 0;
    s_hist[tid] = 0;
  }
  __syncthreads();
  u64* s_key = (u64*)smem;
  int* s_occ = (int*)(s_key + K_EP_MAX);
  int* s_dom = s_occ + K_EP_MAX;
  Cluster cx = cluster_stage(N, W, s_dom + K_EP_MAX, sh.mbar);
  int* fin = s_dom + K_EP_MAX + 2 * cx.C * W;
  int* zacc = fin + W;
  const int lo = cx.lo, hi = cx.hi;
  const AffScratch a = aff_scratch(t, c, B, fs, is, N);
  const AffGathered ga = aff_gathered(t, a, N);
  // this CTA's copy of the rounds' state; the rest of the scratch is the
  // rank's, each CTA writing its node slice only
  int* mine = cs + (size_t)cx.rank * k9_cta_ints(N, D1);
  const Compact cp = compact_of(mine);
  AffScratch e = a;
  e.counts = mine + K11_COMPACT_INTS;
  e.cl = reinterpret_cast<float*>(e.counts + N);
  e.everb = reinterpret_cast<int*>(e.cl + D1);
  const int n_rows = c.off[SK_SS] + 1, P = B + AS_PAY_FIXED + n_rows;
  TablesView tg = t;  // the sandwich's lower set reads the gathered nodeaff and taint
  tg.nodeaff_raw = ga.nodeaff;
  tg.taint_raw = ga.taint;
  const AffDims dm = {N, D1, D1 - 1, B, B1, Z, K_EP, N * B + 1, 0};
  const int placed = state[0], boot = state[5];
  const bool has_budget = c.n_budget >= 1, dns_live = c.n_dns > 0;
  const int Cw = c.n[SK_CW];

  // ---- the slice's gathered rows: the epoch's sets, avail, ip_raw,
  // pernode0 and the tail's per-node values into the scratch (read back
  // by this CTA only); round 1's row: any_start, any_hi, have_zones and
  // whether some node's budget terms leave its composed domain (maxima of
  // 0 / 1), then with ss_live the zone sums of the counts over F_start
  // (integer sums)
  const int nw = 4 + (ss_live ? Z : 0);
  for (int k = tid; k < nw; k += CLUSTER_THREADS) zacc[k] = 0;
  __syncthreads();
  bool anyS = false, anyH = false, hz = false, ns = false;
  for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
    const float* src = full + (size_t)n * P;
    const int fl = (int)src[B1 + 10] | (src[B1] > 0.0f ? AF_START : 0)
                   | (src[B1 + 1] > 0.0f ? AF_HI : 0);
    a.flags[n] = fl;
    a.avail[n] = (int)src[B1 + 2];
    a.ip_raw[n] = src[B1 + 3];
    a.pn0[n] = src[B1 + 4];
    a.simon_s[n] = src[B1 + 5];
    ga.nodeaff[n] = src[B1 + 6];
    ga.taint[n] = src[B1 + 7];
    ga.zone[n] = (int)src[B1 + 8];
    a.dom_live[n] = (int)src[B1 + 9];
    ns |= !(fl & AF_SAME);
    anyH |= (fl & AF_HI) != 0;
    if (fl & AF_START) {
      anyS = true;
      if (ss_live) {
        const int zone = ga.zone[n];
        hz |= zone > 0;
        atomicAdd(&zacc[4 + zone], (int)src[B1 + 4]);  // integer counts: exact
      }
    }
  }
  const bool f4[4] = {anyS, anyH, hz, ns};
  for (int k = 0; k < 4; ++k)
    if (__any_sync(FULL_MASK, f4[k]) && lane == 0) atomicMax(&zacc[k], 1);
  __syncthreads();
  cluster_row_round(cx, zacc, 4, nw, fin);
  const bool any_start = fin[0], any_hi = fin[1], have_zones = fin[2];
  const bool budget_composes = c.n_budget <= 1 || (c.n_dns == 0 && !fin[3]);
  const int* zsum = fin + 4;  // the zone sums, integer
  // the reduced vector in K5's order: v[0..4] maxima over F_start, v[5], v[6]
  // minima (simon, ip); v[7..11], v[12], v[13] the same over F_hi
  float v[14];
  k5_order(red, v);
  // uniform normalizer inputs over F_hi (maxes_h[:4] == the minima of the
  // same rows), and ip liveness from the carriers' domain extrema
  const bool uniform_base = v[7] == -red[14] && v[8] == -red[15] && v[9] == -red[16]
                            && v[10] == -red[17] && any_hi;
  bool dom_same = true;
  for (int s = 0; s < Cw; ++s)
    if (c.slot[SK_CW][s].live && red[AS_FIXED + s] != -red[AS_FIXED + Cw + s]) dom_same = false;
  const bool ip_safe = !c.has_live_cw || !any_hi || (dom_same && v[10] == v[13]);
  const float maxN = fmaxf(v[4], 0.0f);
  float maxZ = 0.0f;
  if (ss_live)
    for (int z = 1; z < Z; ++z) maxZ = fmaxf(maxZ, (float)zsum[z]);
  bool pre_norms_ok = uniform_base || (v[0] == v[7] && v[1] == v[8] && v[2] == v[9]
                                       && v[3] == v[10] && v[5] == v[12] && v[6] == v[13]);
  if (ss_live) pre_norms_ok = pre_norms_ok && v[4] == v[11];
  const bool ss_multi_ok = !ss_live || !have_zones;
  const bool use_multi_pre = budget_composes && !boot && ip_safe && ss_multi_ok && pre_norms_ok;

  // ---- each F_hi node's table row (the gathered row plus the
  // SelectorSpread blend), its usable prefix and its first hidden entry;
  // one column when the epoch takes one pod
  float b1 = -INFINITY, b2 = -INFINITY;
  int i1 = INT_HI, i2 = INT_HI;
  const int ncols = use_multi_pre ? B1 : 1;
  for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
    const int fl = a.flags[n];
    int u = 0;
    float bound = -INFINITY;
    if (fl & AF_HI) {
      const float* src = full + (size_t)n * P;
      const int zone = ga.zone[n];
      const bool blend = have_zones && zone > 0;
      const float zs = ss_live ? (float)zsum[zone] : 0.0f;
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
        const int avail = a.avail[n];
        const int k_cap = ss_live ? (int)fminf(fmaxf(maxN - a.pn0[n], 0.0f), (float)B) : B;
        u = max(0, min(min(avail, k_cap), first_bad));
        const int k_hid = min(first_bad, k_cap);
        if (k_hid < avail) bound = row[k_hid];
      }
    }
    a.u[n] = u;
    if (use_multi_pre) top2_update(bound, n, b1, i1, b2, i2);
  }

  int got = 0, rounds = 0, n_cand = 0;
  bool use_multi = false;
  if (use_multi_pre) {
    // ---- the two-largest-bound cut: an entry is usable only if its key
    // beats every OTHER node's first hidden entry
    cluster_top2(cx, b1, i1, b2, i2, sh.rx, sh.fin);
    int U = 0, hmin = INT_HI, lmin = INT_HI;
    u64 kmax = 0;  // exact; (hmin, lmin) bounds the smallest key from below
    for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
      const float cut_s = n == i1 ? b2 : b1;
      const int cut_i = n == i1 ? i2 : i1;
      const float* row = a.table + (size_t)n * B1;
      const int u0 = a.u[n];
      int uu = 0;
      while (uu < u0 && (row[uu] > cut_s || (row[uu] == cut_s && n < cut_i))) ++uu;
      a.u[n] = uu;
      if (uu == 0) continue;
      U += uu;
      const u64 k0 = entry_key(row[0], n, 0, B), kl = entry_key(row[uu - 1], n, uu - 1, B);
      if (k0 > kmax) kmax = k0;
      hmin = min(hmin, uokey((uint32_t)(kl >> 32)));
      lmin = min(lmin, uokey((uint32_t)kl));
    }
    int r3[3] = {U, hmin, lmin};
    const int op3[3] = {RX_SUM, RX_MIN, RX_MIN};
    cluster_reduce<3, true>(cx, r3, op3, sh.rx, sh.fin, &kmax, sh.w64);
    U = r3[0];

    // ---- the top K_EP usable entries in lax.top_k order: each CTA's
    // candidates at its CTA-total offset in node order, pushed into every
    // CTA's s_key, then sorted there
    n_cand = min(U, K_EP);
    if (n_cand > 0) {
      u64 T = 0;
      if (U > K_EP) {
        const u64 kmin = ((u64)uounkey(r3[1]) << 32) | (u64)uounkey(r3[2]);
        const RowSet rs = {a.table + (size_t)lo * B1, B1, a.u + lo, lo, hi - lo, B, B};
        T = cluster_select_key(cx, rs, K_EP, kmin, kmax, sh.hist, sh.sel, sh.rx, sh.fin, sh.w64);
      }
      int* c0 = a.counts;  // each slice node's entries in the top
      int own = 0;
      for (int n = lo + tid; n < hi; n += CLUSTER_THREADS) {
        const int cn = T ? count_at_least(a.table + (size_t)n * B1, n, a.u[n], B, T) : a.u[n];
        c0[n] = cn;
        own += cn;
      }
      int base = cluster_offset(cx, block_sum_int(own, sh.idx), sh.fin);
      const uint32_t mbar = cx.mbar_a + 8 * cx.parity, key_a = smem_u32(s_key);
      if (tid == 0) mbar_arrive_expect(mbar, (uint32_t)(n_cand * 8));
      for (int l0 = lo; l0 < hi; l0 += CLUSTER_THREADS) {  // uniform trips: every thread scans
        const int n = l0 + tid;
        const int cn = n < hi ? c0[n] : 0;
        int total;
        const int p0 = base + block_exclusive_scan(cn, sh.idx, &total);
        const float* row = a.table + (size_t)n * B1;
        for (int k = 0; k < cn; ++k) {
          const u64 key = entry_key(row[k], n, k, B);
          for (int r = 0; r < cx.C; ++r) {
            const uint32_t dst = at_rank(key_a + 8 * (p0 + k), r), mb = at_rank(mbar, r);
            st_async(dst, (int)(uint32_t)key, mb);
            st_async(dst + 4, (int)(uint32_t)(key >> 32), mb);
          }
        }
        base += total;
      }
      round_wait(cx);
      int L = 2;
      while (L < n_cand) L <<= 1;
      for (int i = n_cand + tid; i < L; i += CLUSTER_THREADS) s_key[i] = 0ull;
      bitonic_sort<u64, true>(s_key, L);
      // each position's budget domain, from its node's gathered row; the
      // keys kept for the clearing after the fold (the rounds reuse s_key)
      for (int p = tid; p < n_cand; p += CLUSTER_THREADS) {
        s_dom[p] = (int)full[(size_t)key_node(s_key[p], B) * P + B1 + 9];
        cp.keys[p] = s_key[p];
      }
      __syncthreads();
      const AffShared shr = {s_red, s_int, s_occ, s_prise, s_prov, s_hist, &s_L, &s_PL, s_key};
      got = affinity_rounds_compact<4>(c, e, cp, shr, s_dom, s_h0, dm, m - placed, n_cand, L,
                                       has_budget, dns_live, c.inc_live, rounds);
    }

    // ---- the normalizer sandwich: S_lo <= every F_t <= F_hi
    if (got > 0) {
      float w7[7];
      affinity_lower_set(tg, e, AvailGathered{a.avail}, dm, lo, hi, has_budget, w7, s_red);
      int r7[7];
      for (int k = 0; k < 7; ++k) r7[k] = okey(w7[k]);
      const int op7[7] = {RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MAX, RX_MIN, RX_MIN};
      cluster_reduce<7>(cx, r7, op7, sh.rx, sh.fin);
      for (int k = 0; k < 7; ++k) w7[k] = ounkey(r7[k]);
      bool lo_ok = uniform_base || (v[7] == w7[0] && v[8] == w7[1] && v[9] == w7[2]
                                    && v[10] == w7[3] && v[12] == w7[5] && v[13] == w7[6]);
      if (ss_live) lo_ok = lo_ok && v[11] == w7[4];
      use_multi = lo_ok;
    }
  }

  // ---- the head fallback: serial's single next pick is always exact
  int head = -1;
  if (!use_multi && any_start) {
    float hv = -INFINITY;
    int hn = INT_HI;
    for (int n = lo + tid; n < hi; n += CLUSTER_THREADS)
      argmax_update((a.flags[n] & AF_START) ? a.table[(size_t)n * B1] : -INFINITY, n, &hv, &hn);
    head = cluster_argmax(cx, hv, hn, sh.rx, sh.fin);
  }

  // ---- every CTA has read the live rows and the state: fold the slice's
  // takes into j and the live rows, each slot's domain from the gathered row
  cluster_barrier_uncounted();
  affinity_fold(c, e, D1, lo, hi, use_multi, head, j,
                [&](int n, int r) { return (int)full[(size_t)n * P + B1 + 11 + r]; });
  if (n_cand > 0) {  // this CTA's takes back to 0 for the next epoch
    __syncthreads();
    for (int p = tid; p < n_cand; p += CLUSTER_THREADS) e.counts[key_node(cp.keys[p], B)] = 0;
  }
  const int m_take = use_multi ? got : (head >= 0 ? 1 : 0);
  if (cx.rank == 0 && tid == 0) {
    state[0] = placed + m_take;
    state[1] = m_take;
    state[2] += 1;
    state[3] += head >= 0;
    state[4] += use_multi ? rounds : 0;
  }
}

// cluster.cuh cluster_kernel_init with K9's shared-memory bound
template <typename... Params>
static cudaError_t k9_init(void (*kernel)(Params...)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K9_SMEM_MAX);
  return e;
}

// ------------------------------------------------------------ C interface --

extern "C" {

static long long affinity_sharded_rows(const TablesView* t) {
  return (long long)(t->Sd + t->A + t->B + t->Ca + t->Cw + 1) * t->D1;
}

// (float scratch, int scratch, stacked vector, payload row) sizes of K9 at
// depth B for N nodes (the mesh's)
long long affinity_sharded_scratch_floats(const TablesView* t, int B, int N) {
  return (long long)N * (B + 1) + 6LL * N + affinity_sharded_rows(t) + 2LL * t->D1 + t->Z
         + 2LL * N;
}
long long affinity_sharded_scratch_ints(const TablesView* t, int N) {
  return 7LL * N + 4LL * t->D1 + N + (affinity_sharded_rows(t) / t->D1) * (long long)N;
}
int affinity_sharded_parts(const TablesView* t) { return AS_FIXED + 2 * t->Cw; }
int affinity_sharded_pay_floats(const TablesView* t, int B) {
  return B + AS_PAY_FIXED + (int)(affinity_sharded_rows(t) / t->D1);
}

// The block stages' and the tail's dynamic shared memory at C, their bound
// (ops/cluster.py takes them from here), and the ints of the tail's
// per-CTA scratch (zeroed before a segment's first epoch)
long long affinity_sharded_smem(const TablesView* t, int C) { return k9_smem_bytes(*t, C); }
long long affinity_sharded_tail_smem(const TablesView* t, int C) {
  return k9_tail_smem_bytes(*t, C);
}
long long affinity_sharded_smem_max() { return K9_SMEM_MAX; }
long long affinity_sharded_cta_ints(const TablesView* t, int N) { return k9_cta_ints(N, t->D1); }

// Allow each K9 kernel clusters of 16 and K9_SMEM_MAX bytes of dynamic
// shared memory, once per device
int affinity_sharded_init() {
  cudaError_t e = k9_init(affinity_sharded_setup);
  if (e == cudaSuccess) e = k9_init(affinity_sharded_front);
  if (e == cudaSuccess) e = k9_init(affinity_sharded_table);
  if (e == cudaSuccess) e = k9_init(affinity_sharded_tail);
  return (int)e;
}

static bool k9_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

// Clusters of C CTAs with `smem` bytes of the block stages' largest (the
// front; tail 0) or of the tail (tail 1) that can be resident at once
int affinity_sharded_occupancy(int tail, int C, long long smem, int* out) {
  if (!k9_size_ok(C)) return (int)cudaErrorInvalidValue;
  return tail ? cluster_occupancy_of(affinity_sharded_tail, C, smem, out)
              : cluster_occupancy_of(affinity_sharded_front, C, smem, out);
}

#define K9_SHAPE_OK(formula)                                                       \
  if (!k9_size_ok(C) || smem != (formula) || smem > K9_SMEM_MAX) \
  return (int)cudaErrorInvalidValue

// t: the block's view, rebased by lo (affinity_sharded.cuh); N: the mesh's
// nodes. The setup, front and table: one cluster of C CTAs over the block,
// `smem` = affinity_sharded_smem(t, C); the tail: one cluster over the N
// nodes, `smem` = affinity_sharded_tail_smem(t, C), cs C slices of
// affinity_sharded_cta_ints. Any other shape is refused.
int affinity_sharded_setup_launch(const TablesView* t, int g, int cap1, int B, int N, int lo,
                                  int hi, int* j, float* fs, int* is, int* state, int C,
                                  long long smem, cudaStream_t stream) {
  K9_SHAPE_OK(k9_smem_bytes(*t, C));
  return cluster_launch(affinity_sharded_setup, C, 1, 0, stream, *t, g, cap1, B, N, lo, hi, j, fs,
                        is, state);
}

int affinity_sharded_front_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                  const int* j, float* fs, int* is, float* part, int* state, int C,
                                  long long smem, cudaStream_t stream) {
  K9_SHAPE_OK(k9_smem_bytes(*t, C));
  return cluster_launch(affinity_sharded_front, C, 1, smem, stream, *t, g, B, N, lo, hi, j, fs,
                        is, part, state);
}

int affinity_sharded_table_launch(const TablesView* t, int g, int B, int N, int lo, int hi,
                                  const int* j, float* fs, int* is, const float* red, float* pay,
                                  int C, long long smem, cudaStream_t stream) {
  K9_SHAPE_OK(k9_smem_bytes(*t, C));
  return cluster_launch(affinity_sharded_table, C, 1, 0, stream, *t, g, B, N, lo, hi, j, fs, is,
                        red, pay);
}

int affinity_sharded_tail_launch(const TablesView* t, int g, int m, int ss_live, int B, int N,
                                 int* j, float* fs, int* is, const float* red, const float* full,
                                 int* state, int* cs, int C, long long smem, cudaStream_t stream) {
  K9_SHAPE_OK(k9_tail_smem_bytes(*t, C));
  return cluster_launch(affinity_sharded_tail, C, 1, smem, stream, *t, g, m, ss_live, B, N, j, fs,
                        is, red, full, state, cs);
}

}  // extern "C"
