// Hand-written Hopper kernel for the group-serial ("spread") route on a
// partitioned node mesh.
//
// K13 replaces open_simulator_tpu/ops/kernels.py `schedule_group_serial`
//    (:2104) as XLA partitions it over the nodes under the layout of
//    parallel/mesh.py (`table_shardings` :67, `carry_shardings` :101,
//    `ShardedKernels` :360, `_sched_jit` :413): each rank holds only its
//    block of NL nodes of every [*, N] table and [N, *] carry row; the live
//    DoNotSchedule and ScheduleAnyway [*, D+1] rows are replicated. It is
//    K4 (group_serial.cu) cut at its cross-node reductions into K12's
//    stages (batch_sharded.cu), with the collectives of
//    parallel/collectives.py between them (ops/kernels.py
//    `schedule_group_serial_sharded_kernel` drives them; its plain version
//    is `schedule_group_serial_sharded_plain`).
//
// Every stage is one thread-block cluster of C CTAs of 512 threads
// (cluster.cuh; C from ops/cluster.py `choose` over the block's NL nodes),
// CTA r owning the node slice [r * chunk, (r + 1) * chunk) of the block; the
// cross-node values are cluster rounds (wave_cluster.cuh, merge.cuh):
// - setup, once: K4's hoisted run state on each CTA's slice (the base
//   feasibility without DoNotSchedule, the capacity, the constant score
//   terms, the SelectorSpread base counts, the nodes ScheduleAnyway
//   ignores, j = 0), the live rows from the carry (in global scratch, each
//   CTA a share of them);
// - per valid pod, A (front): the previous pod's commit from its gathered
//   rows by CTA 0 (the live rows, placed, and j += 1 where this rank owns
//   the winner), then one cluster barrier, which orders the commit and the
//   clearing of the marks before every read below; the live DoNotSchedule
//   minima, each CTA over its share of the D+1 domains, in one round (a
//   minimum as the maximum of its negation, as okey); the live filter on
//   the slice and the block's partial vector (ops/kernels.py GS_HEAD) in
//   one round: the maxima of simon, nodeaff, taint, ip and the
//   SelectorSpread counts and of -simon, -ip as okey, any feasible and any
//   zoned feasible node as maxima of 0 / 1, the [Z] zone sums (ss_live) as
//   integer sums; CTA 0 writes them. With sa_live every CTA stores 1.0
//   into the vector's [Ss, D+1] domain marks in global memory (one value:
//   the order of the stores is moot). all_gather_rows #1;
// - A2 (sa, sa_live only): the topology sizes from every rank's marks, each
//   CTA counting a share of the domains, one round summing the counts; the
//   raw scores of the slice's relevant nodes from the live rows, their
//   max and negated min in one round. pmax #1b;
// - B (score): the vector reduced in rank order (maxima by max, the zone
//   sums by an ordered sum: integer-valued, exact), K4's score on each
//   slice and the block's first max (cluster_argmax on (okey score, global
//   node)); the CTA that owns the winner writes its row [score, global
//   node, the node's DoNotSchedule and ScheduleAnyway domains], one f64
//   row [2 + Sd + Ss]. all_gather_rows #2;
// - C (commit, in the next pod's front or the finish launch): every rank
//   takes the same winner, the largest score and then the lowest global
//   node; no feasible node anywhere places nothing and changes nothing.
// CTA 0 alone applies the replicated row update (K4 keeps a copy a CTA
// because its commit and its next step share one launch with no barrier
// between them; here the front's one cluster barrier orders the commit
// before every read, so one copy in scratch, updated once a pod, serves
// every CTA). Exactly two all_gather_rows per valid pod and a pmax more
// with sa_live. The host reads nothing per pod; `placed` is counted on the
// card.
//
// Exactness contract (common.cuh): --fmad=false, K4's score in its order,
// log in f64 rounded once, first-max ties on the global node, the zone
// sums and the mark counts as integers (exact in any grouping), min as
// -max(-x) (okey keeps every float bit for bit).
//
// What bounds it on an H100: as K12, the pod's three or four launches and
// two or three collectives (host round trips when ranks share a card over
// gloo), not the block's bytes (a few dozen a node a pod). A stage's
// device time is a launch, a start and an end cluster barrier and one or
// two rounds over one or two nodes a thread.

#include "common.cuh"
#include "merge.cuh"

// node flags of one step (K4's)
#define GS_F 1    // feasible
#define GS_REL 2  // counts for ScheduleAnyway (carries every term's key)

// the partial vector's head (ops/kernels.py GS_HEAD)
enum { Q_SIMON = 0, Q_NODEAFF, Q_TAINT, Q_IP, Q_PERNODE, Q_NSIMON, Q_NIP, Q_ANY, Q_ZONED,
       Q_HEAD };

// The dynamic shared memory a K13 stage may ask for: its CTAs also hold
// StageShared and the block reductions' words in static shared memory
// (ops/cluster.py takes it from gs_sharded_smem_max)
#define K13_SMEM_MAX (CLUSTER_SMEM_MAX - 16384)

// Float scratch: ip_raw, simon_s, static, base pernode, sa_raw [NL] each,
// then cnt [Sd, D1], cnt_sa [Ss, D1]. Int scratch: feas, cap, flags,
// sa_ignored, j [NL] each, then placed.
struct GsScratch {
  float *ip, *simon_s, *stat, *pern0, *sa_raw, *cnt, *cnt_sa;
  int *feas, *cap, *flags, *ign, *j, *placed;
};

static __device__ __forceinline__ GsScratch gs_scratch(const TablesView& t, float* fs, int* is) {
  const int N = t.N;
  GsScratch s;
  s.ip = fs;
  s.simon_s = s.ip + N;
  s.stat = s.simon_s + N;
  s.pern0 = s.stat + N;
  s.sa_raw = s.pern0 + N;
  s.cnt = s.sa_raw + N;
  s.cnt_sa = s.cnt + (size_t)t.Sd * t.D1;
  s.feas = is;
  s.cap = s.feas + N;
  s.flags = s.cap + N;
  s.ign = s.flags + N;
  s.j = s.ign + N;
  s.placed = s.j + N;
  return s;
}

// floats of the partial vector, and the offset of its marks
static __host__ __device__ int gs_part_floats(const TablesView& t, int ss_live, int sa_live) {
  return Q_HEAD + (ss_live ? t.Z : 0) + (sa_live ? t.Ss * t.D1 : 0);
}
static __host__ __device__ int gs_marks_at(const TablesView& t, int ss_live) {
  return Q_HEAD + (ss_live ? t.Z : 0);
}

// A stage's round slot and row: the minima (Sd), the front's row (the
// head's 9 maxima and the Z zone sums), or the sa stage's Ss counts
static __host__ __device__ inline int k13_words(const TablesView& t) {
  int w = Q_HEAD + t.Z;
  if (t.Sd > w) w = t.Sd;
  return t.Ss > w ? t.Ss : w;
}

// K13's dynamic shared memory at C, every stage's: the round slots
// [2][C][W], fin [W] and the CTA's row [W] (the score stage's zone sums)
static __host__ __device__ inline long long k13_smem_bytes(const TablesView& t, int C) {
  const long long W = k13_words(t);
  return 4LL * (2 * C * W + 2 * W);
}

// ---- C: the previous pod's commit from every rank's best row ([R, 2 + Sd
// + Ss] f64, rank order) into the live rows, j and placed, by one CTA. The
// caller orders it with a cluster barrier.
static __device__ void gs_commit(const TablesView& t, int g, int lo, int R, int sa_live,
                                 const double* rows, const GsScratch& s) {
  const int W = 2 + t.Sd + t.Ss, D = t.D1 - 1, tid = threadIdx.x;
  int win = 0;  // the largest score, then the lowest global node
  for (int r = 1; r < R; ++r) {
    const double v = rows[(size_t)r * W], b = rows[(size_t)win * W];
    if (v > b || (v == b && rows[(size_t)r * W + 1] < rows[(size_t)win * W + 1])) win = r;
  }
  const double* row = rows + (size_t)win * W;
  if (row[0] == -INFINITY) return;  // no feasible node on any rank
  for (int k = tid; k < t.Sd; k += CLUSTER_THREADS) {
    const int id = t.dns_t[g * t.Sd + k];
    if (id >= 0 && t.counter_sel_match_g[(size_t)id * t.G + g])
      s.cnt[(size_t)k * t.D1 + (int)row[2 + k]] += 1.0f;
  }
  if (sa_live) {
    for (int k = tid; k < t.Ss; k += CLUSTER_THREADS) {
      const int id = t.sa_t[g * t.Ss + k];
      if (id < 0 || !t.counter_sel_match_g[(size_t)id * t.G + g]) continue;
      const int dom = (int)row[2 + t.Sd + k];
      if (dom < D) s.cnt_sa[(size_t)k * t.D1 + dom] += 1.0f;
    }
  }
  if (tid == 0) {
    const int cl = (int)row[1] - lo;
    if (cl >= 0 && cl < t.N) s.j[cl] += 1;  // this rank owns the node
    *s.placed += 1;
  }
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
gs_sharded_setup(TablesView t, int g, int cap1, float* fs, int* is) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  POD_BIND(pc, t);
  const int N = t.N, D1 = t.D1, D = D1 - 1, tid = threadIdx.x;
  const int Sd = t.Sd, Ss = t.Ss, rank = cluster_rank();
  const GsScratch s = gs_scratch(t, fs, is);
  const int ss_id = max(t.ss_t[g], 0);
  int a, b;
  cta_slice(N, &a, &b);
  pod_prologue(t, g, 0, &pc, s_red);
  for (int n = a + tid; n < b; n += CLUSTER_THREADS) {
    segment_node_constants<false, false>(t, &pc, g, n, cap1, 0, 1, &s.feas[n], &s.cap[n],
                                         &s.ip[n], &s.simon_s[n], &s.stat[n]);
    s.pern0[n] = t.counter[(size_t)ss_id * D1 + t.counter_dom[(size_t)ss_id * N + n]];
    bool ignored = false;
    for (int k = 0; k < Ss; ++k) {
      const int id = t.sa_t[g * Ss + k];
      if (id >= 0 && t.counter_dom[(size_t)id * N + n] >= D) ignored = true;
    }
    s.ign[n] = ignored;
    s.j[n] = 0;
  }
  const size_t i0 = (size_t)rank * CLUSTER_THREADS + tid;
  const size_t stride = (size_t)cluster_ctas() * CLUSTER_THREADS;
  for (size_t i = i0; i < (size_t)Sd * D1; i += stride)
    s.cnt[i] = t.counter[(size_t)max(t.dns_t[g * Sd + i / D1], 0) * D1 + i % D1];
  for (size_t i = i0; i < (size_t)Ss * D1; i += stride)
    s.cnt_sa[i] = t.counter[(size_t)max(t.sa_t[g * Ss + i / D1], 0) * D1 + i % D1];
  if (rank == 0 && tid == 0) *s.placed = 0;
}

// ---- A: the previous pod's commit (prev_rows not null), then the block's
// feasible set and partial vector `part`
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
gs_sharded_front(TablesView t, int g, int lo, int R, int ss_live, int sa_live,
                 const double* prev_rows, float* fs, int* is, float* part) {
  __shared__ StageShared sh;
  SLOT_ARRAY(float, s_min);
  extern __shared__ __align__(16) uint32_t smem[];
  SLOT_BIND(s_min, t, WR_MN);
  const int N = t.N, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, lane = tid & 31;
  const int Sd = t.Sd, Ss = t.Ss, Z = t.Z, W = k13_words(t);
  const size_t gN = (size_t)g * N;
  const GsScratch s = gs_scratch(t, fs, is);
  Cluster cx = cluster_setup(N, W, (int*)smem, sh.mbar);
  int* fin = (int*)smem + 2 * cx.C * W;
  int* acc = fin + W;  // the CTA's row
  if (prev_rows != nullptr && cx.rank == 0) gs_commit(t, g, lo, R, sa_live, prev_rows, s);
  const int K1 = gs_part_floats(t, ss_live, sa_live), mk = gs_marks_at(t, ss_live);
  for (int i = mk + cx.rank * CLUSTER_THREADS + tid; i < K1; i += cx.C * CLUSTER_THREADS)
    part[i] = 0.0f;  // the marks
  for (int k = tid; k < Sd; k += CLUSTER_THREADS) acc[k] = okey(-INFINITY);
  // every CTA started (its mbarriers visible), the commit and the marks'
  // clearing done before any read below: release / acquire at cluster scope
  cluster_barrier_uncounted();

  // the DoNotSchedule minimum of every valid term from the live rows: each
  // CTA over its share of the domains, the minimum as the maximum of its
  // negation (0 where no domain is eligible)
  if (Sd > 0) {
    const int dc = (D1 + cx.C - 1) / cx.C, d0 = min(D1, cx.rank * dc), d1 = min(D1, d0 + dc);
    for (int k = 0; k < Sd; ++k) {
      if (t.dns_t[g * Sd + k] < 0) continue;
      const uint8_t* edom = t.dns_edom + ((size_t)g * Sd + k) * D1;
      float mn = INFINITY;
      for (int d = d0 + tid; d < d1; d += CLUSTER_THREADS)
        if (edom[d]) mn = fminf(mn, s.cnt[(size_t)k * D1 + d]);
      const int r = __reduce_max_sync(FULL_MASK, okey(-mn));
      if (lane == 0) atomicMax(&acc[k], r);
    }
    __syncthreads();
    cluster_row_round(cx, acc, Sd, Sd, fin);
    if (tid < Sd) {
      const float mn = -ounkey(fin[tid]);
      s_min[tid] = isfinite(mn) ? mn : 0.0f;
    }
  }
  const int nw = Q_HEAD + (ss_live ? Z : 0);
  for (int k = tid; k < nw; k += CLUSTER_THREADS) acc[k] = k < Q_ANY ? okey(-INFINITY) : 0;
  __syncthreads();

  float* marks = part + mk;  // [Ss, D1], sa_live only
  float mx[7] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
  bool anyF = false, zoned = false;
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    bool F = s.feas[n] && s.cap[n] - s.j[n] > 0;
    for (int k = 0; k < Sd && F; ++k) {
      const int id = t.dns_t[g * Sd + k];
      if (id < 0) continue;
      const int dom = t.counter_dom[(size_t)id * N + n];
      const float at = s.cnt[(size_t)k * D1 + dom];
      F = dom < D && at + t.dns_self[g * Sd + k] - s_min[k] <= t.dns_maxskew[g * Sd + k];
    }
    int flags = 0;
    if (F) {
      anyF = true;
      flags = GS_F;
      const float pn = s.pern0[n] + (float)s.j[n];
      mx[0] = fmaxf(mx[0], s.simon_s[n]);
      mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
      mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
      mx[3] = fmaxf(mx[3], s.ip[n]);
      mx[4] = fmaxf(mx[4], pn);
      mx[5] = fmaxf(mx[5], -s.simon_s[n]);
      mx[6] = fmaxf(mx[6], -s.ip[n]);
      const int zone = t.node_zone[n];
      if (zone > 0) zoned = true;
      if (ss_live && zone >= 0 && zone < Z) atomicAdd(&acc[Q_HEAD + zone], (int)pn);  // counts
      if (sa_live && !s.ign[n]) {
        flags |= GS_REL;
        for (int k = 0; k < Ss; ++k) {
          const int id = t.sa_t[g * Ss + k];
          if (id >= 0) marks[(size_t)k * D1 + t.counter_dom[(size_t)id * N + n]] = 1.0f;
        }
      }
    }
    s.flags[n] = flags;
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int r = __reduce_max_sync(FULL_MASK, okey(mx[k]));
    if (lane == 0) atomicMax(&acc[k], r);
  }
  if (__any_sync(FULL_MASK, anyF) && lane == 0) atomicMax(&acc[Q_ANY], 1);
  if (__any_sync(FULL_MASK, zoned) && lane == 0) atomicMax(&acc[Q_ZONED], 1);
  __syncthreads();
  cluster_row_round(cx, acc, Q_HEAD, nw, fin);
  if (cx.rank == 0)
    for (int k = tid; k < nw; k += CLUSTER_THREADS)
      part[k] = k < Q_ANY ? ounkey(fin[k]) : (k < Q_HEAD ? (fin[k] ? 1.0f : 0.0f)
                                                         : (float)fin[k]);
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// ---- A2: ScheduleAnyway's topology sizes from every rank's marks (rows
// [R, K1], the marks from offset mk), the raw scores of the block's
// relevant nodes from the live rows, and their block max and negated min
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
gs_sharded_sa(TablesView t, int g, int R, const float* rows, int K1, int mk, float* fs, int* is,
              float* part_b) {
  __shared__ StageShared sh;
  SLOT_ARRAY(float, s_tpw);
  extern __shared__ __align__(16) uint32_t smem[];
  SLOT_BIND(s_tpw, t, WR_TPW);
  const int N = t.N, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, lane = tid & 31, Ss = t.Ss;
  const int W = k13_words(t);
  const GsScratch s = gs_scratch(t, fs, is);
  Cluster cx = cluster_stage(N, W, (int*)smem, sh.mbar);
  int* fin = (int*)smem + 2 * cx.C * W;
  int* acc = fin + W;  // the CTA's count of marked domains of each term
  for (int k = tid; k < Ss; k += CLUSTER_THREADS) acc[k] = 0;
  __syncthreads();
  // this CTA's share of the domains (the sentinel excluded)
  const int dc = (D + cx.C - 1) / cx.C, d0 = min(D, cx.rank * dc), d1 = min(D, d0 + dc);
  for (int k = 0; k < Ss; ++k) {
    if (t.sa_t[g * Ss + k] < 0) continue;
    int cnt = 0;
    for (int d = d0 + tid; d < d1; d += CLUSTER_THREADS) {
      float m = 0.0f;
      for (int r = 0; r < R; ++r) m = fmaxf(m, rows[(size_t)r * K1 + mk + (size_t)k * D1 + d]);
      if (m != 0.0f) ++cnt;
    }
    cnt = __reduce_add_sync(FULL_MASK, cnt);
    if (lane == 0 && cnt) atomicAdd(&acc[k], cnt);
  }
  __syncthreads();
  cluster_row_round(cx, acc, 0, Ss, fin);
  for (int k = tid; k < Ss; k += CLUSTER_THREADS)
    if (t.sa_t[g * Ss + k] >= 0) s_tpw[k] = topology_weight((float)fin[k]);
  __syncthreads();
  float v[2] = {-INFINITY, -INFINITY};
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    if (!(s.flags[n] & GS_REL)) continue;
    float a = 0.0f;
    for (int k = 0; k < Ss; ++k) {
      const int id = t.sa_t[g * Ss + k];
      if (id < 0) continue;
      const float c = s.cnt_sa[(size_t)k * D1 + t.counter_dom[(size_t)id * N + n]];
      a = a + (c * s_tpw[k] + (t.sa_maxskew[g * Ss + k] - 1.0f));
    }
    const float raw = floorf(a);
    s.sa_raw[n] = raw;
    v[0] = fmaxf(v[0], raw);
    v[1] = fmaxf(v[1], -raw);
  }
  int r2[2] = {okey(v[0]), okey(v[1])};
  const int op2[2] = {RX_MAX, RX_MAX};
  cluster_reduce<2>(cx, r2, op2, sh.rx, sh.fin);
  if (cx.rank == 0 && tid < 2) part_b[tid] = ounkey(r2[tid]);
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// ---- B: the normalizers from every rank's partials (rows [R, K1]) and
// ScheduleAnyway's reduced extrema (sa_red, null without sa_live), then
// K4's score on the block and its first max: row2 = [score, global node,
// the node's DoNotSchedule domains (Sd), its ScheduleAnyway domains (Ss)]
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
gs_sharded_score(TablesView t, int g, int lo, int R, int ss_live, int sa_live, const float* rows,
                 int K1, const float* sa_red, float* fs, int* is, double* row2) {
  __shared__ StageShared sh;
  __shared__ float s_red[32];
  __shared__ float s_head[Q_HEAD];
  extern __shared__ __align__(16) uint32_t smem[];
  const int N = t.N, Rr = t.R, D = t.D1 - 1, tid = threadIdx.x, Z = t.Z;
  const int Sd = t.Sd, Ss = t.Ss, W = k13_words(t);
  const size_t gN = (size_t)g * N;
  const GsScratch s = gs_scratch(t, fs, is);
  Cluster cx = cluster_stage(N, W, (int*)smem, sh.mbar);
  float* zone_sums = reinterpret_cast<float*>(smem) + 2 * cx.C * W + W;  // [Z], reduced
  if (tid < Q_HEAD) {
    float m = rows[tid];
    for (int r = 1; r < R; ++r) m = fmaxf(m, rows[(size_t)r * K1 + tid]);
    s_head[tid] = m;
  }
  if (ss_live) {
    for (int z = tid; z < Z; z += CLUSTER_THREADS) {
      float x = rows[Q_HEAD + z];
      for (int r = 1; r < R; ++r) x = x + rows[(size_t)r * K1 + Q_HEAD + z];  // rank order
      zone_sums[z] = x;
    }
  }
  __syncthreads();
  float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
  if (ss_live)
    for (int z = 1 + tid; z < Z; z += CLUSTER_THREADS) maxZ = fmaxf(maxZ, zone_sums[z]);
  {
    float v[1] = {maxZ};
    const int op[1] = {OP_MAX};
    block_reduce<1>(v, op, s_red);
    maxZ = v[0];
  }
  const Norms nm = {s_head[Q_SIMON], -s_head[Q_NSIMON], fmaxf(s_head[Q_NODEAFF], 0.0f),
                    fmaxf(s_head[Q_TAINT], 0.0f), fmaxf(s_head[Q_IP], 0.0f),
                    fminf(-s_head[Q_NIP], 0.0f)};
  const float maxN = fmaxf(s_head[Q_PERNODE], 0.0f);
  const bool have_zones = s_head[Q_ZONED] > 0.0f;
  float sa_hi = 0.0f, sa_lo = 0.0f;
  if (sa_live) {
    sa_hi = fmaxf(sa_red[0], 0.0f);
    const float lo_raw = -sa_red[1];
    sa_lo = isfinite(lo_raw) ? lo_raw : 0.0f;
  }
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  float best = -INFINITY;
  int best_i = INT_HI;
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    const int fl = s.flags[n];
    if (!fl) continue;
    // the candidate pod counts toward its own usage, hence j + 1
    const float copies = (float)(s.j[n] + 1);
    float least, bal;
    least_balanced(t.nonzero[(size_t)n * 2 + 0] + gz_c * copies,
                   t.nonzero[(size_t)n * 2 + 1] + gz_m * copies,
                   t.alloc[(size_t)n * Rr + 0], t.alloc[(size_t)n * Rr + 1], &least, &bal);
    const float lb = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal;
    float simon, nodeaff, taint, interpod;
    normalized_terms(nm, s.simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], s.ip[n],
                     &simon, &nodeaff, &taint, &interpod);
    float score = lb + t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff + t.w[W_TAINT] * taint
                  + t.w[W_INTERPOD] * interpod + s.stat[n];
    if (ss_live) {
      const int zone = t.node_zone[n];
      const float zs = (zone >= 0 && zone < Z) ? zone_sums[zone] : 0.0f;
      const float blend = selector_spread_blend(s.pern0[n] + (float)s.j[n], maxN, zs, maxZ,
                                                have_zones && zone > 0);
      score = score + t.w[W_SS] * floorf(blend);
    }
    if (sa_live) {
      const float pts = (fl & GS_REL) ? sa_normalized(s.sa_raw[n], sa_hi, sa_lo) : 0.0f;
      score = score + t.w[W_PTS] * pts;
    }
    argmax_update(score, lo + n, &best, &best_i);
  }
  // the block's first max on the global node; the thread that holds it
  // writes the score, the CTA that owns it the domain columns
  const int c = cluster_argmax(cx, best, best_i, sh.rx, sh.fin);
  if (c != INT_HI) {
    if (best_i == c) {
      row2[0] = (double)best;
      row2[1] = (double)c;
    }
    const int cl = c - lo;
    if (cl >= cx.lo && cl < cx.hi) {
      for (int k = tid; k < Sd + Ss; k += CLUSTER_THREADS) {
        const int id = k < Sd ? t.dns_t[g * Sd + k] : t.sa_t[g * Ss + k - Sd];
        row2[2 + k] = id >= 0 ? (double)t.counter_dom[(size_t)id * N + cl] : (double)D;
      }
    }
  } else if (cx.rank == 0) {  // no feasible node in the block
    if (tid == 0) {
      row2[0] = -INFINITY;
      row2[1] = (double)(lo + N);
    }
    for (int k = tid; k < Sd + Ss; k += CLUSTER_THREADS) row2[2 + k] = (double)D;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// ---- the last pod's commit
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
gs_sharded_finish(TablesView t, int g, int lo, int R, int sa_live, const double* rows, float* fs,
                  int* is) {
  if (cluster_rank() == 0) gs_commit(t, g, lo, R, sa_live, rows, gs_scratch(t, fs, is));
}

// cluster.cuh cluster_kernel_init with K13's shared-memory bound
template <typename... Params>
static cudaError_t k13_init(void (*kernel)(Params...)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K13_SMEM_MAX);
  return e;
}

// ------------------------------------------------------------ C interface --

static bool k13_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

#define K13_SHAPE_OK                                                                  \
  if (!k13_size_ok(C) || smem != k13_smem_bytes(*t, C) || smem > K13_SMEM_MAX) \
  return (int)cudaErrorInvalidValue

extern "C" {

// (float scratch, int scratch) sizes of K13 on the block's view
long long gs_sharded_scratch_floats(const TablesView* t) {
  return 5LL * t->N + (long long)(t->Sd + t->Ss) * t->D1;
}
long long gs_sharded_scratch_ints(const TablesView* t) { return 5LL * t->N + 1; }
// floats of the partial vector (all_gather_rows #1), and the offset of the
// ScheduleAnyway marks in it
int gs_sharded_part_floats(const TablesView* t, int ss_live, int sa_live) {
  return gs_part_floats(*t, ss_live, sa_live);
}
int gs_sharded_marks_offset(const TablesView* t, int ss_live) { return gs_marks_at(*t, ss_live); }
// offsets of j [NL] and placed in the int scratch
long long gs_sharded_j_offset(const TablesView* t) { return 4LL * t->N; }

// K13's dynamic shared memory at C and its bound (ops/cluster.py takes
// them from here)
long long gs_sharded_smem(const TablesView* t, int C) { return k13_smem_bytes(*t, C); }
long long gs_sharded_smem_max() { return K13_SMEM_MAX; }

// Allow each K13 kernel clusters of 16 and K13_SMEM_MAX bytes of dynamic
// shared memory, once per device
int gs_sharded_init() {
  cudaError_t e = k13_init(gs_sharded_setup);
  if (e == cudaSuccess) e = k13_init(gs_sharded_front);
  if (e == cudaSuccess) e = k13_init(gs_sharded_sa);
  if (e == cudaSuccess) e = k13_init(gs_sharded_score);
  if (e == cudaSuccess) e = k13_init(gs_sharded_finish);
  return (int)e;
}

// Clusters of C CTAs with `smem` bytes of K13's largest stage (the score)
// that can be resident at once, into *out
int gs_sharded_occupancy(int C, long long smem, int* out) {
  if (!k13_size_ok(C)) return (int)cudaErrorInvalidValue;
  return cluster_occupancy_of(gs_sharded_score, C, smem, out);
}

// t: the block's view (N = NL). Every stage: one cluster of C CTAs over the
// block, `smem` = gs_sharded_smem(t, C) (the setup and the finish make no
// round and take none); any other shape is refused.
int gs_sharded_setup_launch(const TablesView* t, int g, int cap1, float* fs, int* is, int C,
                            long long smem, cudaStream_t stream) {
  K13_SHAPE_OK;
  return cluster_launch(gs_sharded_setup, C, 1, 0, stream, *t, g, cap1, fs, is);
}

int gs_sharded_front_launch(const TablesView* t, int g, int lo, int R, int ss_live, int sa_live,
                            const double* prev_rows, float* fs, int* is, float* part, int C,
                            long long smem, cudaStream_t stream) {
  K13_SHAPE_OK;
  return cluster_launch(gs_sharded_front, C, 1, smem, stream, *t, g, lo, R, ss_live, sa_live,
                        prev_rows, fs, is, part);
}

int gs_sharded_sa_launch(const TablesView* t, int g, int R, const float* rows, int K1, int mk,
                         float* fs, int* is, float* part_b, int C, long long smem,
                         cudaStream_t stream) {
  K13_SHAPE_OK;
  return cluster_launch(gs_sharded_sa, C, 1, smem, stream, *t, g, R, rows, K1, mk, fs, is,
                        part_b);
}

int gs_sharded_score_launch(const TablesView* t, int g, int lo, int R, int ss_live, int sa_live,
                            const float* rows, int K1, const float* sa_red, float* fs, int* is,
                            double* row2, int C, long long smem, cudaStream_t stream) {
  K13_SHAPE_OK;
  return cluster_launch(gs_sharded_score, C, 1, smem, stream, *t, g, lo, R, ss_live, sa_live,
                        rows, K1, sa_red, fs, is, row2);
}

int gs_sharded_finish_launch(const TablesView* t, int g, int lo, int R, int sa_live,
                             const double* rows, float* fs, int* is, int C, long long smem,
                             cudaStream_t stream) {
  K13_SHAPE_OK;
  return cluster_launch(gs_sharded_finish, C, 1, 0, stream, *t, g, lo, R, sa_live, rows, fs, is);
}

}  // extern "C"
