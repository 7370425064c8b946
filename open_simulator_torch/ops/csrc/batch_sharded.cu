// Hand-written Hopper kernel for the serial route on a partitioned node mesh.
//
// K12 replaces open_simulator_tpu/ops/kernels.py `schedule_batch` (:2267,
//    the lax.scan of `_step` :728) as XLA partitions it over the nodes under
//    the layout of parallel/mesh.py (`table_shardings` :67, `carry_shardings`
//    :101, `ShardedKernels` :360): each rank holds only its block of NL nodes
//    of every [*, N] table and [N, *] carry row, and the counters, carriers
//    and per-group tables whole. Its explain mode replaces `explain_jit`
//    (:768) on the same layout; `feasibility_jit` (:743) on the block is K1
//    unchanged (schedule.cu).
//
// One pod is three stages on the block, each its own launch of one
// thread-block cluster of C CTAs of 512 threads (cluster.cuh; C from
// ops/cluster.py `choose` over the block's NL nodes), CTA r owning the node
// slice [r * chunk, (r + 1) * chunk) of the block, with the collectives of
// parallel/collectives.py between them (ops/kernels.py
// `schedule_batch_sharded_kernel` drives them; its plain version is
// `schedule_batch_sharded_plain`):
// - A (front): the previous pod's commit (stage C), then `pod_prologue` on
//   the replicated counters, `node_feasibility` on the slice (a forced node
//   in another block arrives as NL and leaves the block none), the raw score
//   inputs of the feasible nodes, and the block's partial vector: the five
//   maxima, the two minima and Open-Local's low end negated (so that every
//   reduction is a max), Open-Local's high end, any feasible node, any zoned
//   feasible node and SelectorSpread's [Z] zone sums, reduced over the CTAs
//   in one cluster round (maxima as order-preserving integers, the zone
//   sums as integer sums; CTA 0 writes them), and for a group with
//   ScheduleAnyway terms its [Ss, D+1] domain marks, which do not fit on
//   chip at hostname domains: every CTA stores 1.0 into the vector's marks
//   in global memory (one value: the order of the stores is moot).
//   all_gather_rows #1 of that vector.
// - A2 (sa, ScheduleAnyway groups only): the topology sizes from every
//   rank's marks (each CTA counts a share of the domains, one round sums
//   them), the raw scores of the block's relevant nodes and their block max
//   and negated min (one round). pmax #1b of those two.
// - B (score): the vector reduced in rank order (maxima by max, the zone
//   sums by a sum in rank order: integer-valued counts, exact), every
//   normalizer as K2 takes it over all N, the total in COMPONENT_ORDER and
//   the block's first max as (score, global node) with the node's counter
//   and carrier domain columns (cluster_argmax: (okey score, node), first
//   max, as K2 takes it), written once by the CTA that owns the node: one
//   f64 row [2 + T + Tc]. all_gather_rows #2 of that row.
// - C (commit, at the start of the next pod's A or in the commit launch):
//   every rank picks the same winner, the largest score and then the lowest
//   global node (no feasible node anywhere: -1); CTA 0 applies the
//   replicated counter and carrier update from the winner's columns, as
//   K2's commit does, and on the owning rank the CTA that owns the winner's
//   row alone commits requested, nonzero, ports and (EXT) the GPU and
//   storage ledgers at its local row; a cluster barrier orders it before
//   the front reads the carry.
// The host reads nothing per pod: it knows from the tables which groups
// have ScheduleAnyway terms, and reads the choices once at the end.
//
// Explain mode (K7's diagnostic on the block): A with every node's raw
// terms, #1, A2 and #1b, then B writing K7's packed [26, NL] rows with the
// global normalizers, each CTA its slice; the wrapper gathers them tiled at
// the fetch.
//
// Exactness contract (common.cuh): --fmad=false, the total summed in
// COMPONENT_ORDER left to right, log in f64 rounded once, first-max ties,
// atomics only on integer-valued counts (the zone sums), min as -max(-x).
//
// What bounds it on an H100: each pod's stages read about K2's bytes per
// block node (~100), so the bytes of one pod over 3.35 TB/s are well under
// a microsecond at NL = 2,560; the pod's three launches and two or three
// collectives, each a host round trip when ranks share a card over gloo,
// take milliseconds. It is latency bound by the collectives. Design: each
// stage spreads the block over C SMs (one or two nodes a thread), K2's
// device functions unchanged, the per-node SB_* rows in global scratch
// across the launches (each written and read by the thread that owns its
// node); CUDA graphs over the stages and NCCL on one card per rank are
// later work.

#include "common.cuh"
#include "merge.cuh"

// per-node scratch rows of the block: K2's, plus the stage bits
enum { SB_LEAST = 0, SB_BALANCED, SB_SIMON, SB_IP, SB_PERNODE, SB_SA, SB_FLAGS, SB_STORAGE,
       SB_BITS, SB_NODE_ROWS };
// the partial vector's head (ops/kernels.py PART_HEAD)
enum { P_SIMON = 0, P_NODEAFF, P_TAINT, P_IP, P_PERNODE, P_NSIMON, P_NIP, P_ST, P_NST, P_ANY,
       P_ZONED, PART_HEAD };
#define FL_F 1.0f
#define FL_REL 2.0f
// explain output rows (explain.cu)
enum { R_FEASIBLE = 0, R_TOTAL, R_STAGE0, R_COMP0 = R_STAGE0 + N_STAGES };

// The dynamic shared memory a K12 stage may ask for: its CTAs also hold
// StageShared, PodCtx and the block reductions' words in static shared
// memory (ops/cluster.py takes it from batch_sharded_smem_max)
#define K12_SMEM_MAX (CLUSTER_SMEM_MAX - 16384)

// A stage's round slot and row: the front's row (the head's 11 maxima and
// the Z zone sums) or the sa stage's Ss topology counts
static __host__ __device__ inline int k12_words(const TablesView& t) {
  const int w = PART_HEAD + t.Z;
  return w > t.Ss ? w : t.Ss;
}

// K12's dynamic shared memory at C, every stage's: the round slots
// [2][C][W], fin [W] and the CTA's row [W] (the score stage's zone sums)
static __host__ __device__ inline long long k12_smem_bytes(const TablesView& t, int C) {
  const long long W = k12_words(t);
  return 4LL * (2 * C * W + 2 * W);
}

static __device__ bool group_has_sa(const TablesView& t, int g) {
  for (int s = 0; s < t.Ss; ++s)
    if (t.sa_t[g * t.Ss + s] >= 0) return true;
  return false;
}

// floats of group g's partial vector
static __host__ __device__ int part_floats(const TablesView& t, bool sa) {
  return PART_HEAD + t.Z + (sa ? t.Ss * t.D1 : 0);
}

// ---- C: pod p's commit from every rank's best row ([R, 2 + T + Tc] f64,
// rank order), by this CTA of a cluster over the block: the replicated
// counter and carrier update and the choice by CTA 0, the node rows by the
// CTA whose slice [sa, sb) holds the winner. The caller orders it with a
// cluster barrier.
template <bool EXT>
static __device__ void commit_winner(const TablesView& t, int g, int p, int lo, int R,
                                     const double* rows, int* choices, int sa, int sb, bool first) {
  const int W = 2 + t.T + t.Tc, D = t.D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  int win = 0;  // the largest score, then the lowest global node
  for (int r = 1; r < R; ++r) {
    const double s = rows[(size_t)r * W], b = rows[(size_t)win * W];
    if (s > b || (s == b && rows[(size_t)r * W + 1] < rows[(size_t)win * W + 1])) win = r;
  }
  const double* row = rows + (size_t)win * W;
  if (row[0] == -INFINITY) return;  // no feasible node on any rank: the choice stays -1
  const int c = (int)row[1];
  if (first) {
    for (int r = tid; r < t.T; r += bd) {
      const int dom = (int)row[2 + r];
      if (dom < D && t.counter_sel_match_g[(size_t)r * t.G + g])
        t.counter[(size_t)r * t.D1 + dom] += 1.0f;
    }
    for (int r = tid; r < t.Tc; r += bd) {
      const int dom = (int)row[2 + t.T + r];
      if (dom < D) t.carrier[(size_t)r * t.D1 + dom] += t.grp_carries[(size_t)g * t.Tc + r];
    }
    if (tid == 0) choices[p] = c;
  }
  const int cl = c - lo;
  if (cl >= sa && cl < sb) {  // this CTA owns the node
    for (int r = tid; r < t.R; r += bd)
      t.requested[(size_t)cl * t.R + r] += t.grp_requests[(size_t)g * t.R + r];
    if (tid < 2) t.nonzero[(size_t)cl * 2 + tid] += t.grp_nonzero[g * 2 + tid];
    for (int k = tid; k < t.PP; k += bd) {
      const int pid = t.grp_ports[g * t.PP + k];
      if (pid > 0) t.port_used[(size_t)cl * t.PORT1 + pid] = 1;
    }
    if constexpr (EXT) {
      if (tid == 0) {  // the device ledgers at the node, from the carry before the commit
        if (t.f_gpu) gpu_commit_at(t, g, cl);
        if (t.f_storage) storage_commit_at(t, g, cl);
      }
    }
  }
}

// ---- A: the previous pod's commit (prev_rows not null), then group g's
// feasibility, raw terms (every node with all_nodes, else the feasible
// ones) and the block's partial vector `part`
template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
batch_sharded_front_kernel(TablesView t, int g, int forced, int valid, int all_nodes, int lo,
                           int R, const double* prev_rows, int prev_g, int prev_p, int* choices,
                           float* scratch, float* part) {
  __shared__ PodCtx pc;
  __shared__ StageShared sh;
  __shared__ float s_red[32];
  extern __shared__ __align__(16) uint32_t smem[];
  POD_BIND(pc, t);
  const int N = t.N, Rr = t.R, D = t.D1 - 1, tid = threadIdx.x, lane = tid & 31;
  const int W = k12_words(t);
  Cluster cx = cluster_setup(N, W, (int*)smem, sh.mbar);
  int* fin = (int*)smem + 2 * cx.C * W;
  int* acc = fin + W;  // the CTA's row: 11 maxima (okey, flags 0 / 1), then the zone sums
  if (prev_rows != nullptr)
    commit_winner<EXT>(t, prev_g, prev_p, lo, R, prev_rows, choices, cx.lo, cx.hi, cx.rank == 0);
  const bool sa = group_has_sa(t, g);
  const int K1 = part_floats(t, sa), nw = PART_HEAD + t.Z;
  const int stride = cx.C * CLUSTER_THREADS;
  for (int i = PART_HEAD + t.Z + cx.rank * CLUSTER_THREADS + tid; i < K1; i += stride)
    part[i] = 0.0f;  // the marks
  for (int k = tid; k < nw; k += CLUSTER_THREADS) acc[k] = k < P_ANY ? okey(-INFINITY) : 0;
  // every CTA started (its mbarriers visible), the commit and the marks'
  // clearing done before any read below: release / acquire at cluster scope
  cluster_barrier_uncounted();
  pod_prologue(t, g, 1, &pc, s_red);
  const size_t gN = (size_t)g * N;
  const int ss_id = t.ss_t[g];
  const int ssi = ss_id > 0 ? ss_id : 0;
  float* least_s = scratch + (size_t)SB_LEAST * N;
  float* bal_s = scratch + (size_t)SB_BALANCED * N;
  float* simon_s = scratch + (size_t)SB_SIMON * N;
  float* ip_s = scratch + (size_t)SB_IP * N;
  float* pern_s = scratch + (size_t)SB_PERNODE * N;
  float* flags_s = scratch + (size_t)SB_FLAGS * N;
  float* st_s = scratch + (size_t)SB_STORAGE * N;
  float* bits_s = scratch + (size_t)SB_BITS * N;
  float* marks = part + PART_HEAD + t.Z;  // [Ss, D1], sa only

  // maxima of simon, nodeaff, taint, interpod, pernode, -simon, -interpod,
  // storage, -storage over the slice's feasible nodes
  float mx[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) mx[k] = -INFINITY;
  bool anyF = false, zoned = false;
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    float st_raw = 0.0f;
    const uint32_t bits = node_feasibility<EXT, false>(t, &pc, g, forced, valid, 1, 1, n,
                                                       nullptr, &st_raw);
    const bool F = (bits >> BIT_FEASIBLE) & 1u;
    bits_s[n] = (float)bits;  // 13 bits: exact
    float flags = 0.0f;
    if (F || all_nodes) {
      const float used_c = t.nonzero[(size_t)n * 2 + 0] + t.grp_nonzero[g * 2 + 0];
      const float used_m = t.nonzero[(size_t)n * 2 + 1] + t.grp_nonzero[g * 2 + 1];
      least_balanced(used_c, used_m, t.alloc[(size_t)n * Rr + 0], t.alloc[(size_t)n * Rr + 1],
                     &least_s[n], &bal_s[n]);
      simon_s[n] = floorf(100.0f * t.simon_raw[gN + n]);
      ip_s[n] = interpod_raw_at(t, g, n);
      pern_s[n] = t.counter[(size_t)ssi * t.D1 + t.counter_dom[(size_t)ssi * N + n]];
      if (EXT && t.f_storage) st_s[n] = st_raw;
    }
    if (F) {
      anyF = true;
      const float ss = simon_s[n], ip = ip_s[n], pn = pern_s[n];
      mx[0] = fmaxf(mx[0], ss);
      mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
      mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
      mx[3] = fmaxf(mx[3], ip);
      mx[4] = fmaxf(mx[4], pn);
      mx[5] = fmaxf(mx[5], -ss);
      mx[6] = fmaxf(mx[6], -ip);
      if (EXT && t.f_storage) {
        mx[7] = fmaxf(mx[7], st_raw);
        mx[8] = fmaxf(mx[8], -st_raw);
      }
      const int zone = t.node_zone[n];
      if (zone > 0) zoned = true;
      if (zone >= 0 && zone < t.Z) atomicAdd(&acc[PART_HEAD + zone], (int)pn);  // counts: exact
      // ScheduleAnyway: a node missing any valid term's key is ignored
      bool ignored = false;
      for (int s = 0; s < t.Ss; ++s) {
        const int id = t.sa_t[g * t.Ss + s];
        if (id >= 0 && t.counter_dom[(size_t)id * N + n] >= D) ignored = true;
      }
      flags = FL_F;
      if (!ignored) {
        flags += FL_REL;
        if (sa) {
          for (int s = 0; s < t.Ss; ++s) {
            const int id = t.sa_t[g * t.Ss + s];
            if (id >= 0) marks[(size_t)s * t.D1 + t.counter_dom[(size_t)id * N + n]] = 1.0f;
          }
        }
      }
    }
    flags_s[n] = flags;
  }
  const int slot[9] = {P_SIMON, P_NODEAFF, P_TAINT, P_IP, P_PERNODE, P_NSIMON, P_NIP, P_ST,
                       P_NST};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int r = __reduce_max_sync(FULL_MASK, okey(mx[k]));
    if (lane == 0) atomicMax(&acc[slot[k]], r);
  }
  if (__any_sync(FULL_MASK, anyF) && lane == 0) atomicMax(&acc[P_ANY], 1);
  if (__any_sync(FULL_MASK, zoned) && lane == 0) atomicMax(&acc[P_ZONED], 1);
  __syncthreads();
  cluster_row_round(cx, acc, PART_HEAD, nw, fin);
  if (cx.rank == 0)
    for (int k = tid; k < nw; k += CLUSTER_THREADS)
      part[k] = k < P_ANY ? ounkey(fin[k]) : (k < PART_HEAD ? (fin[k] ? 1.0f : 0.0f)
                                                            : (float)fin[k]);
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// ---- A2: ScheduleAnyway's topology sizes from every rank's marks (rows
// [R, K1]), the raw scores of the block's relevant nodes, and their block
// max and negated min into part_b[2]
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
batch_sharded_sa_kernel(TablesView t, int g, int R, const float* rows, int K1, float* scratch,
                        float* part_b) {
  __shared__ StageShared sh;
  SLOT_ARRAY(float, s_tpw);
  extern __shared__ __align__(16) uint32_t smem[];
  SLOT_BIND(s_tpw, t, WR_TPW);
  const int N = t.N, D = t.D1 - 1, tid = threadIdx.x, lane = tid & 31;
  const int W = k12_words(t), mk = PART_HEAD + t.Z;
  Cluster cx = cluster_stage(N, W, (int*)smem, sh.mbar);
  int* fin = (int*)smem + 2 * cx.C * W;
  int* acc = fin + W;  // the CTA's count of marked domains of each term
  for (int s = tid; s < t.Ss; s += CLUSTER_THREADS) acc[s] = 0;
  __syncthreads();
  // this CTA's share of the domains (the sentinel excluded)
  const int dchunk = (D + cx.C - 1) / cx.C, d0 = min(D, cx.rank * dchunk), d1 = min(D, d0 + dchunk);
  for (int s = 0; s < t.Ss; ++s) {
    if (t.sa_t[g * t.Ss + s] < 0) continue;
    int cnt = 0;
    for (int d = d0 + tid; d < d1; d += CLUSTER_THREADS) {
      float m = 0.0f;
      for (int r = 0; r < R; ++r) m = fmaxf(m, rows[(size_t)r * K1 + mk + (size_t)s * t.D1 + d]);
      if (m != 0.0f) ++cnt;
    }
    cnt = __reduce_add_sync(FULL_MASK, cnt);
    if (lane == 0 && cnt) atomicAdd(&acc[s], cnt);
  }
  __syncthreads();
  cluster_row_round(cx, acc, 0, t.Ss, fin);
  for (int s = tid; s < t.Ss; s += CLUSTER_THREADS)
    if (t.sa_t[g * t.Ss + s] >= 0) s_tpw[s] = topology_weight((float)fin[s]);
  __syncthreads();
  const float* flags_s = scratch + (size_t)SB_FLAGS * N;
  float* sa_s = scratch + (size_t)SB_SA * N;
  float v[2] = {-INFINITY, -INFINITY};
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    if (flags_s[n] >= FL_F + FL_REL) {
      float acc_s = 0.0f;
      for (int s = 0; s < t.Ss; ++s) {
        const int id = t.sa_t[g * t.Ss + s];
        if (id < 0) continue;
        const float cnt = t.counter[(size_t)id * t.D1 + t.counter_dom[(size_t)id * N + n]];
        acc_s = acc_s + (cnt * s_tpw[s] + (t.sa_maxskew[g * t.Ss + s] - 1.0f));
      }
      const float raw = floorf(acc_s);
      sa_s[n] = raw;
      v[0] = fmaxf(v[0], raw);
      v[1] = fmaxf(v[1], -raw);
    }
  }
  int r2[2] = {okey(v[0]), okey(v[1])};
  const int op2[2] = {RX_MAX, RX_MAX};
  cluster_reduce<2>(cx, r2, op2, sh.rx, sh.fin);
  if (cx.rank == 0 && tid < 2) part_b[tid] = ounkey(r2[tid]);
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// ---- B: the normalizers from every rank's partials (rows [R, K1]) and
// ScheduleAnyway's reduced extrema (sa_red, null without such terms), then
// on the block either the first max (row2: score, global node, counter_dom
// and carr_dom columns, f64) or, with `out`, K7's packed [26, NL] rows
template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
batch_sharded_score_kernel(TablesView t, int g, int lo, int R, const float* rows, int K1,
                           const float* sa_red, float* scratch, double* row2, float* out,
                           long long perm) {
  __shared__ StageShared sh;
  __shared__ float s_red[32];
  __shared__ float s_head[PART_HEAD];
  extern __shared__ __align__(16) uint32_t smem[];
  const int N = t.N, D = t.D1 - 1, tid = threadIdx.x;
  const int W = k12_words(t);
  const size_t gN = (size_t)g * N;
  Cluster cx = cluster_stage(N, W, (int*)smem, sh.mbar);
  float* zone_sums = reinterpret_cast<float*>(smem) + 2 * cx.C * W + W;  // [Z], reduced
  if (tid < PART_HEAD) {
    float m = rows[tid];
    for (int r = 1; r < R; ++r) m = fmaxf(m, rows[(size_t)r * K1 + tid]);
    s_head[tid] = m;
  }
  for (int z = tid; z < t.Z; z += CLUSTER_THREADS) {
    float s = rows[PART_HEAD + z];
    for (int r = 1; r < R; ++r) s = s + rows[(size_t)r * K1 + PART_HEAD + z];  // rank order
    zone_sums[z] = s;
  }
  __syncthreads();
  float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
  for (int z = 1 + tid; z < t.Z; z += CLUSTER_THREADS) maxZ = fmaxf(maxZ, zone_sums[z]);
  {
    float v[1] = {maxZ};
    const int op[1] = {OP_MAX};
    block_reduce<1>(v, op, s_red);
    maxZ = v[0];
  }
  const Norms nm = {s_head[P_SIMON], -s_head[P_NSIMON], fmaxf(s_head[P_NODEAFF], 0.0f),
                    fmaxf(s_head[P_TAINT], 0.0f), fmaxf(s_head[P_IP], 0.0f),
                    fminf(-s_head[P_NIP], 0.0f)};
  const float maxN = fmaxf(s_head[P_PERNODE], 0.0f);
  const bool have_zones = s_head[P_ZONED] > 0.0f;
  float st_lo = 0.0f, st_rng = 0.0f;
  if (EXT && t.f_storage) {
    const float lo_raw = -s_head[P_NST];
    st_lo = isfinite(lo_raw) ? lo_raw : 0.0f;
    st_rng = fmaxf(s_head[P_ST], 0.0f) - st_lo;
  }
  float sa_hi = 0.0f, sa_lo = 0.0f;  // without ScheduleAnyway terms: 100 on every relevant node
  if (sa_red != nullptr) {
    sa_hi = fmaxf(sa_red[0], 0.0f);
    const float lo_raw = -sa_red[1];
    sa_lo = isfinite(lo_raw) ? lo_raw : 0.0f;
  }
  bool has_storage = false;
  if (EXT && t.f_storage) {
    for (int s = 0; s < t.SL; ++s)
      has_storage = has_storage || t.grp_lvm_size[(size_t)g * t.SL + s] > 0.0f;
    for (int s = 0; s < t.SD; ++s)
      has_storage = has_storage || t.grp_sdev_size[(size_t)g * t.SD + s] > 0.0f;
  }
  const bool has_ss = t.ss_t[g] >= 0, ss_skip = t.ss_skip[g];
  const float* least_s = scratch + (size_t)SB_LEAST * N;
  const float* bal_s = scratch + (size_t)SB_BALANCED * N;
  const float* simon_s = scratch + (size_t)SB_SIMON * N;
  const float* ip_s = scratch + (size_t)SB_IP * N;
  const float* pern_s = scratch + (size_t)SB_PERNODE * N;
  const float* sa_s = scratch + (size_t)SB_SA * N;
  const float* flags_s = scratch + (size_t)SB_FLAGS * N;
  const float* st_s = scratch + (size_t)SB_STORAGE * N;
  const float* bits_s = scratch + (size_t)SB_BITS * N;
  float best = -INFINITY;
  int best_i = INT_HI;
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    const float fl = flags_s[n];
    if (out == nullptr && fl == 0.0f) continue;  // infeasible: masked to -inf
    float simon, nodeaff, taint, interpod;
    normalized_terms(nm, simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_s[n],
                     &simon, &nodeaff, &taint, &interpod);
    const int zone = t.node_zone[n];
    const float zs = (zone >= 0 && zone < t.Z) ? zone_sums[zone] : 0.0f;
    const float blended = selector_spread_blend(pern_s[n], maxN, zs, maxZ,
                                                have_zones && zone > 0);
    const float selector_spread = ss_skip ? 0.0f : (has_ss ? floorf(blended) : 100.0f);
    const float pts = fl >= FL_F + FL_REL ? sa_normalized(sa_s[n], sa_hi, sa_lo) : 0.0f;
    const float openlocal = (EXT && has_storage && st_rng > 0.0f)
                                ? floorf((st_s[n] - st_lo) * 100.0f / st_rng) : 0.0f;
    const float comp[12] = {t.w[W_LEAST] * least_s[n],
                            t.w[W_BALANCED] * bal_s[n],
                            t.w[W_OPENLOCAL] * openlocal,
                            t.w[W_SIMON] * simon,
                            t.w[W_NODEAFF] * nodeaff,
                            t.w[W_TAINT] * taint,
                            t.w[W_INTERPOD] * interpod,
                            t.w[W_SS] * selector_spread,
                            t.w[W_PTS] * pts,
                            t.w[W_AVOID] * t.avoid_raw[gN + n],
                            t.w[W_IMAGE] * t.image_raw[gN + n],
                            t.extra_raw[gN + n]};
    float total = comp[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) total = total + comp[k];
    if (out != nullptr) {
      const uint32_t bits = (uint32_t)bits_s[n];
      out[(size_t)R_FEASIBLE * N + n] = (float)((bits >> BIT_FEASIBLE) & 1u);
      out[(size_t)R_TOTAL * N + n] = total;
#pragma unroll
      for (int i = 0; i < N_STAGES; ++i)
        out[(size_t)(R_STAGE0 + i) * N + n] = (float)((bits >> ((perm >> (4 * i)) & 15)) & 1u);
#pragma unroll
      for (int k = 0; k < 12; ++k) out[(size_t)(R_COMP0 + k) * N + n] = comp[k];
    } else {
      argmax_update(total, n, &best, &best_i);
    }
  }
  if (out != nullptr) return;  // explain mode makes no round
  // the block's first max (K2's cluster_argmax); the thread that holds it
  // writes its row
  const int c = cluster_argmax(cx, best, best_i, sh.rx, sh.fin);
  if (c < N) {
    if (best_i == c) {
      row2[0] = (double)best;
      row2[1] = (double)(lo + c);
    }
    if (c >= cx.lo && c < cx.hi) {
      for (int r = tid; r < t.T; r += CLUSTER_THREADS)
        row2[2 + r] = (double)t.counter_dom[(size_t)r * N + c];
      for (int r = tid; r < t.Tc; r += CLUSTER_THREADS)
        row2[2 + t.T + r] = (double)t.carr_dom[(size_t)r * N + c];
    }
  } else if (cx.rank == 0) {  // no feasible node in the block
    if (tid == 0) {
      row2[0] = -INFINITY;
      row2[1] = (double)(lo + N);
    }
    for (int r = tid; r < t.T + t.Tc; r += CLUSTER_THREADS) row2[2 + r] = (double)D;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// ---- the last pod's commit
template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
batch_sharded_commit_kernel(TablesView t, int g, int p, int lo, int R, const double* rows,
                            int* choices) {
  int sa, sb;
  cta_slice(t.N, &sa, &sb);
  commit_winner<EXT>(t, g, p, lo, R, rows, choices, sa, sb, cluster_rank() == 0);
}

// cluster.cuh cluster_kernel_init with K12's shared-memory bound
template <typename... Params>
static cudaError_t k12_init(void (*kernel)(Params...)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K12_SMEM_MAX);
  return e;
}

// ------------------------------------------------------------ C interface --

static bool k12_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

#define K12_SHAPE_OK                                                                     \
  if (!k12_size_ok(C) || smem != k12_smem_bytes(*t, C) || smem > K12_SMEM_MAX) \
  return (int)cudaErrorInvalidValue

// One cluster of C CTAs with `smem` bytes (batch_sharded_smem; commit: none)
#define EXT_LAUNCH(kernel, t, smem_at, ...)                                               \
  ((t)->f_gpu || (t)->f_storage                                                           \
       ? cluster_launch(kernel<true>, C, 1, smem_at, stream, *(t), __VA_ARGS__)           \
       : cluster_launch(kernel<false>, C, 1, smem_at, stream, *(t), __VA_ARGS__))

extern "C" {

// scratch floats: the per-node rows of the block
long long batch_sharded_scratch_floats(const TablesView* t) { return (long long)SB_NODE_ROWS * t->N; }

// floats of the partial vector (all_gather_rows #1) of a group with (sa)
// or without ScheduleAnyway terms
int batch_sharded_part_floats(const TablesView* t, int sa) { return part_floats(*t, sa != 0); }

// K12's dynamic shared memory at C and its bound (ops/cluster.py takes
// them from here)
long long batch_sharded_smem(const TablesView* t, int C) { return k12_smem_bytes(*t, C); }
long long batch_sharded_smem_max() { return K12_SMEM_MAX; }

// Allow each K12 kernel clusters of 16 and K12_SMEM_MAX bytes of dynamic
// shared memory, once per device
int batch_sharded_init() {
  cudaError_t e = k12_init(batch_sharded_front_kernel<false>);
  if (e == cudaSuccess) e = k12_init(batch_sharded_front_kernel<true>);
  if (e == cudaSuccess) e = k12_init(batch_sharded_sa_kernel);
  if (e == cudaSuccess) e = k12_init(batch_sharded_score_kernel<false>);
  if (e == cudaSuccess) e = k12_init(batch_sharded_score_kernel<true>);
  if (e == cudaSuccess) e = k12_init(batch_sharded_commit_kernel<false>);
  if (e == cudaSuccess) e = k12_init(batch_sharded_commit_kernel<true>);
  return (int)e;
}

// Clusters of C CTAs with `smem` bytes of K12's largest stage (the EXT
// front) that can be resident at once, into *out
int batch_sharded_occupancy(int C, long long smem, int* out) {
  if (!k12_size_ok(C)) return (int)cudaErrorInvalidValue;
  return cluster_occupancy_of(batch_sharded_front_kernel<true>, C, smem, out);
}

// t: the block's view (N = NL). Every stage: one cluster of C CTAs over
// the block, `smem` = batch_sharded_smem(t, C); any other shape is refused.
int batch_sharded_front_launch(const TablesView* t, int g, int forced, int valid, int all_nodes,
                               int lo, int R, const double* prev_rows, int prev_g, int prev_p,
                               int* choices, float* scratch, float* part, int C, long long smem,
                               cudaStream_t stream) {
  K12_SHAPE_OK;
  return EXT_LAUNCH(batch_sharded_front_kernel, t, smem, g, forced, valid, all_nodes, lo, R,
                    prev_rows, prev_g, prev_p, choices, scratch, part);
}

int batch_sharded_sa_launch(const TablesView* t, int g, int R, const float* rows, int K1,
                            float* scratch, float* part_b, int C, long long smem,
                            cudaStream_t stream) {
  K12_SHAPE_OK;
  return cluster_launch(batch_sharded_sa_kernel, C, 1, smem, stream, *t, g, R, rows, K1, scratch,
                        part_b);
}

int batch_sharded_score_launch(const TablesView* t, int g, int lo, int R, const float* rows,
                               int K1, const float* sa_red, float* scratch, double* row2,
                               float* out, long long perm, int C, long long smem,
                               cudaStream_t stream) {
  K12_SHAPE_OK;
  return EXT_LAUNCH(batch_sharded_score_kernel, t, smem, g, lo, R, rows, K1, sa_red, scratch,
                    row2, out, perm);
}

int batch_sharded_commit_launch(const TablesView* t, int g, int p, int lo, int R,
                                const double* rows, int* choices, int C, long long smem,
                                cudaStream_t stream) {
  K12_SHAPE_OK;
  return EXT_LAUNCH(batch_sharded_commit_kernel, t, 0, g, p, lo, R, rows, choices);
}

}  // extern "C"
