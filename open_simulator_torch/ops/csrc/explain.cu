// Hand-written Hopper kernel for the xray flight recorder's diagnostic.
//
// K7 explain_kernel replaces open_simulator_tpu/ops/kernels.py `explain_pod`
//    (:751, jitted as `explain_jit` :768): for one pod group against one
//    carry, `feasibility` (:379) and `score_components` (:560-651) over the
//    feasible set, with the total summed in COMPONENT_ORDER. It writes ONE
//    [26, N] f32 array in the row order of the JAX engine's packed fetch
//    (simulator/engine.py `_xray_set`): the feasible mask, the total, the 12
//    stage masks in xray STAGE_NAMES order (mapped by name from the stage
//    bits by the wrapper's `perm`: 4 bits per row) and the 12 weighted
//    components in COMPONENT_ORDER. Masks are 1.0 / 0.0.
//
// Where it differs from K2's per-pod step (schedule.cu schedule_batch_body):
// - nothing is committed and no argmax is taken;
// - every component is computed on EVERY node, as score_components does;
//   only the normalizers (the maxima and minima of the Simon, NodeAffinity,
//   TaintToleration, InterPodAffinity, SelectorSpread and Open-Local terms)
//   and the SelectorSpread zone sums are taken over the feasible set F, and
//   the ScheduleAnyway domains, raw scores and normalizer over the relevant
//   part of F. An infeasible node gets its components and their sum (not
//   -inf); ScheduleAnyway is 0 off the relevant set;
// - an empty F is computed through, as the plain version does: the maxima
//   stay -inf and the minima +inf, so Simon's range is not finite (0),
//   NodeAffinity's and InterPodAffinity's normalizers clamp to 0 (0),
//   TaintToleration's to 0 (100), SelectorSpread sees maxN = 0 and no zone
//   sums, and Open-Local's lower end is not finite (0).
//
// Design: ONE launch of one thread-block cluster of C CTAs of
// CLUSTER_THREADS threads over the N nodes (C from ops/cluster.py `choose`,
// cached per shape), CTA r owning the node slice [r * chunk, (r + 1) *
// chunk); K2's device functions unchanged, in K2's phases:
// - A: `pod_prologue` on every CTA (the pod scalars replicated); each CTA
//   clears its share of the ScheduleAnyway marks [Ss, D+1] (global scratch)
//   and its row of round B, then a cluster barrier;
// - B: every node's filters and raw terms; ONE cluster round (merge.cuh
//   cluster_row_round) carries the CTA's maxima over its feasible nodes as
//   order-preserving integers (okey; the minima as negated maxima, so an
//   empty CTA's -inf merges as nothing), any zoned feasible node (a maximum
//   of 0 / 1) and the SelectorSpread zone sums (integer counts, summed in
//   rank order); every CTA stores 1.0 into the marks of its relevant nodes,
//   ordered before phase C by a cluster barrier (groups with ScheduleAnyway
//   terms only);
// - C: each CTA counts the marked domains of its share of the D domains
//   (the sentinel excluded), one round sums them into the topology weights;
// - D: the relevant nodes' ScheduleAnyway raw scores, one round takes their
//   maximum and negated minimum (cluster_reduce);
// - E: the normalized, weighted components and the total on each slice.
// Groups without ScheduleAnyway terms skip C and D (their relevant nodes
// score 100: sa_normalized with a zero maximum). The per-node raw terms
// live in the output's own component rows between the phases (each thread
// keeps the nodes n = lo + tid + k * CLUSTER_THREADS through every phase, so
// it reads back only what it wrote); the feasible/relevant flags ride in the
// total row until phase E overwrites it. A final cluster barrier: no CTA
// leaves with its stores into another in flight.
//
// The exactness contract with the plain PyTorch version is common.cuh's:
// --fmad=false, slot sums left to right, log in f64 rounded once, the total
// added in COMPONENT_ORDER, maxima and minima exact in any grouping, atomics
// only on integer-valued counts (the zone sums and the marked domains). It
// computes what K12's explain mode (batch_sharded.cu) computes on a rank's
// block, bit for bit.
//
// What bounds it on an H100: bytes (about K1's reads plus the group's six
// score rows and the 26 output rows), a few hundred kilobytes per launch,
// far below a launch's latency spread over C SMs; the recorder launches it
// once per decision set, tens to hundreds of times per run. Built twice,
// like K2: EXT adds the GPU-share and Open-Local branches, picked by the
// view's flags.

#include "common.cuh"
#include "merge.cuh"

// output rows
enum { R_FEASIBLE = 0, R_TOTAL, R_STAGE0, R_COMP0 = R_STAGE0 + N_STAGES };
// component rows, COMPONENT_ORDER
enum { C_LEAST = R_COMP0, C_BALANCED, C_OPENLOCAL, C_SIMON, C_NODEAFF, C_TAINT, C_INTERPOD, C_SS,
       C_PTS, C_AVOID, C_IMAGE, C_EXTRA };
#define FL_F 1.0f
#define FL_REL 2.0f
// row r of the [26, N] output
#define ROW(r) (out + (size_t)(r) * N)
// round B's row: the maxima (okey) of simon, nodeaff, taint, interpod,
// pernode, -simon, -interpod, storage and -storage over the feasible nodes,
// any zoned feasible node (0 / 1), then the Z zone sums
enum { H_SIMON = 0, H_NODEAFF, H_TAINT, H_IP, H_PERNODE, H_NSIMON, H_NIP, H_ST, H_NST, H_ZONED,
       K7_HEAD };

// The dynamic shared memory K7 may ask for: its CTAs also hold PodCtx,
// StageShared and the block reductions' words in static shared memory
// (ops/cluster.py takes it from explain_smem_max)
#define K7_SMEM_MAX (CLUSTER_SMEM_MAX - 16384)

// A round slot's words: round B's row or round C's Ss counts
static __host__ __device__ inline int k7_words(const TablesView& t) {
  const int w = K7_HEAD + t.Z;
  return w > t.Ss ? w : t.Ss;
}

// K7's dynamic shared memory at C: the round slots [2][C][W], fin [W], the
// CTA's row [W] and the zone sums [Z] (f32)
static __host__ __device__ inline long long k7_smem_bytes(const TablesView& t, int C) {
  const long long W = k7_words(t);
  return 4LL * (2 * C * W + 2 * W + t.Z);
}

template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
explain_kernel(TablesView t, int g, int forced, int valid, long long perm, float* out,
               float* marks) {
  __shared__ PodCtx pc;
  __shared__ StageShared sh;
  __shared__ float s_red[32];
  extern __shared__ __align__(16) uint32_t smem[];
  POD_BIND(pc, t);
  const int N = t.N, R = t.R, D = t.D1 - 1, tid = threadIdx.x, lane = tid & 31;
  const int W = k7_words(t), nw = K7_HEAD + t.Z;
  Cluster cx = cluster_setup(N, W, (int*)smem, sh.mbar);
  int* fin = (int*)smem + 2 * cx.C * W;
  int* acc = fin + W;                                     // the CTA's row
  float* zone_sums = reinterpret_cast<float*>(acc + W);  // [Z], the cluster's
  const size_t gN = (size_t)g * N;
  bool any_sa = false;
  for (int s = 0; s < t.Ss; ++s) any_sa = any_sa || t.sa_t[g * t.Ss + s] >= 0;

  // ---- A: this CTA's share of the marks and its row cleared; every CTA
  // started (its mbarriers visible) and every share cleared before any mark
  // below (release / acquire at cluster scope); the per-pod scalars
  if (any_sa) {
    const int stride = cx.C * CLUSTER_THREADS;
    for (size_t i = (size_t)cx.rank * CLUSTER_THREADS + tid; i < (size_t)t.Ss * t.D1;
         i += stride)
      marks[i] = 0.0f;
  }
  for (int k = tid; k < nw; k += CLUSTER_THREADS) acc[k] = k < H_ZONED ? okey(-INFINITY) : 0;
  cluster_barrier_uncounted();
  pod_prologue(t, g, 1, &pc, s_red);
  const int ss_id = t.ss_t[g];
  const int ssi = ss_id > 0 ? ss_id : 0;
  bool has_storage = false;
  if (EXT && t.f_storage) {
    for (int s = 0; s < t.SL; ++s)
      has_storage = has_storage || t.grp_lvm_size[(size_t)g * t.SL + s] > 0.0f;
    for (int s = 0; s < t.SD; ++s)
      has_storage = has_storage || t.grp_sdev_size[(size_t)g * t.SD + s] > 0.0f;
  }

  // ---- B: per node of the slice, every filter and every raw term; the
  // slice's extrema and zone sums over F, ScheduleAnyway domain marks over
  // the relevant part of F
  float mx[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) mx[k] = -INFINITY;
  bool zoned = false;
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    float st_raw = 0.0f;
    const uint32_t bits = node_feasibility<EXT, false>(t, &pc, g, forced, valid, 1, 1, n, nullptr,
                                                       &st_raw);
    const bool F = (bits >> BIT_FEASIBLE) & 1u;
    ROW(R_FEASIBLE)[n] = F ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < N_STAGES; ++i)
      ROW(R_STAGE0 + i)[n] = (float)((bits >> ((perm >> (4 * i)) & 15)) & 1u);
    float least, bal;
    const float used_c = t.nonzero[(size_t)n * 2 + 0] + t.grp_nonzero[g * 2 + 0];
    const float used_m = t.nonzero[(size_t)n * 2 + 1] + t.grp_nonzero[g * 2 + 1];
    least_balanced(used_c, used_m, t.alloc[(size_t)n * R + 0], t.alloc[(size_t)n * R + 1], &least,
                   &bal);
    ROW(C_LEAST)[n] = t.w[W_LEAST] * least;
    ROW(C_BALANCED)[n] = t.w[W_BALANCED] * bal;
    const float ss = floorf(100.0f * t.simon_raw[gN + n]);
    ROW(C_SIMON)[n] = ss;  // raw until phase E
    const float ip = interpod_raw_at(t, g, n);
    ROW(C_INTERPOD)[n] = ip;
    const float pn = t.counter[(size_t)ssi * t.D1 + t.counter_dom[(size_t)ssi * N + n]];
    ROW(C_SS)[n] = pn;
    if (EXT && t.f_storage) ROW(C_OPENLOCAL)[n] = st_raw;
    // ScheduleAnyway: a node missing any valid term's key is ignored
    bool ignored = false;
    for (int s = 0; s < t.Ss; ++s) {
      const int id = t.sa_t[g * t.Ss + s];
      if (id >= 0 && t.counter_dom[(size_t)id * N + n] >= D) ignored = true;
    }
    float flags = 0.0f;
    if (F) {
      flags = FL_F;
      mx[H_SIMON] = fmaxf(mx[H_SIMON], ss);
      mx[H_NODEAFF] = fmaxf(mx[H_NODEAFF], t.nodeaff_raw[gN + n]);
      mx[H_TAINT] = fmaxf(mx[H_TAINT], t.taint_raw[gN + n]);
      mx[H_IP] = fmaxf(mx[H_IP], ip);
      mx[H_PERNODE] = fmaxf(mx[H_PERNODE], pn);
      mx[H_NSIMON] = fmaxf(mx[H_NSIMON], -ss);
      mx[H_NIP] = fmaxf(mx[H_NIP], -ip);
      if (EXT && t.f_storage) {
        mx[H_ST] = fmaxf(mx[H_ST], st_raw);
        mx[H_NST] = fmaxf(mx[H_NST], -st_raw);
      }
      const int zone = t.node_zone[n];
      if (zone > 0) zoned = true;
      if (zone >= 0 && zone < t.Z) atomicAdd(&acc[K7_HEAD + zone], (int)pn);  // counts: exact
      if (!ignored) {
        flags += FL_REL;
        for (int s = 0; s < t.Ss; ++s) {
          const int id = t.sa_t[g * t.Ss + s];
          if (id >= 0) marks[(size_t)s * t.D1 + t.counter_dom[(size_t)id * N + n]] = 1.0f;
        }
      }
    }
    ROW(R_TOTAL)[n] = flags;  // until phase E
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int r = __reduce_max_sync(FULL_MASK, okey(mx[k]));
    if (lane == 0) atomicMax(&acc[k], r);
  }
  if (__any_sync(FULL_MASK, zoned) && lane == 0) atomicMax(&acc[H_ZONED], 1);
  __syncthreads();
  cluster_row_round(cx, acc, K7_HEAD, nw, fin);
  // every CTA's marks stored before any count below
  if (any_sa) cluster_barrier_uncounted();
  float head[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) head[k] = ounkey(fin[k]);
  const bool have_zones = fin[H_ZONED] != 0;
  float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
  for (int z = tid; z < t.Z; z += CLUSTER_THREADS) {
    const float s = (float)fin[K7_HEAD + z];
    zone_sums[z] = s;
    if (z > 0) maxZ = fmaxf(maxZ, s);
  }
  {
    float v[1] = {maxZ};
    const int op[1] = {OP_MAX};
    block_reduce<1>(v, op, s_red);  // also: every read of fin above before round C
    maxZ = v[0];
  }
  // over an empty F the maxima stay -inf and the minima +inf: the clamps
  // and the finiteness tests below give the plain version's values
  const Norms nm = {head[H_SIMON], -head[H_NSIMON], fmaxf(head[H_NODEAFF], 0.0f),
                    fmaxf(head[H_TAINT], 0.0f), fmaxf(head[H_IP], 0.0f),
                    fminf(-head[H_NIP], 0.0f)};
  const float maxN = fmaxf(head[H_PERNODE], 0.0f);
  float st_lo = 0.0f, st_rng = 0.0f;
  if (EXT && t.f_storage) {
    const float lo_raw = -head[H_NST];
    st_lo = isfinite(lo_raw) ? lo_raw : 0.0f;
    st_rng = fmaxf(head[H_ST], 0.0f) - st_lo;
  }

  // ---- C: topology sizes of the ScheduleAnyway terms (count of marked
  // domains, sentinel column excluded): this CTA's share of the domains,
  // summed over the cluster in one round
  float sa_hi = 0.0f, sa_lo = 0.0f;  // without ScheduleAnyway terms: 100 on every relevant node
  if (any_sa) {
    for (int s = tid; s < t.Ss; s += CLUSTER_THREADS) acc[s] = 0;
    __syncthreads();
    const int dchunk = (D + cx.C - 1) / cx.C, d0 = min(D, cx.rank * dchunk),
              d1 = min(D, d0 + dchunk);
    for (int s = 0; s < t.Ss; ++s) {
      if (t.sa_t[g * t.Ss + s] < 0) continue;
      const float* row = marks + (size_t)s * t.D1;
      int cnt = 0;
      for (int d = d0 + tid; d < d1; d += CLUSTER_THREADS)
        if (__ldcg(&row[d]) != 0.0f) ++cnt;
      cnt = __reduce_add_sync(FULL_MASK, cnt);
      if (lane == 0 && cnt) atomicAdd(&acc[s], cnt);
    }
    __syncthreads();
    cluster_row_round(cx, acc, 0, t.Ss, fin);
    for (int s = tid; s < t.Ss; s += CLUSTER_THREADS)
      if (t.sa_t[g * t.Ss + s] >= 0) pc.tpw[s] = topology_weight((float)fin[s]);
    __syncthreads();

    // ---- D: ScheduleAnyway raw scores of the slice's relevant nodes; their
    // maximum and negated minimum over the cluster in one round
    float v[2] = {-INFINITY, -INFINITY};
    for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
      if (ROW(R_TOTAL)[n] >= FL_F + FL_REL) {
        float a = 0.0f;
        for (int s = 0; s < t.Ss; ++s) {
          const int id = t.sa_t[g * t.Ss + s];
          if (id < 0) continue;
          const float cnt = t.counter[(size_t)id * t.D1 + t.counter_dom[(size_t)id * N + n]];
          a = a + (cnt * pc.tpw[s] + (t.sa_maxskew[g * t.Ss + s] - 1.0f));
        }
        const float raw = floorf(a);
        ROW(C_PTS)[n] = raw;  // raw until phase E
        v[0] = fmaxf(v[0], raw);
        v[1] = fmaxf(v[1], -raw);
      }
    }
    int r2[2] = {okey(v[0]), okey(v[1])};
    const int op2[2] = {RX_MAX, RX_MAX};
    cluster_reduce<2>(cx, r2, op2, sh.rx, sh.fin);
    sa_hi = fmaxf(ounkey(r2[0]), 0.0f);
    const float lo_raw = -ounkey(r2[1]);
    sa_lo = isfinite(lo_raw) ? lo_raw : 0.0f;
  }

  // ---- E: normalized, weighted components on every node of the slice;
  // the total in COMPONENT_ORDER, left to right
  const bool has_ss = ss_id >= 0, ss_skip = t.ss_skip[g];
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    const float fl = ROW(R_TOTAL)[n];
    float simon, nodeaff, taint, interpod;
    normalized_terms(nm, ROW(C_SIMON)[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n],
                     ROW(C_INTERPOD)[n], &simon, &nodeaff, &taint, &interpod);
    const int zone = t.node_zone[n];
    const float zs = (zone >= 0 && zone < t.Z) ? zone_sums[zone] : 0.0f;
    const float blended = selector_spread_blend(ROW(C_SS)[n], maxN, zs, maxZ,
                                                have_zones && zone > 0);
    const float selector_spread = ss_skip ? 0.0f : (has_ss ? floorf(blended) : 100.0f);
    const float pts = fl >= FL_F + FL_REL
                          ? sa_normalized(any_sa ? ROW(C_PTS)[n] : 0.0f, sa_hi, sa_lo)
                          : 0.0f;
    const float openlocal = (EXT && has_storage && st_rng > 0.0f)
                                ? floorf((ROW(C_OPENLOCAL)[n] - st_lo) * 100.0f / st_rng)
                                : 0.0f;
    const float comp[12] = {ROW(C_LEAST)[n],
                            ROW(C_BALANCED)[n],
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
#pragma unroll
    for (int k = 2; k < 12; ++k) ROW(R_COMP0 + k)[n] = comp[k];
    ROW(R_TOTAL)[n] = total;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

// ------------------------------------------------------------ C interface --

static bool k7_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

extern "C" {

// scratch floats: the ScheduleAnyway marks [Ss, D1]
long long explain_scratch_floats(const TablesView* t) { return (long long)t->Ss * t->D1; }

// K7's dynamic shared memory at C and its bound (ops/cluster.py takes them
// from here)
long long explain_smem(const TablesView* t, int C) { return k7_smem_bytes(*t, C); }
long long explain_smem_max() { return K7_SMEM_MAX; }

// Allow K7 clusters of 16 and K7_SMEM_MAX bytes of dynamic shared memory,
// once per device
int explain_init() {
  cudaError_t e = cudaSuccess;
  for (int ext = 0; ext < 2 && e == cudaSuccess; ++ext) {
    void (*k)(TablesView, int, int, int, long long, float*, float*) =
        ext ? explain_kernel<true> : explain_kernel<false>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, K7_SMEM_MAX);
  }
  return (int)e;
}

// Clusters of C CTAs with `smem` bytes of K7 (ext: its EXT build) that can
// be resident at once, into *out
int explain_occupancy(int ext, int C, long long smem, int* out) {
  if (!k7_size_ok(C)) return (int)cudaErrorInvalidValue;
  return ext ? cluster_occupancy_of(explain_kernel<true>, C, smem, out)
             : cluster_occupancy_of(explain_kernel<false>, C, smem, out);
}

// out: [26, N] f32; scratch: explain_scratch_floats(t) floats. One cluster
// of C CTAs with `smem` = explain_smem(t, C); any other shape is refused.
int explain_launch(const TablesView* t, int g, int forced, int valid, long long perm, float* out,
                   float* scratch, int C, long long smem, cudaStream_t stream) {
  if (!k7_size_ok(C) || smem != k7_smem_bytes(*t, C) || smem > K7_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (t->f_gpu || t->f_storage)
    return cluster_launch(explain_kernel<true>, C, 1, smem, stream, *t, g, forced, valid, perm,
                          out, scratch);
  return cluster_launch(explain_kernel<false>, C, 1, smem, stream, *t, g, forced, valid, perm,
                        out, scratch);
}

}  // extern "C"
