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
// The per-node raw terms live in the output's own component rows between
// the phases (each thread keeps the nodes n = tid + k * blockDim.x through
// every phase, so it reads back only what it wrote); the feasible/relevant
// flags ride in the total row until phase E overwrites it.
//
// The exactness contract with the plain PyTorch version is common.cuh's:
// --fmad=false, slot sums left to right, log in f64 rounded once, the total
// added in COMPONENT_ORDER, atomics only on integer-valued counts (the zone
// sums and the domain marks).
//
// What bounds it on an H100: bytes (about K1's reads plus the group's six
// score rows and the 26 output rows), at a few hundred kilobytes per launch
// far below a launch's latency; the recorder launches it once per decision
// set, tens of times per run. Design: right first, not fast: ONE block of
// BLOCK_THREADS, K2's phase structure (A pod scalars, B filters and raw
// terms, C ScheduleAnyway topology sizes, D ScheduleAnyway raw scores, E
// normalized components and the total), so it reuses K2's device functions
// unchanged. A grid over the nodes with a second pass for the normalizers is
// later work. Built twice, like K2: EXT adds the GPU-share and Open-Local
// branches, picked by the view's flags.

#include "common.cuh"

// output rows
enum { R_FEASIBLE = 0, R_TOTAL, R_STAGE0, R_COMP0 = R_STAGE0 + N_STAGES };
// component rows, COMPONENT_ORDER
enum { C_LEAST = R_COMP0, C_BALANCED, C_OPENLOCAL, C_SIMON, C_NODEAFF, C_TAINT, C_INTERPOD, C_SS,
       C_PTS, C_AVOID, C_IMAGE, C_EXTRA };
#define FL_F 1.0f
#define FL_REL 2.0f
// row r of the [26, N] output
#define ROW(r) (out + (size_t)(r) * N)

template <bool EXT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
explain_kernel(TablesView t, int g, int forced, int valid, long long perm, float* out,
               float* scratch) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  const int N = t.N, R = t.R, D = t.D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  const size_t gN = (size_t)g * N;
  float* zone_sums = scratch;      // [Z]
  float* marks = zone_sums + t.Z;  // [Ss, D1]
  for (size_t i = tid; i < (size_t)t.Z + (size_t)t.Ss * t.D1; i += bd) scratch[i] = 0.0f;

  // ---- A: per-pod scalars (pod_prologue ends with a barrier, which also
  // orders the clearing above before the sums below)
  pod_prologue(t, g, 1, &pc, s_red);
  const int ss_id = t.ss_t[g];
  const int ssi = ss_id > 0 ? ss_id : 0;
  bool any_sa = false;
  for (int s = 0; s < t.Ss; ++s) any_sa = any_sa || t.sa_t[g * t.Ss + s] >= 0;
  bool has_storage = false;
  if (EXT && t.f_storage) {
    for (int s = 0; s < t.SL; ++s)
      has_storage = has_storage || t.grp_lvm_size[(size_t)g * t.SL + s] > 0.0f;
    for (int s = 0; s < t.SD; ++s)
      has_storage = has_storage || t.grp_sdev_size[(size_t)g * t.SD + s] > 0.0f;
  }

  // ---- B: per node, every filter and every raw term; extrema and zone
  // sums over F, ScheduleAnyway domain marks over the relevant part of F
  float mx[5] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float mn_simon = INFINITY, mn_ip = INFINITY, st_hi = -INFINITY, st_lo = INFINITY;
  bool have_zones = false;
  for (int n = tid; n < N; n += bd) {
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
      mx[0] = fmaxf(mx[0], ss);
      mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
      mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
      mx[3] = fmaxf(mx[3], ip);
      mx[4] = fmaxf(mx[4], pn);
      mn_simon = fminf(mn_simon, ss);
      mn_ip = fminf(mn_ip, ip);
      if (EXT && t.f_storage) {
        st_hi = fmaxf(st_hi, st_raw);
        st_lo = fminf(st_lo, st_raw);
      }
      const int zone = t.node_zone[n];
      if (zone > 0) have_zones = true;
      if (zone >= 0 && zone < t.Z) atomicAdd(&zone_sums[zone], pn);  // integer counts: exact
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
  const int have_zones_b = __syncthreads_or(have_zones);
  float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
  for (int z = 1 + tid; z < t.Z; z += bd) maxZ = fmaxf(maxZ, zone_sums[z]);
  {
    float v[8] = {mx[0], mx[1], mx[2], mx[3], mx[4], mn_simon, mn_ip, maxZ};
    const int op[8] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MIN, OP_MAX};
    block_reduce<8>(v, op, s_red);
    for (int k = 0; k < 5; ++k) mx[k] = v[k];
    mn_simon = v[5];
    mn_ip = v[6];
    maxZ = v[7];
  }
  // over an empty F the maxima stay -inf and the minima +inf: the clamps
  // and the finiteness tests below give the plain version's values
  const Norms nm = {mx[0], mn_simon, fmaxf(mx[1], 0.0f), fmaxf(mx[2], 0.0f),
                    fmaxf(mx[3], 0.0f), fminf(mn_ip, 0.0f)};
  const float maxN = fmaxf(mx[4], 0.0f);
  float st_rng = 0.0f;
  if (EXT && t.f_storage) {
    float v[2] = {st_hi, st_lo};
    const int op[2] = {OP_MAX, OP_MIN};
    block_reduce<2>(v, op, s_red);
    st_lo = isfinite(v[1]) ? v[1] : 0.0f;
    st_rng = fmaxf(v[0], 0.0f) - st_lo;
  }

  // ---- C: topology sizes of the ScheduleAnyway terms (count of marked
  // domains, sentinel column excluded)
  if (any_sa) {
    for (int s = 0; s < t.Ss; ++s) {
      if (t.sa_t[g * t.Ss + s] < 0) continue;
      float cnt = 0.0f;
      const float* row = marks + (size_t)s * t.D1;
      for (int d = tid; d < D; d += bd)
        if (row[d] != 0.0f) cnt += 1.0f;
      float v[1] = {cnt};
      const int op[1] = {OP_SUM};
      block_reduce<1>(v, op, s_red);
      if (tid == 0) pc.tpw[s] = topology_weight(v[0]);
    }
    __syncthreads();
  }

  // ---- D: ScheduleAnyway raw scores of the relevant nodes and their extrema
  float sa_hi = -INFINITY, sa_lo = INFINITY;
  for (int n = tid; n < N; n += bd) {
    if (ROW(R_TOTAL)[n] >= FL_F + FL_REL) {
      float acc = 0.0f;
      for (int s = 0; s < t.Ss; ++s) {
        const int id = t.sa_t[g * t.Ss + s];
        if (id < 0) continue;
        const float cnt = t.counter[(size_t)id * t.D1 + t.counter_dom[(size_t)id * N + n]];
        acc = acc + (cnt * pc.tpw[s] + (t.sa_maxskew[g * t.Ss + s] - 1.0f));
      }
      const float raw = floorf(acc);
      ROW(C_PTS)[n] = raw;  // raw until phase E
      sa_hi = fmaxf(sa_hi, raw);
      sa_lo = fminf(sa_lo, raw);
    }
  }
  {
    float v[2] = {sa_hi, sa_lo};
    const int op[2] = {OP_MAX, OP_MIN};
    block_reduce<2>(v, op, s_red);
    sa_hi = fmaxf(v[0], 0.0f);
    sa_lo = isfinite(v[1]) ? v[1] : 0.0f;
  }

  // ---- E: normalized, weighted components on every node; the total in
  // COMPONENT_ORDER, left to right
  const bool has_ss = ss_id >= 0, ss_skip = t.ss_skip[g];
  for (int n = tid; n < N; n += bd) {
    const float fl = ROW(R_TOTAL)[n];
    float simon, nodeaff, taint, interpod;
    normalized_terms(nm, ROW(C_SIMON)[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n],
                     ROW(C_INTERPOD)[n], &simon, &nodeaff, &taint, &interpod);
    const int zone = t.node_zone[n];
    const float zs = (zone >= 0 && zone < t.Z) ? zone_sums[zone] : 0.0f;
    const float blended = selector_spread_blend(ROW(C_SS)[n], maxN, zs, maxZ,
                                                have_zones_b && zone > 0);
    const float selector_spread = ss_skip ? 0.0f : (has_ss ? floorf(blended) : 100.0f);
    const float pts = fl >= FL_F + FL_REL ? sa_normalized(ROW(C_PTS)[n], sa_hi, sa_lo) : 0.0f;
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
}

// ------------------------------------------------------------ C interface --

extern "C" {

long long explain_scratch_floats(const TablesView* t) {
  return (long long)t->Z + (long long)t->Ss * t->D1;
}

// out: [26, N] f32; scratch: explain_scratch_floats(t) floats
int explain_launch(const TablesView* t, int g, int forced, int valid, long long perm, float* out,
                   float* scratch, cudaStream_t stream) {
  if (t->f_gpu || t->f_storage)
    explain_kernel<true><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, forced, valid, perm, out,
                                                          scratch);
  else
    explain_kernel<false><<<1, BLOCK_THREADS, 0, stream>>>(*t, g, forced, valid, perm, out,
                                                           scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
