// Hand-written Hopper kernels for the serial scheduling route.
//
// K1 feasibility_kernel replaces open_simulator_tpu/ops/kernels.py
//    `feasibility_jit` (:743, wrapping `feasibility` :379): one pod group's [N]
//    feasible mask, the per-stage masks and fit_each [N, R].
// K2 schedule_batch_kernel replaces `schedule_batch` (:2265, the lax.scan of
//    `_step` :728): per pod, feasibility, every score plugin, the first-max
//    argmax and the commit into the carry.
//
// Both take the GPU-share and Open-Local branches (`enable_gpu`,
// `enable_storage`, runtime flags of the view) with `storage_alloc` (:274)
// as a device function (common.cuh): K1 adds the gpu and storage stages;
// K2 adds both masks, the Open-Local min-max score over the feasible set,
// and, at the chosen node, the GPU device-ledger and storage commits.
// JAX evaluates storage_alloc three times per step on the same inputs (XLA
// folds them into one); K2 evaluates it once per node in phase B and once
// more at the chosen node in phase F, from the carry before the commit,
// rather than keep an [N, MAXVG] buffer. K2 is built twice (EXT false and
// true); the launcher picks by the flags, so a batch without such demand
// runs the code of the earlier slices.
//
// What bounds them on an H100: K1 reads a few [N] rows and is launch bound at
// the shapes of this route (N = 5,120). K2 is a chain of dependent block-wide
// reductions: each pod needs the previous pod's commit, so the pods cannot
// run in parallel, and each pod's step is ~12 barriers over one block plus
// ~100 bytes read per node. It is latency bound, far above its byte bound.
// Design: ONE persistent block of 1,024 threads loops over the pods inside
// the kernel (no launch per pod, the carry stays in device memory and in L2).
// The single block uses one SM, which is slow but exact; spreading a step over
// many SMs (cooperative groups or a cluster) is later work.
//
// K2 over lanes (schedule_batch_lanes_kernel) replaces `probe_serial_fanout`
// (:2359/:2361, schedule_batch vmapped over S candidate node-active masks):
// one block per lane, each on its own SM, so a round of S candidates costs
// about one single-lane launch; see common.cuh `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh.
// This file also holds the library's C interface helpers.

#include "common.cuh"

#define K1_THREADS 256

// ----------------------------------------------------------------- K1 ------

__global__ void __launch_bounds__(K1_THREADS)
feasibility_kernel(TablesView t, int g, int forced, int valid, int include_dns, uint8_t* feasible,
                   uint8_t* stages, uint8_t* fit_each) {
  __shared__ PodCtx pc;
  __shared__ float s_red[32];
  pod_prologue(t, g, include_dns, &pc, s_red);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= t.N) return;
  const uint32_t bits = node_feasibility<true>(t, &pc, g, forced, valid, include_dns, 1, n,
                                         fit_each + (size_t)n * t.R);
  feasible[n] = (bits >> BIT_FEASIBLE) & 1u;
  for (int s = 0; s < N_STAGES; ++s) stages[(size_t)s * t.N + n] = (bits >> s) & 1u;
}

// ----------------------------------------------------------------- K2 ------

// scratch layout (floats): per-node rows, then zone sums, then domain marks
enum { SC_LEAST = 0, SC_BALANCED, SC_SIMON, SC_IP, SC_PERNODE, SC_SA, SC_FLAGS, SC_STORAGE,
       SC_NODE_ROWS };
#define FL_F 1.0f
#define FL_REL 2.0f

// EXT: the instantiation with the GPU-share and Open-Local branches, which
// schedule_batch_launch picks when the view's f_gpu or f_storage is on.
// LANE: the lane kernel's body (the lane's active row folds into the static
// mask); the single-lane kernel runs LANE = false, the code it ran before
// lanes existed.
template <bool EXT, bool LANE>
static __device__ __forceinline__ void
schedule_batch_body(const TablesView& t, const int* pod_group, const int* forced_node,
                    const uint8_t* valid_pod, int P, int* choices, float* scratch) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  __shared__ int s_idx[32];
  const int N = t.N, R = t.R, D = t.D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  float* least_s = scratch + (size_t)SC_LEAST * N;
  float* bal_s = scratch + (size_t)SC_BALANCED * N;
  float* simon_s = scratch + (size_t)SC_SIMON * N;
  float* ip_s = scratch + (size_t)SC_IP * N;
  float* pern_s = scratch + (size_t)SC_PERNODE * N;
  float* sa_s = scratch + (size_t)SC_SA * N;
  float* flags_s = scratch + (size_t)SC_FLAGS * N;
  float* st_s = scratch + (size_t)SC_STORAGE * N;  // raw Open-Local score
  float* zone_sums = scratch + (size_t)SC_NODE_ROWS * N;
  float* marks = zone_sums + t.Z;  // [Ss, D1]
  for (size_t i = tid; i < (size_t)t.Z + (size_t)t.Ss * t.D1; i += bd) zone_sums[i] = 0.0f;
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int g = pod_group[p], forced = forced_node[p];
    if (!valid_pod[p]) {  // padded pod: feasible nowhere, commits nothing
      if (tid == 0) choices[p] = -1;
      continue;
    }
    // ---- A: per-pod scalars
    pod_prologue(t, g, 1, &pc, s_red);
    const size_t gN = (size_t)g * N;
    const int ss_id = t.ss_t[g];
    const int ssi = ss_id > 0 ? ss_id : 0;
    bool any_sa = false;
    for (int s = 0; s < t.Ss; ++s) any_sa = any_sa || t.sa_t[g * t.Ss + s] >= 0;
    bool has_storage = false;
    if (EXT && t.f_storage) {
      for (int s = 0; s < t.SL; ++s) has_storage = has_storage || t.grp_lvm_size[(size_t)g * t.SL + s] > 0.0f;
      for (int s = 0; s < t.SD; ++s) has_storage = has_storage || t.grp_sdev_size[(size_t)g * t.SD + s] > 0.0f;
    }

    // ---- B: per node, feasibility and every raw score term
    float mx[5] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float mn_simon = INFINITY, mn_ip = INFINITY, st_hi = -INFINITY, st_lo = INFINITY;
    bool anyF = false, have_zones = false;
    for (int n = tid; n < N; n += bd) {
      float st_raw = 0.0f;
      const uint32_t bits = node_feasibility<EXT, LANE>(t, &pc, g, forced, 1, 1, 1, n,
                                                        nullptr, &st_raw);
      const bool F = (bits >> BIT_FEASIBLE) & 1u;
      float flags = 0.0f;
      if (F) {
        anyF = true;
        if (EXT && t.f_storage) {
          st_s[n] = st_raw;
          st_hi = fmaxf(st_hi, st_raw);
          st_lo = fminf(st_lo, st_raw);
        }
        const float used_c = t.nonzero[(size_t)n * 2 + 0] + t.grp_nonzero[g * 2 + 0];
        const float used_m = t.nonzero[(size_t)n * 2 + 1] + t.grp_nonzero[g * 2 + 1];
        least_balanced(used_c, used_m, t.alloc[(size_t)n * R + 0], t.alloc[(size_t)n * R + 1],
                       &least_s[n], &bal_s[n]);
        const float ss = floorf(100.0f * t.simon_raw[gN + n]);
        simon_s[n] = ss;
        const float ip = interpod_raw_at(t, g, n);
        ip_s[n] = ip;
        const float pn = t.counter[(size_t)ssi * t.D1 + t.counter_dom[(size_t)ssi * N + n]];
        pern_s[n] = pn;
        mx[0] = fmaxf(mx[0], ss);
        mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
        mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
        mx[3] = fmaxf(mx[3], ip);
        mx[4] = fmaxf(mx[4], pn);
        mn_simon = fminf(mn_simon, ss);
        mn_ip = fminf(mn_ip, ip);
        const int zone = t.node_zone[n];
        if (zone > 0) have_zones = true;
        if (zone >= 0 && zone < t.Z) atomicAdd(&zone_sums[zone], pn);  // integer counts: exact
        // ScheduleAnyway: a node missing any valid term's key is ignored
        bool ignored = false;
        for (int s = 0; s < t.Ss; ++s) {
          const int id = t.sa_t[g * t.Ss + s];
          if (id >= 0 && t.counter_dom[(size_t)id * N + n] >= D) ignored = true;
        }
        flags = FL_F;
        if (!ignored) {
          flags += FL_REL;
          for (int s = 0; s < t.Ss; ++s) {
            const int id = t.sa_t[g * t.Ss + s];
            if (id >= 0) marks[(size_t)s * t.D1 + t.counter_dom[(size_t)id * N + n]] = 1.0f;
          }
        }
      }
      flags_s[n] = flags;
    }
    const int anyF_b = __syncthreads_or(anyF);
    if (!anyF_b) {  // nothing feasible: choice -1, commit nothing
      if (tid == 0) choices[p] = -1;  // no node marked, no zone sum touched
      continue;
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
    const Norms nm = {mx[0], mn_simon, fmaxf(mx[1], 0.0f), fmaxf(mx[2], 0.0f),
                      fmaxf(mx[3], 0.0f), fminf(mn_ip, 0.0f)};
    const float maxN = fmaxf(mx[4], 0.0f);
    // Open-Local normalizer: max(max_F raw, 0) and min_F raw (F is not empty)
    float st_rng = 0.0f;
    if (EXT && t.f_storage) {
      float v[2] = {st_hi, st_lo};
      const int op[2] = {OP_MAX, OP_MIN};
      block_reduce<2>(v, op, s_red);
      st_lo = isfinite(v[1]) ? v[1] : 0.0f;
      st_rng = fmaxf(v[0], 0.0f) - st_lo;
    }

    // ---- C: topology sizes of the ScheduleAnyway terms (count of marked
    // domains, sentinel column excluded), then clear the marks
    if (any_sa) {
      for (int s = 0; s < t.Ss; ++s) {
        if (t.sa_t[g * t.Ss + s] < 0) continue;
        float cnt = 0.0f;
        float* row = marks + (size_t)s * t.D1;
        for (int d = tid; d < t.D1; d += bd) {
          if (d < D && row[d] != 0.0f) cnt += 1.0f;
          row[d] = 0.0f;
        }
        float v[1] = {cnt};
        const int op[1] = {OP_SUM};
        block_reduce<1>(v, op, s_red);
        if (tid == 0) pc.tpw[s] = topology_weight(v[0]);
      }
      __syncthreads();
    }

    // ---- D: ScheduleAnyway raw scores and their extrema over relevant F
    float sa_hi = -INFINITY, sa_lo = INFINITY;
    for (int n = tid; n < N; n += bd) {
      if (flags_s[n] >= FL_F + FL_REL) {
        float acc = 0.0f;
        for (int s = 0; s < t.Ss; ++s) {
          const int id = t.sa_t[g * t.Ss + s];
          if (id < 0) continue;
          const float cnt = t.counter[(size_t)id * t.D1 + t.counter_dom[(size_t)id * N + n]];
          acc = acc + (cnt * pc.tpw[s] + (t.sa_maxskew[g * t.Ss + s] - 1.0f));
        }
        const float raw = floorf(acc);
        sa_s[n] = raw;
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

    // ---- E: normalized components, total in COMPONENT_ORDER, first-max argmax
    const bool has_ss = ss_id >= 0, ss_skip = t.ss_skip[g];
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int n = tid; n < N; n += bd) {
      const float fl = flags_s[n];
      if (fl == 0.0f) continue;  // infeasible: masked to -inf
      float simon, nodeaff, taint, interpod;
      normalized_terms(nm, simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_s[n],
                       &simon, &nodeaff, &taint, &interpod);
      const int zone = t.node_zone[n];
      const float zs = (zone >= 0 && zone < t.Z) ? zone_sums[zone] : 0.0f;
      const float blended = selector_spread_blend(pern_s[n], maxN, zs, maxZ,
                                                  have_zones_b && zone > 0);
      const float selector_spread = ss_skip ? 0.0f : (has_ss ? floorf(blended) : 100.0f);
      const float pts = fl >= FL_F + FL_REL ? sa_normalized(sa_s[n], sa_hi, sa_lo) : 0.0f;
      float total = t.w[W_LEAST] * least_s[n];
      total = total + t.w[W_BALANCED] * bal_s[n];
      const float openlocal = (EXT && has_storage && st_rng > 0.0f)
                                  ? floorf((st_s[n] - st_lo) * 100.0f / st_rng) : 0.0f;
      total = total + t.w[W_OPENLOCAL] * openlocal;
      total = total + t.w[W_SIMON] * simon;
      total = total + t.w[W_NODEAFF] * nodeaff;
      total = total + t.w[W_TAINT] * taint;
      total = total + t.w[W_INTERPOD] * interpod;
      total = total + t.w[W_SS] * selector_spread;
      total = total + t.w[W_PTS] * pts;
      total = total + t.w[W_AVOID] * t.avoid_raw[gN + n];
      total = total + t.w[W_IMAGE] * t.image_raw[gN + n];
      total = total + t.extra_raw[gN + n];
      argmax_update(total, n, &best, &best_i);
    }
    block_argmax(&best, &best_i, s_red, s_idx);
    const int c = best_i;

    // ---- F: commit at c (kernels.py:677-723), clear the zone sums
    for (int r = tid; r < R; r += bd) t.requested[(size_t)c * R + r] += t.grp_requests[(size_t)g * R + r];
    if (tid < 2) t.nonzero[(size_t)c * 2 + tid] += t.grp_nonzero[g * 2 + tid];
    for (int k = tid; k < t.PP; k += bd) {
      const int pid = t.grp_ports[g * t.PP + k];
      if (pid > 0) t.port_used[(size_t)c * t.PORT1 + pid] = 1;
    }
    for (int r = tid; r < t.T; r += bd) {
      const int dom = t.counter_dom[(size_t)r * N + c];
      if (dom < D && t.counter_sel_match_g[(size_t)r * t.G + g])
        t.counter[(size_t)r * t.D1 + dom] += 1.0f;
    }
    for (int r = tid; r < t.Tc; r += bd) {
      const int dom = t.carr_dom[(size_t)r * N + c];
      if (dom < D) t.carrier[(size_t)r * t.D1 + dom] += t.grp_carries[(size_t)g * t.Tc + r];
    }
    for (int z = tid; z < t.Z; z += bd) zone_sums[z] = 0.0f;
    if (tid == 0) {
      if constexpr (EXT) {
        // the device ledgers at c: one node, a few devices, one thread
        if (t.f_gpu) gpu_commit_at(t, g, c);
        if (t.f_storage) storage_commit_at(t, g, c);
      }
      choices[p] = c;
    }
    __syncthreads();
  }
}

template <bool EXT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_batch_kernel(TablesView t, const int* pod_group, const int* forced_node,
                      const uint8_t* valid_pod, int P, int* choices, float* scratch) {
  schedule_batch_body<EXT, false>(t, pod_group, forced_node, valid_pod, P, choices, scratch);
}

// K2 over lanes (JAX probe_serial_fanout :2359): block s scans the batch for
// lane s into its own carry slice, choices row [s, P] and scratch slice.
template <bool EXT>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_batch_lanes_kernel(TablesView t, const int* pod_group, const int* forced_node,
                            const uint8_t* valid_pod, int P, int* choices, float* scratch,
                            long long scratch_lane) {
  const int s = blockIdx.x;
  LANE_VIEW(lt, t, s)
  schedule_batch_body<EXT, true>(lt, pod_group, forced_node, valid_pod, P,
                                 choices + (size_t)s * P, scratch + s * scratch_lane);
}

// ------------------------------------------------------------ C interface --

extern "C" {

int tables_view_size() { return (int)sizeof(TablesView); }

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

long long schedule_scratch_floats(const TablesView* t) {
  return (long long)SC_NODE_ROWS * t->N + t->Z + (long long)t->Ss * t->D1;
}

int feasibility_launch(const TablesView* t, int g, int forced, int valid, int include_dns,
                       uint8_t* feasible, uint8_t* stages, uint8_t* fit_each,
                       cudaStream_t stream) {
  const int blocks = (t->N + K1_THREADS - 1) / K1_THREADS;
  feasibility_kernel<<<blocks, K1_THREADS, 0, stream>>>(*t, g, forced, valid, include_dns,
                                                        feasible, stages, fit_each);
  return (int)cudaGetLastError();
}

int schedule_batch_launch(const TablesView* t, const int* pod_group, const int* forced_node,
                          const uint8_t* valid, int P, int* choices, float* scratch,
                          cudaStream_t stream) {
  if (t->f_gpu || t->f_storage)
    schedule_batch_kernel<true><<<1, BLOCK_THREADS, 0, stream>>>(*t, pod_group, forced_node,
                                                                 valid, P, choices, scratch);
  else
    schedule_batch_kernel<false><<<1, BLOCK_THREADS, 0, stream>>>(*t, pod_group, forced_node,
                                                                  valid, P, choices, scratch);
  return (int)cudaGetLastError();
}

// S lanes: the view is lane 0's, `t->active` the [S, N] mask; scratch holds
// S slices of schedule_scratch_floats(t), choices [S, P]
int schedule_batch_lanes_launch(const TablesView* t, const int* pod_group, const int* forced_node,
                                const uint8_t* valid, int P, int S, int* choices, float* scratch,
                                cudaStream_t stream) {
  const long long lane = schedule_scratch_floats(t);
  if (t->f_gpu || t->f_storage)
    schedule_batch_lanes_kernel<true><<<S, BLOCK_THREADS, 0, stream>>>(
        *t, pod_group, forced_node, valid, P, choices, scratch, lane);
  else
    schedule_batch_lanes_kernel<false><<<S, BLOCK_THREADS, 0, stream>>>(
        *t, pod_group, forced_node, valid, P, choices, scratch, lane);
  return (int)cudaGetLastError();
}

}  // extern "C"
