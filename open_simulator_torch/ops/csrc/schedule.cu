// Hand-written Hopper kernels for the serial scheduling route.
//
// K1 feasibility_kernel replaces open_simulator_tpu/ops/kernels.py
//    `feasibility_jit` (:743, wrapping `feasibility` :379): one pod group's [N]
//    feasible mask, the per-stage masks and fit_each [N, R].
// K2 schedule_batch_kernel replaces `schedule_batch` (:2265, the lax.scan of
//    `_step` :728): per pod, feasibility, every score plugin, the first-max
//    argmax and the commit into the carry.
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
// Exactness contract with the plain PyTorch version (ops/kernels.py):
// - built with --fmad=false and without fast math: every multiply and add is
//   rounded separately, in the order of the JAX expression;
// - log is taken in f64 and rounded once to f32 (the plain version does the
//   same), so the ScheduleAnyway weights agree bit for bit;
// - sums over the small slot axes run left to right from 0;
// - the sums that run in parallel (SelectorSpread zone sums, topology sizes)
//   add integer-valued f32 counts, exact in any order below 2^24, so atomics
//   are safe there;
// - the argmax carries (value, index) pairs and prefers the smaller index on
//   equal values (JAX's first-max argmax).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_SLOTS 64
#define K2_THREADS 1024
#define K1_THREADS 256
#define FULL_MASK 0xffffffffu

// Field order must match ops/kernels.py _PTR_FIELDS / _DIM_FIELDS.
struct TablesView {
  const float* alloc;            // [N, R]
  const int* node_zone;          // [N]
  const uint8_t* static_mask;    // [G, N]
  const uint8_t* mask_taint;
  const uint8_t* mask_unsched;
  const uint8_t* mask_aff;
  const uint8_t* mask_extra;
  const float* simon_raw;        // [G, N]
  const float* nodeaff_raw;
  const float* taint_raw;
  const float* avoid_raw;
  const float* image_raw;
  const float* extra_raw;
  const float* grp_requests;     // [G, R]
  const float* grp_nonzero;      // [G, 2]
  const uint8_t* grp_unknown;    // [G]
  const int* grp_ports;          // [G, PP]
  const int* counter_dom;        // [T, N]
  const uint8_t* counter_sel_match_g;  // [T, G]
  const int* req_aff_t;          // [G, A]
  const uint8_t* grp_aff_self;   // [G]
  const int* req_anti_t;         // [G, B]
  const int* pref_t;             // [G, Cp]
  const float* pref_w;           // [G, Cp]
  const int* dns_t;              // [G, Sd]
  const float* dns_maxskew;      // [G, Sd]
  const float* dns_self;         // [G, Sd]
  const uint8_t* dns_edom;       // [G, Sd, D1]
  const int* sa_t;               // [G, Ss]
  const float* sa_maxskew;       // [G, Ss]
  const int* ss_t;               // [G]
  const uint8_t* ss_skip;        // [G]
  const int* carr_dom;           // [Tc, N]
  const int* carr_anti_t;        // [G, Ca]
  const int* carr_w_t;           // [G, Cw]
  const float* carr_w_w;         // [G, Cw]
  const float* grp_carries;      // [G, Tc]
  float* requested;              // carry [N, R]
  float* nonzero;                // carry [N, 2]
  uint8_t* port_used;            // carry [N, PORT1]
  float* counter;                // carry [T, D1]
  float* carrier;                // carry [Tc, D1]
  int N, R, G, T, Tc, D1, PORT1, PP, A, B, Cp, Sd, Ss, Ca, Cw, Z;
  int f_fit, f_ports, f_interpod, f_spread;
  // least balanced openlocal simon(+gpushare) nodeaff taint interpod ss pts avoid image extra
  float w[12];
};

// stage bits, in ops/kernels.py STAGE_ROWS order, then the feasible bit
enum {
  ST_STATIC = 0, ST_TAINT, ST_UNSCHED, ST_AFFINITY, ST_EXTRA, ST_FIT, ST_PORTS,
  ST_POD_AFFINITY, ST_POD_ANTI, ST_SPREAD, ST_GPU, ST_STORAGE, N_STAGES,
  BIT_FEASIBLE = N_STAGES
};

// Per-pod scalars every node's filters read, computed block-wide.
struct PodCtx {
  int bootstrap;
  float dns_min[MAX_SLOTS];
  float tpw[MAX_SLOTS];
};

enum { OP_MAX = 0, OP_MIN = 1, OP_SUM = 2 };

__device__ __forceinline__ float combine(float a, float b, int op) {
  return op == OP_MAX ? fmaxf(a, b) : (op == OP_MIN ? fminf(a, b) : a + b);
}

__device__ __forceinline__ float identity(int op) {
  return op == OP_MAX ? -INFINITY : (op == OP_MIN ? INFINITY : 0.0f);
}

// Reduce K values across the block; every thread gets the results. Two
// barriers; `s_red` holds K * 32 floats. Only max/min, or sums of
// integer-valued floats, go through here (order-free).
template <int K>
__device__ void block_reduce(float (&v)[K], const int (&op)[K], float* s_red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int o = 16; o > 0; o >>= 1)
      v[k] = combine(v[k], __shfl_xor_sync(FULL_MASK, v[k], o), op[k]);
  __syncthreads();  // the previous call's readers are done with s_red
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s_red[k * 32 + wid] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = lane < nw ? s_red[k * 32 + lane] : identity(op[k]);
    for (int o = 16; o > 0; o >>= 1) x = combine(x, __shfl_xor_sync(FULL_MASK, x, o), op[k]);
    v[k] = x;
  }
}

__device__ float block_min(float x, float* s_red) {
  float v[1] = {x};
  const int op[1] = {OP_MIN};
  block_reduce<1>(v, op, s_red);
  return v[0];
}

// Bootstrap flag of required affinity (kernels.py:427-437) and the
// DoNotSchedule minimum over eligible domains per term (:461-464).
// Block-uniform control flow; thread 0 writes `pc`; ends with a barrier.
__device__ void pod_prologue(const TablesView& t, int g, PodCtx* pc, float* s_red) {
  const int D = t.D1 - 1;
  int boot = 0;
  if (t.f_interpod && t.grp_aff_self[g]) {
    bool has_aff = false, nonzero = false;
    for (int a = 0; a < t.A; ++a) {
      const int id = t.req_aff_t[g * t.A + a];
      if (id < 0) continue;
      has_aff = true;
      // counters are non-negative counts, so sum == 0 iff every entry is 0
      const float* row = t.counter + (size_t)id * t.D1;
      for (int d = threadIdx.x; d < D; d += blockDim.x)
        if (row[d] != 0.0f) nonzero = true;
    }
    const int any_nz = __syncthreads_or(nonzero);
    boot = has_aff && !any_nz;
  }
  if (t.f_spread) {
    for (int s = 0; s < t.Sd; ++s) {
      const int id = t.dns_t[g * t.Sd + s];
      if (id < 0) {
        if (threadIdx.x == 0) pc->dns_min[s] = 0.0f;
        continue;
      }
      const float* row = t.counter + (size_t)id * t.D1;
      const uint8_t* edom = t.dns_edom + ((size_t)g * t.Sd + s) * t.D1;
      float m = INFINITY;
      for (int d = threadIdx.x; d < t.D1; d += blockDim.x)
        if (edom[d]) m = fminf(m, row[d]);
      m = block_min(m, s_red);
      if (threadIdx.x == 0) pc->dns_min[s] = isfinite(m) ? m : 0.0f;
    }
  }
  if (threadIdx.x == 0) pc->bootstrap = boot;
  __syncthreads();
}

// Every filter of `feasibility` (kernels.py:379-521, no GPU-share/Open-Local
// branch) for one node. Returns the stage bits plus BIT_FEASIBLE; writes
// fit_each[R] when `fit_each` is not null.
__device__ uint32_t node_feasibility(const TablesView& t, const PodCtx* pc, int g,
                                     int forced, int valid, int n, uint8_t* fit_each) {
  const int N = t.N, R = t.R, D = t.D1 - 1;
  const size_t gn = (size_t)g * N + n;
  const bool smask = t.static_mask[gn];

  // NodeResourcesFit: new_req <= alloc + alloc * 1e-6, or nothing requested
  bool fit = true;
  if (t.f_fit) {
    for (int r = 0; r < R; ++r) {
      const float a = t.alloc[(size_t)n * R + r];
      const float eps = a * (float)1e-6;
      const float q = t.grp_requests[(size_t)g * R + r];
      const float new_req = t.requested[(size_t)n * R + r] + q;
      const bool ok = (new_req <= a + eps) || (q == 0.0f);
      if (fit_each) fit_each[r] = ok;
      fit = fit && ok;
    }
    fit = fit && !t.grp_unknown[g];
  } else if (fit_each) {
    for (int r = 0; r < R; ++r) fit_each[r] = 1;
  }

  // NodePorts
  bool conflict = false;
  if (t.f_ports) {
    for (int k = 0; k < t.PP; ++k) {
      const int pid = t.grp_ports[g * t.PP + k];
      if (pid > 0 && t.port_used[(size_t)n * t.PORT1 + pid]) conflict = true;
    }
  }

  // InterPodAffinity
  bool aff_ok = true, blocked_in = false, blocked_ex = false;
  if (t.f_interpod) {
    bool aff_all = true;
    for (int a = 0; a < t.A; ++a) {
      const int id = t.req_aff_t[g * t.A + a];
      if (id < 0) continue;
      const int dom = t.counter_dom[(size_t)id * N + n];
      const float at = t.counter[(size_t)id * t.D1 + dom];
      aff_all = aff_all && (dom < D) && (at > 0.0f);
    }
    aff_ok = pc->bootstrap ? true : aff_all;
    for (int b = 0; b < t.B; ++b) {
      const int id = t.req_anti_t[g * t.B + b];
      if (id < 0) continue;
      const int dom = t.counter_dom[(size_t)id * N + n];
      if (t.counter[(size_t)id * t.D1 + dom] > 0.0f) blocked_in = true;
    }
    for (int c = 0; c < t.Ca; ++c) {
      const int id = t.carr_anti_t[g * t.Ca + c];
      if (id < 0) continue;
      const int dom = t.carr_dom[(size_t)id * N + n];
      if (t.carrier[(size_t)id * t.D1 + dom] > 0.0f) blocked_ex = true;
    }
  }

  // PodTopologySpread DoNotSchedule
  bool dns_ok = true;
  if (t.f_spread) {
    for (int s = 0; s < t.Sd; ++s) {
      const int id = t.dns_t[g * t.Sd + s];
      if (id < 0) continue;
      const int dom = t.counter_dom[(size_t)id * N + n];
      const float at = t.counter[(size_t)id * t.D1 + dom];
      const float skew = at + t.dns_self[g * t.Sd + s] - pc->dns_min[s];
      dns_ok = dns_ok && (dom < D) && (skew <= t.dns_maxskew[g * t.Sd + s]);
    }
  }

  bool feasible = smask && fit && !conflict && aff_ok && !blocked_in && !blocked_ex && dns_ok;
  feasible = feasible && valid && (forced < 0 || n == forced);

  uint32_t bits = 0;
  bits |= (uint32_t)smask << ST_STATIC;
  bits |= (uint32_t)(t.mask_taint[gn] != 0) << ST_TAINT;
  bits |= (uint32_t)(t.mask_unsched[gn] != 0) << ST_UNSCHED;
  bits |= (uint32_t)(t.mask_aff[gn] != 0) << ST_AFFINITY;
  bits |= (uint32_t)(t.mask_extra[gn] != 0) << ST_EXTRA;
  bits |= (uint32_t)fit << ST_FIT;
  bits |= (uint32_t)(!conflict) << ST_PORTS;
  bits |= (uint32_t)aff_ok << ST_POD_AFFINITY;
  bits |= (uint32_t)(!(blocked_in || blocked_ex)) << ST_POD_ANTI;
  bits |= (uint32_t)dns_ok << ST_SPREAD;
  bits |= 1u << ST_GPU;
  bits |= 1u << ST_STORAGE;
  bits |= (uint32_t)feasible << BIT_FEASIBLE;
  return bits;
}

// ----------------------------------------------------------------- K1 ------

__global__ void __launch_bounds__(K1_THREADS)
feasibility_kernel(TablesView t, int g, int forced, int valid, uint8_t* feasible,
                   uint8_t* stages, uint8_t* fit_each) {
  __shared__ PodCtx pc;
  __shared__ float s_red[32];
  pod_prologue(t, g, &pc, s_red);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= t.N) return;
  const uint32_t bits = node_feasibility(t, &pc, g, forced, valid, n,
                                         fit_each + (size_t)n * t.R);
  feasible[n] = (bits >> BIT_FEASIBLE) & 1u;
  for (int s = 0; s < N_STAGES; ++s) stages[(size_t)s * t.N + n] = (bits >> s) & 1u;
}

// ----------------------------------------------------------------- K2 ------

// scratch layout (floats): per-node rows, then zone sums, then domain marks
enum { SC_LEAST = 0, SC_BALANCED, SC_SIMON, SC_IP, SC_PERNODE, SC_SA, SC_FLAGS, SC_NODE_ROWS };
#define FL_F 1.0f
#define FL_REL 2.0f

__device__ __forceinline__ float floor_div100(float num, float den) {
  return floorf(num * 100.0f / den);
}

__global__ void __launch_bounds__(K2_THREADS, 1)
schedule_batch_kernel(TablesView t, const int* pod_group, const int* forced_node,
                      const uint8_t* valid_pod, int P, int* choices, float* scratch) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  __shared__ float s_idx[32];
  const int N = t.N, R = t.R, D = t.D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  float* least_s = scratch + (size_t)SC_LEAST * N;
  float* bal_s = scratch + (size_t)SC_BALANCED * N;
  float* simon_s = scratch + (size_t)SC_SIMON * N;
  float* ip_s = scratch + (size_t)SC_IP * N;
  float* pern_s = scratch + (size_t)SC_PERNODE * N;
  float* sa_s = scratch + (size_t)SC_SA * N;
  float* flags_s = scratch + (size_t)SC_FLAGS * N;
  float* zone_sums = scratch + (size_t)SC_NODE_ROWS * N;
  float* marks = zone_sums + t.Z;  // [Ss, D1]
  for (size_t i = tid; i < (size_t)t.Z + (size_t)t.Ss * t.D1; i += bd) zone_sums[i] = 0.0f;
  const float C13 = (float)(1.0 / 3.0), C23 = (float)(2.0 / 3.0);
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int g = pod_group[p], forced = forced_node[p];
    if (!valid_pod[p]) {  // padded pod: feasible nowhere, commits nothing
      if (tid == 0) choices[p] = -1;
      continue;
    }
    // ---- A: per-pod scalars
    pod_prologue(t, g, &pc, s_red);
    const size_t gN = (size_t)g * N;
    const int ss_id = t.ss_t[g];
    const int ssi = ss_id > 0 ? ss_id : 0;
    bool any_sa = false;
    for (int s = 0; s < t.Ss; ++s) any_sa = any_sa || t.sa_t[g * t.Ss + s] >= 0;

    // ---- B: per node, feasibility and every raw score term
    float mx[5] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float mn_simon = INFINITY, mn_ip = INFINITY;
    bool anyF = false, have_zones = false;
    for (int n = tid; n < N; n += bd) {
      const uint32_t bits = node_feasibility(t, &pc, g, forced, 1, n, nullptr);
      const bool F = (bits >> BIT_FEASIBLE) & 1u;
      float flags = 0.0f;
      if (F) {
        anyF = true;
        // least_balanced (kernels.py:255-270) on nonzero cpu/mem usage
        const float used_c = t.nonzero[(size_t)n * 2 + 0] + t.grp_nonzero[g * 2 + 0];
        const float used_m = t.nonzero[(size_t)n * 2 + 1] + t.grp_nonzero[g * 2 + 1];
        const float a_c = t.alloc[(size_t)n * R + 0], a_m = t.alloc[(size_t)n * R + 1];
        const float lc = (a_c > 0.0f && used_c <= a_c) ? floor_div100(a_c - used_c, a_c) : 0.0f;
        const float lm = (a_m > 0.0f && used_m <= a_m) ? floor_div100(a_m - used_m, a_m) : 0.0f;
        least_s[n] = floorf((lc + lm) / 2.0f);
        const float cf = a_c > 0.0f ? used_c / a_c : 1.0f;
        const float mf = a_m > 0.0f ? used_m / a_m : 1.0f;
        bal_s[n] = (cf >= 1.0f || mf >= 1.0f) ? 0.0f : floorf((1.0f - fabsf(cf - mf)) * 100.0f);
        const float ss = floorf(100.0f * t.simon_raw[gN + n]);
        simon_s[n] = ss;
        // interpod_raw (:237-252): preferred terms, then carrier weights
        float acc = 0.0f;
        for (int k = 0; k < t.Cp; ++k) {
          const int id = t.pref_t[g * t.Cp + k];
          if (id < 0) continue;
          const int dom = t.counter_dom[(size_t)id * N + n];
          acc = acc + t.pref_w[g * t.Cp + k] * t.counter[(size_t)id * t.D1 + dom];
        }
        float acc2 = 0.0f;
        for (int k = 0; k < t.Cw; ++k) {
          const int id = t.carr_w_t[g * t.Cw + k];
          if (id < 0) continue;
          const int dom = t.carr_dom[(size_t)id * N + n];
          acc2 = acc2 + t.carr_w_w[g * t.Cw + k] * t.carrier[(size_t)id * t.D1 + dom];
        }
        const float ip = acc + acc2;
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
    const float hi = mx[0], na_max = fmaxf(mx[1], 0.0f), t_max = fmaxf(mx[2], 0.0f);
    const float ip_max = fmaxf(mx[3], 0.0f), maxN = fmaxf(mx[4], 0.0f);
    const float lo = mn_simon, ip_min = fminf(mn_ip, 0.0f);
    const float rng = hi - lo, ip_rng = ip_max - ip_min;

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
        if (tid == 0) pc.tpw[s] = (float)log((double)(v[0] + 2.0f));
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
      const float ss = simon_s[n];
      const float simon = (rng > 0.0f && isfinite(rng)) ? floorf((ss - lo) * 100.0f / rng) : 0.0f;
      const float na_raw = t.nodeaff_raw[gN + n], t_raw = t.taint_raw[gN + n];
      const float nodeaff = na_max > 0.0f ? floorf(na_raw * 100.0f / na_max) : 0.0f;
      const float taint = t_max > 0.0f ? 100.0f - floorf(t_raw * 100.0f / t_max) : 100.0f;
      const float ip = ip_s[n];
      const float interpod = ip_rng > 0.0f ? floorf(100.0f * (ip - ip_min) / ip_rng) : 0.0f;
      // SelectorSpread (:173-189)
      const float pn = pern_s[n];
      const float node_score = maxN > 0.0f ? 100.0f * (maxN - pn) / maxN : 100.0f;
      const int zone = t.node_zone[n];
      const float zs = (zone >= 0 && zone < t.Z) ? zone_sums[zone] : 0.0f;
      const float zscore = maxZ > 0.0f ? 100.0f * (maxZ - zs) / maxZ : 100.0f;
      const float blended = (have_zones_b && zone > 0) ? node_score * C13 + zscore * C23 : node_score;
      const float selector_spread = ss_skip ? 0.0f : (has_ss ? floorf(blended) : 100.0f);
      // ScheduleAnyway normalization (:205-215)
      float pts = 0.0f;
      if (fl >= FL_F + FL_REL)
        pts = sa_hi > 0.0f ? floorf((sa_hi + sa_lo - sa_s[n]) * 100.0f / sa_hi) : 100.0f;
      float total = t.w[0] * least_s[n];
      total = total + t.w[1] * bal_s[n];
      total = total + t.w[2] * 0.0f;  // Open-Local: no storage demand on this route
      total = total + t.w[3] * simon;
      total = total + t.w[4] * nodeaff;
      total = total + t.w[5] * taint;
      total = total + t.w[6] * interpod;
      total = total + t.w[7] * selector_spread;
      total = total + t.w[8] * pts;
      total = total + t.w[9] * t.avoid_raw[gN + n];
      total = total + t.w[10] * t.image_raw[gN + n];
      total = total + t.extra_raw[gN + n];
      if (total > best || (total == best && n < best_i)) {
        best = total;
        best_i = n;
      }
    }
    // block argmax over (value desc, index asc)
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL_MASK, best, o);
      const int oi = __shfl_xor_sync(FULL_MASK, best_i, o);
      if (ov > best || (ov == best && oi < best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    __syncthreads();
    if ((tid & 31) == 0) {
      s_red[tid >> 5] = best;
      s_idx[tid >> 5] = __int_as_float(best_i);
    }
    __syncthreads();
    {
      const int lane = tid & 31, nw = (bd + 31) >> 5;
      best = lane < nw ? s_red[lane] : -INFINITY;
      best_i = lane < nw ? __float_as_int(s_idx[lane]) : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL_MASK, best, o);
        const int oi = __shfl_xor_sync(FULL_MASK, best_i, o);
        if (ov > best || (ov == best && oi < best_i)) {
          best = ov;
          best_i = oi;
        }
      }
    }
    const int c = best_i;

    // ---- F: commit at c (kernels.py:677-688), clear the zone sums
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
    if (tid == 0) choices[p] = c;
    __syncthreads();
  }
}

// ------------------------------------------------------------ C interface --

extern "C" {

int tables_view_size() { return (int)sizeof(TablesView); }

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

long long schedule_scratch_floats(const TablesView* t) {
  return (long long)SC_NODE_ROWS * t->N + t->Z + (long long)t->Ss * t->D1;
}

int feasibility_launch(const TablesView* t, int g, int forced, int valid, uint8_t* feasible,
                       uint8_t* stages, uint8_t* fit_each, cudaStream_t stream) {
  const int blocks = (t->N + K1_THREADS - 1) / K1_THREADS;
  feasibility_kernel<<<blocks, K1_THREADS, 0, stream>>>(*t, g, forced, valid, feasible, stages,
                                                        fit_each);
  return (int)cudaGetLastError();
}

int schedule_batch_launch(const TablesView* t, const int* pod_group, const int* forced_node,
                          const uint8_t* valid, int P, int* choices, float* scratch,
                          cudaStream_t stream) {
  schedule_batch_kernel<<<1, K2_THREADS, 0, stream>>>(*t, pod_group, forced_node, valid, P,
                                                      choices, scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
