// Hand-written Hopper kernel for the group-serial ("spread") route.
//
// K4 schedule_group_serial_kernel replaces open_simulator_tpu/ops/kernels.py
//    `schedule_group_serial` (:2102/:2104): the serial scan of one group whose
//    placements feed its own DoNotSchedule filter (live [Sd, D+1] counter
//    rows), its SelectorSpread score (ss_live: per-node counts base + j, with
//    the zone blend) and its ScheduleAnyway score (sa_live: live [Ss, D+1]
//    rows). Everything else a step reads is constant within the run and is
//    computed once. Returns per-node counts; K3c commits them.
//
// What bounds it on an H100: like K2, a chain of dependent block-wide
// reductions, one step per pod (~10 barriers, a few dozen bytes per node);
// latency bound. Design: ONE persistent block of 1,024 threads loops over the
// segment's pods; the live rows stay in device memory (and L2). It reuses
// K2's device code (common.cuh) for the filters and the score formulas.
//
// K4 over lanes (schedule_group_serial_lanes_kernel, one block per lane)
// replaces `probe_group_serial_fanout` (:2320/:2322); see common.cuh
// `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "common.cuh"

// node flags of one step
#define GS_F 1    // feasible
#define GS_REL 2  // counts for ScheduleAnyway (carries every term's key)

// Float scratch: ip_raw, simon_s, static, base pernode, sa_raw [N] each, then
// cnt [Sd, D1], cnt_sa [Ss, D1], marks [Ss, D1], zone sums [Z].
// Int scratch: feas, cap, flags, sa_ignored [N] each.
// LANE: the lane kernel's body (the lane's active row folds into the static
// mask); the single-lane kernel runs LANE = false.
template <bool LANE>
static __device__ __forceinline__ void
schedule_group_serial_body(const TablesView& t, int g, const uint8_t* valid, int P, int cap1,
                           int ss_live, int sa_live, int* j, int* placed_out, float* fs,
                           int* is) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  __shared__ int s_idx[32];
  const int N = t.N, R = t.R, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  const int Sd = t.Sd, Ss = t.Ss, Z = t.Z;
  const size_t gN = (size_t)g * N;
  float* ip_s = fs;
  float* simon_s = ip_s + N;
  float* stat_s = simon_s + N;
  float* pern0_s = stat_s + N;
  float* sa_raw_s = pern0_s + N;
  float* cnt = sa_raw_s + N;
  float* cnt_sa = cnt + (size_t)Sd * D1;
  float* marks = cnt_sa + (size_t)Ss * D1;
  float* zone_sums = marks + (size_t)Ss * D1;
  int* feas_s = is;
  int* cap_s = feas_s + N;
  int* flags_s = cap_s + N;
  int* ign_s = flags_s + N;
  const int ss_id = max(t.ss_t[g], 0);
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];

  // ---- run constants: base feasibility without DoNotSchedule, capacity,
  // static score terms, the live rows' start values
  pod_prologue(t, g, 0, &pc, s_red);
  for (int n = tid; n < N; n += bd) {
    segment_node_constants<false, LANE>(t, &pc, g, n, cap1, 0, 1, &feas_s[n], &cap_s[n],
                                        &ip_s[n], &simon_s[n], &stat_s[n]);
    pern0_s[n] = t.counter[(size_t)ss_id * D1 + t.counter_dom[(size_t)ss_id * N + n]];
    bool ignored = false;
    for (int s = 0; s < Ss; ++s) {
      const int id = t.sa_t[g * Ss + s];
      if (id >= 0 && t.counter_dom[(size_t)id * N + n] >= D) ignored = true;
    }
    ign_s[n] = ignored;
    j[n] = 0;
  }
  for (size_t i = tid; i < (size_t)Sd * D1; i += bd)
    cnt[i] = t.counter[(size_t)max(t.dns_t[g * Sd + i / D1], 0) * D1 + i % D1];
  for (size_t i = tid; i < (size_t)Ss * D1; i += bd) {
    cnt_sa[i] = t.counter[(size_t)max(t.sa_t[g * Ss + i / D1], 0) * D1 + i % D1];
    marks[i] = 0.0f;
  }
  for (int z = tid; z < Z; z += bd) zone_sums[z] = 0.0f;
  __syncthreads();

  int placed = 0;
  for (int p = 0; p < P; ++p) {
    if (!valid[p]) continue;  // padded pod: commits nothing
    // ---- A: the DoNotSchedule minimum of every valid term, from live rows
    for (int s = 0; s < Sd; ++s) {
      if (t.dns_t[g * Sd + s] < 0) continue;
      const uint8_t* edom = t.dns_edom + ((size_t)g * Sd + s) * D1;
      float mn = INFINITY;
      for (int d = tid; d < D1; d += bd)
        if (edom[d]) mn = fminf(mn, cnt[(size_t)s * D1 + d]);
      mn = block_min(mn, s_red);
      if (tid == 0) pc.dns_min[s] = isfinite(mn) ? mn : 0.0f;
    }
    __syncthreads();

    // ---- B: the feasible set and the normalizer inputs over it
    float mx[5] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float mn_simon = INFINITY, mn_ip = INFINITY;
    bool anyF = false, have_zones = false;
    for (int n = tid; n < N; n += bd) {
      bool F = feas_s[n] && cap_s[n] - j[n] > 0;
      for (int s = 0; s < Sd && F; ++s) {
        const int id = t.dns_t[g * Sd + s];
        if (id < 0) continue;
        const int dom = t.counter_dom[(size_t)id * N + n];
        const float at = cnt[(size_t)s * D1 + dom];
        F = dom < D && at + t.dns_self[g * Sd + s] - pc.dns_min[s] <= t.dns_maxskew[g * Sd + s];
      }
      int flags = 0;
      if (F) {
        anyF = true;
        flags = GS_F;
        mx[0] = fmaxf(mx[0], simon_s[n]);
        mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
        mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
        mx[3] = fmaxf(mx[3], ip_s[n]);
        mn_simon = fminf(mn_simon, simon_s[n]);
        mn_ip = fminf(mn_ip, ip_s[n]);
        if (ss_live) {
          const float pn = pern0_s[n] + (float)j[n];
          mx[4] = fmaxf(mx[4], pn);
          const int zone = t.node_zone[n];
          if (zone > 0) have_zones = true;
          if (zone >= 0 && zone < Z) atomicAdd(&zone_sums[zone], pn);  // integer counts: exact
        }
        if (sa_live && !ign_s[n]) {
          flags |= GS_REL;
          for (int s = 0; s < Ss; ++s) {
            const int id = t.sa_t[g * Ss + s];
            if (id >= 0) marks[(size_t)s * D1 + t.counter_dom[(size_t)id * N + n]] = 1.0f;
          }
        }
      }
      flags_s[n] = flags;
    }
    // nothing feasible: nothing is committed, so no later pod fits either
    if (!__syncthreads_or(anyF)) break;
    const int have_zones_b = __syncthreads_or(have_zones);
    float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
    for (int z = 1 + tid; z < Z; z += bd) maxZ = fmaxf(maxZ, zone_sums[z]);
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

    // ---- C, D: ScheduleAnyway topology sizes over the relevant feasible
    // set (marks cleared), raw scores and their extrema
    float sa_hi = 0.0f, sa_lo = 0.0f;
    if (sa_live) {
      for (int s = 0; s < Ss; ++s) {
        if (t.sa_t[g * Ss + s] < 0) continue;
        float c = 0.0f;
        float* row = marks + (size_t)s * D1;
        for (int d = tid; d < D1; d += bd) {
          if (d < D && row[d] != 0.0f) c += 1.0f;
          row[d] = 0.0f;
        }
        float v[1] = {c};
        const int op[1] = {OP_SUM};
        block_reduce<1>(v, op, s_red);
        if (tid == 0) pc.tpw[s] = topology_weight(v[0]);
      }
      __syncthreads();
      float hi = -INFINITY, lo = INFINITY;
      for (int n = tid; n < N; n += bd) {
        if (!(flags_s[n] & GS_REL)) continue;
        float acc = 0.0f;
        for (int s = 0; s < Ss; ++s) {
          const int id = t.sa_t[g * Ss + s];
          if (id < 0) continue;
          const float c = cnt_sa[(size_t)s * D1 + t.counter_dom[(size_t)id * N + n]];
          acc = acc + (c * pc.tpw[s] + (t.sa_maxskew[g * Ss + s] - 1.0f));
        }
        const float raw = floorf(acc);
        sa_raw_s[n] = raw;
        hi = fmaxf(hi, raw);
        lo = fminf(lo, raw);
      }
      float v[2] = {hi, lo};
      const int op[2] = {OP_MAX, OP_MIN};
      block_reduce<2>(v, op, s_red);
      sa_hi = fmaxf(v[0], 0.0f);
      sa_lo = isfinite(v[1]) ? v[1] : 0.0f;
    }

    // ---- E: the score and the first-max argmax over F
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    for (int n = tid; n < N; n += bd) {
      const int fl = flags_s[n];
      if (!fl) continue;
      // the candidate pod counts toward its own usage, hence j + 1
      const float copies = (float)(j[n] + 1);
      float least, bal;
      least_balanced(t.nonzero[(size_t)n * 2 + 0] + gz_c * copies,
                     t.nonzero[(size_t)n * 2 + 1] + gz_m * copies,
                     t.alloc[(size_t)n * R + 0], t.alloc[(size_t)n * R + 1], &least, &bal);
      const float lb = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal;
      float simon, nodeaff, taint, interpod;
      normalized_terms(nm, simon_s[n], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_s[n],
                       &simon, &nodeaff, &taint, &interpod);
      float score = lb + t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff + t.w[W_TAINT] * taint
                    + t.w[W_INTERPOD] * interpod + stat_s[n];
      if (ss_live) {
        const int zone = t.node_zone[n];
        const float zs = (zone >= 0 && zone < Z) ? zone_sums[zone] : 0.0f;
        const float blend = selector_spread_blend(pern0_s[n] + (float)j[n], maxN, zs, maxZ,
                                                  have_zones_b && zone > 0);
        score = score + t.w[W_SS] * floorf(blend);
      }
      if (sa_live) {
        const float pts = (fl & GS_REL) ? sa_normalized(sa_raw_s[n], sa_hi, sa_lo) : 0.0f;
        score = score + t.w[W_PTS] * pts;
      }
      argmax_update(score, n, &best, &best_i);
    }
    block_argmax(&best, &best_i, s_red, s_idx);
    const int c = best_i;

    // ---- F: commit the pod into the live state, clear the zone sums
    if (tid == 0) j[c] += 1;
    for (int s = tid; s < Sd; s += bd) {
      const int id = t.dns_t[g * Sd + s];
      if (id >= 0 && t.counter_sel_match_g[(size_t)id * t.G + g])
        cnt[(size_t)s * D1 + t.counter_dom[(size_t)id * N + c]] += 1.0f;
    }
    if (sa_live) {
      for (int s = tid; s < Ss; s += bd) {
        const int id = t.sa_t[g * Ss + s];
        if (id < 0 || !t.counter_sel_match_g[(size_t)id * t.G + g]) continue;
        const int dom = t.counter_dom[(size_t)id * N + c];
        if (dom < D) cnt_sa[(size_t)s * D1 + dom] += 1.0f;
      }
    }
    for (int z = tid; z < Z; z += bd) zone_sums[z] = 0.0f;
    ++placed;
    __syncthreads();
  }
  if (tid == 0) *placed_out = placed;
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_group_serial_kernel(TablesView t, int g, const uint8_t* valid, int P, int cap1,
                             int ss_live, int sa_live, int* j, int* placed_out, float* fs,
                             int* is) {
  schedule_group_serial_body<false>(t, g, valid, P, cap1, ss_live, sa_live, j, placed_out, fs,
                                    is);
}

// K4 over lanes (JAX probe_group_serial_fanout :2320): block s scans lane s
// into its own j row [s, N], placed[s] and scratch slices.
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
schedule_group_serial_lanes_kernel(TablesView t, int g, const uint8_t* valid, int P, int cap1,
                                   int ss_live, int sa_live, int* j, int* placed_out, float* fs,
                                   int* is, long long fs_lane, long long is_lane) {
  const int s = blockIdx.x;
  LANE_VIEW(lt, t, s)
  schedule_group_serial_body<true>(lt, g, valid, P, cap1, ss_live, sa_live, j + (size_t)s * t.N,
                                   placed_out + s, fs + s * fs_lane, is + s * is_lane);
}

// ------------------------------------------------------------ C interface --

extern "C" {

// (float scratch, int scratch) sizes of K4
long long group_serial_scratch_floats(const TablesView* t) {
  return 5LL * t->N + (long long)(t->Sd + 2 * t->Ss) * t->D1 + t->Z;
}
long long group_serial_scratch_ints(const TablesView* t) { return 4LL * t->N; }

int schedule_group_serial_launch(const TablesView* t, int g, const uint8_t* valid, int P,
                                 int cap1, int ss_live, int sa_live, int* j, int* placed,
                                 float* fs, int* is, cudaStream_t stream) {
  schedule_group_serial_kernel<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, valid, P, cap1, ss_live,
                                                                sa_live, j, placed, fs, is);
  return (int)cudaGetLastError();
}

// S lanes: the view is lane 0's with `t->active` the [S, N] mask; j [S, N],
// placed [S]; fs, is S slices of the scratch sizes above
int schedule_group_serial_lanes_launch(const TablesView* t, int g, const uint8_t* valid, int P,
                                       int cap1, int ss_live, int sa_live, int S, int* j,
                                       int* placed, float* fs, int* is, cudaStream_t stream) {
  schedule_group_serial_lanes_kernel<<<S, BLOCK_THREADS, 0, stream>>>(
      *t, g, valid, P, cap1, ss_live, sa_live, j, placed, fs, is,
      group_serial_scratch_floats(t), group_serial_scratch_ints(t));
  return (int)cudaGetLastError();
}

}  // extern "C"
