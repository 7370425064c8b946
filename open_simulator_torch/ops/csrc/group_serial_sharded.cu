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
//    is `schedule_group_serial_sharded_plain`):
// - setup, once: K4's hoisted run state on the block (the base feasibility
//   without DoNotSchedule, the capacity, the constant score terms, the
//   SelectorSpread base counts, the nodes ScheduleAnyway ignores), j = 0,
//   the live rows from the carry;
// - per valid pod, A (front): the previous pod's commit from its gathered
//   rows (every rank updates the live rows; the owning rank j += 1), then
//   the live DoNotSchedule filter against the replicated rows and the
//   block's partial vector (ops/kernels.py GS_HEAD): the maxima of simon,
//   nodeaff, taint, ip and the SelectorSpread counts, the negated minima of
//   simon and ip, any feasible and any zoned feasible node, the [Z] zone
//   sums (ss_live) and the [Ss, D+1] ScheduleAnyway domain marks (sa_live).
//   all_gather_rows #1;
// - A2 (sa, sa_live only): the topology sizes from every rank's marks, the
//   raw scores of the block's relevant nodes from the live rows, their
//   block max and negated min. pmax #1b;
// - B (score): the vector reduced in rank order (maxima by max, the zone
//   sums by an ordered sum: integer-valued, exact), K4's score and the
//   block's first max as (score, global node) with the node's
//   DoNotSchedule and ScheduleAnyway domains: one f64 row [2 + Sd + Ss].
//   all_gather_rows #2;
// - C (commit, in the next pod's front or the finish launch): every rank
//   takes the same winner, the largest score and then the lowest global
//   node; no feasible node anywhere places nothing and changes nothing.
// Exactly two all_gather_rows per valid pod and a pmax more with sa_live.
// The host reads nothing per pod; `placed` is counted on the card.
//
// Exactness contract (common.cuh): --fmad=false, K4's score in its order,
// log in f64 rounded once, first-max ties on the global node, atomics only
// on integer-valued counts (the zone sums), min as -max(-x).
//
// What bounds it on an H100: as K12, the pod's three or four launches and
// two or three collectives (host round trips when ranks share a card over
// gloo), not the block's bytes. Right first, not fast.

#include "common.cuh"

// node flags of one step (K4's)
#define GS_F 1    // feasible
#define GS_REL 2  // counts for ScheduleAnyway (carries every term's key)

// the partial vector's head (ops/kernels.py GS_HEAD)
enum { Q_SIMON = 0, Q_NODEAFF, Q_TAINT, Q_IP, Q_PERNODE, Q_NSIMON, Q_NIP, Q_ANY, Q_ZONED,
       Q_HEAD };

// Float scratch: ip_raw, simon_s, static, base pernode, sa_raw [NL] each,
// then cnt [Sd, D1], cnt_sa [Ss, D1], the reduced zone sums [Z]. Int
// scratch: feas, cap, flags, sa_ignored, j [NL] each, then placed.
struct GsScratch {
  float *ip, *simon_s, *stat, *pern0, *sa_raw, *cnt, *cnt_sa, *zone_sums;
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
  s.zone_sums = s.cnt_sa + (size_t)t.Ss * t.D1;
  s.feas = is;
  s.cap = s.feas + N;
  s.flags = s.cap + N;
  s.ign = s.flags + N;
  s.j = s.ign + N;
  s.placed = s.j + N;
  return s;
}

// floats of the partial vector
static __host__ __device__ int gs_part_floats(const TablesView& t, int ss_live, int sa_live) {
  return Q_HEAD + (ss_live ? t.Z : 0) + (sa_live ? t.Ss * t.D1 : 0);
}

// ---- C: the previous pod's commit from every rank's best row ([R, 2 + Sd
// + Ss] f64, rank order) into the live rows, j and placed. Block-uniform;
// the caller orders it with a barrier.
static __device__ void gs_commit(const TablesView& t, int g, int lo, int R, int sa_live,
                                 const double* rows, const GsScratch& s) {
  const int W = 2 + t.Sd + t.Ss, D = t.D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  int win = 0;  // the largest score, then the lowest global node
  for (int r = 1; r < R; ++r) {
    const double v = rows[(size_t)r * W], b = rows[(size_t)win * W];
    if (v > b || (v == b && rows[(size_t)r * W + 1] < rows[(size_t)win * W + 1])) win = r;
  }
  const double* row = rows + (size_t)win * W;
  if (row[0] == -INFINITY) return;  // no feasible node on any rank
  for (int k = tid; k < t.Sd; k += bd) {
    const int id = t.dns_t[g * t.Sd + k];
    if (id >= 0 && t.counter_sel_match_g[(size_t)id * t.G + g])
      s.cnt[(size_t)k * t.D1 + (int)row[2 + k]] += 1.0f;
  }
  if (sa_live) {
    for (int k = tid; k < t.Ss; k += bd) {
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

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
gs_sharded_setup(TablesView t, int g, int cap1, float* fs, int* is) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  const int N = t.N, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  const int Sd = t.Sd, Ss = t.Ss;
  const GsScratch s = gs_scratch(t, fs, is);
  const int ss_id = max(t.ss_t[g], 0);
  pod_prologue(t, g, 0, &pc, s_red);
  for (int n = tid; n < N; n += bd) {
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
  for (size_t i = tid; i < (size_t)Sd * D1; i += bd)
    s.cnt[i] = t.counter[(size_t)max(t.dns_t[g * Sd + i / D1], 0) * D1 + i % D1];
  for (size_t i = tid; i < (size_t)Ss * D1; i += bd)
    s.cnt_sa[i] = t.counter[(size_t)max(t.sa_t[g * Ss + i / D1], 0) * D1 + i % D1];
  if (tid == 0) *s.placed = 0;
}

// ---- A: the previous pod's commit (prev_rows not null), then the block's
// feasible set and partial vector `part`
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
gs_sharded_front(TablesView t, int g, int lo, int R, int ss_live, int sa_live,
                 const double* prev_rows, float* fs, int* is, float* part) {
  __shared__ PodCtx pc;
  __shared__ float s_red[8 * 32];
  const int N = t.N, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, bd = blockDim.x;
  const int Sd = t.Sd, Ss = t.Ss, Z = t.Z;
  const size_t gN = (size_t)g * N;
  const GsScratch s = gs_scratch(t, fs, is);
  if (prev_rows != nullptr) gs_commit(t, g, lo, R, sa_live, prev_rows, s);
  const int K1 = gs_part_floats(t, ss_live, sa_live);
  for (int i = tid; i < K1; i += bd) part[i] = 0.0f;
  float* zone_sums = part + Q_HEAD;
  float* marks = zone_sums + (ss_live ? Z : 0);
  __syncthreads();  // the commit and the clearing, before any read below

  // the DoNotSchedule minimum of every valid term, from the live rows
  for (int k = 0; k < Sd; ++k) {
    if (t.dns_t[g * Sd + k] < 0) continue;
    const uint8_t* edom = t.dns_edom + ((size_t)g * Sd + k) * D1;
    float mn = INFINITY;
    for (int d = tid; d < D1; d += bd)
      if (edom[d]) mn = fminf(mn, s.cnt[(size_t)k * D1 + d]);
    mn = block_min(mn, s_red);
    if (tid == 0) pc.dns_min[k] = isfinite(mn) ? mn : 0.0f;
  }
  __syncthreads();

  float mx[7] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
  bool anyF = false, zoned = false;
  for (int n = tid; n < N; n += bd) {
    bool F = s.feas[n] && s.cap[n] - s.j[n] > 0;
    for (int k = 0; k < Sd && F; ++k) {
      const int id = t.dns_t[g * Sd + k];
      if (id < 0) continue;
      const int dom = t.counter_dom[(size_t)id * N + n];
      const float at = s.cnt[(size_t)k * D1 + dom];
      F = dom < D && at + t.dns_self[g * Sd + k] - pc.dns_min[k] <= t.dns_maxskew[g * Sd + k];
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
      if (ss_live && zone >= 0 && zone < Z) atomicAdd(&zone_sums[zone], pn);  // integer: exact
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
  const int any_b = __syncthreads_or(anyF);
  const int zoned_b = __syncthreads_or(zoned);
  {
    const int op[7] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MAX};
    block_reduce<7>(mx, op, s_red);
  }
  if (tid == 0) {
    for (int k = 0; k < 7; ++k) part[k] = mx[k];
    part[Q_ANY] = any_b ? 1.0f : 0.0f;
    part[Q_ZONED] = zoned_b ? 1.0f : 0.0f;
  }
}

// ---- A2: ScheduleAnyway's topology sizes from every rank's marks (rows
// [R, K1], the marks from offset mk), the raw scores of the block's
// relevant nodes from the live rows, and their block max and negated min
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
gs_sharded_sa(TablesView t, int g, int R, const float* rows, int K1, int mk, float* fs, int* is,
              float* part_b) {
  __shared__ float s_red[2 * 32];
  __shared__ float s_tpw[MAX_SLOTS];
  const int N = t.N, D1 = t.D1, D = D1 - 1, tid = threadIdx.x, bd = blockDim.x, Ss = t.Ss;
  const GsScratch s = gs_scratch(t, fs, is);
  for (int k = 0; k < Ss; ++k) {
    if (t.sa_t[g * Ss + k] < 0) continue;
    float c = 0.0f;
    for (int d = tid; d < D; d += bd) {
      float m = 0.0f;
      for (int r = 0; r < R; ++r) m = fmaxf(m, rows[(size_t)r * K1 + mk + (size_t)k * D1 + d]);
      if (m != 0.0f) c += 1.0f;
    }
    float v[1] = {c};
    const int op[1] = {OP_SUM};
    block_reduce<1>(v, op, s_red);
    if (tid == 0) s_tpw[k] = topology_weight(v[0]);
  }
  __syncthreads();
  float v[2] = {-INFINITY, -INFINITY};
  for (int n = tid; n < N; n += bd) {
    if (!(s.flags[n] & GS_REL)) continue;
    float acc = 0.0f;
    for (int k = 0; k < Ss; ++k) {
      const int id = t.sa_t[g * Ss + k];
      if (id < 0) continue;
      const float c = s.cnt_sa[(size_t)k * D1 + t.counter_dom[(size_t)id * N + n]];
      acc = acc + (c * s_tpw[k] + (t.sa_maxskew[g * Ss + k] - 1.0f));
    }
    const float raw = floorf(acc);
    s.sa_raw[n] = raw;
    v[0] = fmaxf(v[0], raw);
    v[1] = fmaxf(v[1], -raw);
  }
  const int op[2] = {OP_MAX, OP_MAX};
  block_reduce<2>(v, op, s_red);
  if (tid == 0) {
    part_b[0] = v[0];
    part_b[1] = v[1];
  }
}

// ---- B: the normalizers from every rank's partials (rows [R, K1]) and
// ScheduleAnyway's reduced extrema (sa_red, null without sa_live), then
// K4's score on the block and its first max: row2 = [score, global node,
// the node's DoNotSchedule domains (Sd), its ScheduleAnyway domains (Ss)]
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
gs_sharded_score(TablesView t, int g, int lo, int R, int ss_live, int sa_live, const float* rows,
                 int K1, const float* sa_red, float* fs, int* is, double* row2) {
  __shared__ float s_red[32];
  __shared__ int s_idx[32];
  __shared__ float s_head[Q_HEAD];
  const int N = t.N, Rr = t.R, D = t.D1 - 1, tid = threadIdx.x, bd = blockDim.x, Z = t.Z;
  const int Sd = t.Sd, Ss = t.Ss;
  const size_t gN = (size_t)g * N;
  const GsScratch s = gs_scratch(t, fs, is);
  if (tid < Q_HEAD) {
    float m = rows[tid];
    for (int r = 1; r < R; ++r) m = fmaxf(m, rows[(size_t)r * K1 + tid]);
    s_head[tid] = m;
  }
  if (ss_live) {
    for (int z = tid; z < Z; z += bd) {
      float x = rows[Q_HEAD + z];
      for (int r = 1; r < R; ++r) x = x + rows[(size_t)r * K1 + Q_HEAD + z];  // rank order
      s.zone_sums[z] = x;
    }
  }
  __syncthreads();
  float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
  if (ss_live)
    for (int z = 1 + tid; z < Z; z += bd) maxZ = fmaxf(maxZ, s.zone_sums[z]);
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
  int best_i = 0x7fffffff;
  for (int n = tid; n < N; n += bd) {
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
      const float zs = (zone >= 0 && zone < Z) ? s.zone_sums[zone] : 0.0f;
      const float blend = selector_spread_blend(s.pern0[n] + (float)s.j[n], maxN, zs, maxZ,
                                                have_zones && zone > 0);
      score = score + t.w[W_SS] * floorf(blend);
    }
    if (sa_live) {
      const float pts = (fl & GS_REL) ? sa_normalized(s.sa_raw[n], sa_hi, sa_lo) : 0.0f;
      score = score + t.w[W_PTS] * pts;
    }
    argmax_update(score, n, &best, &best_i);
  }
  block_argmax(&best, &best_i, s_red, s_idx);
  const bool found = best_i < N;
  if (tid == 0) {
    row2[0] = (double)best;
    row2[1] = (double)(found ? lo + best_i : lo + N);
  }
  for (int k = tid; k < Sd + Ss; k += bd) {
    const int id = k < Sd ? t.dns_t[g * Sd + k] : t.sa_t[g * Ss + k - Sd];
    row2[2 + k] = (found && id >= 0) ? (double)t.counter_dom[(size_t)id * N + best_i]
                                     : (double)D;
  }
}

// ---- the last pod's commit
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
gs_sharded_finish(TablesView t, int g, int lo, int R, int sa_live, const double* rows, float* fs,
                  int* is) {
  gs_commit(t, g, lo, R, sa_live, rows, gs_scratch(t, fs, is));
}

// ------------------------------------------------------------ C interface --

extern "C" {

// (float scratch, int scratch) sizes of K13 on the block's view
long long gs_sharded_scratch_floats(const TablesView* t) {
  return 5LL * t->N + (long long)(t->Sd + t->Ss) * t->D1 + t->Z;
}
long long gs_sharded_scratch_ints(const TablesView* t) { return 5LL * t->N + 1; }
// floats of the partial vector (all_gather_rows #1), and the offset of the
// ScheduleAnyway marks in it
int gs_sharded_part_floats(const TablesView* t, int ss_live, int sa_live) {
  return gs_part_floats(*t, ss_live, sa_live);
}
int gs_sharded_marks_offset(const TablesView* t, int ss_live) {
  return Q_HEAD + (ss_live ? t->Z : 0);
}
// offsets of j [NL] and placed in the int scratch
long long gs_sharded_j_offset(const TablesView* t) { return 4LL * t->N; }

int gs_sharded_setup_launch(const TablesView* t, int g, int cap1, float* fs, int* is,
                            cudaStream_t stream) {
  gs_sharded_setup<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, cap1, fs, is);
  return (int)cudaGetLastError();
}

int gs_sharded_front_launch(const TablesView* t, int g, int lo, int R, int ss_live, int sa_live,
                            const double* prev_rows, float* fs, int* is, float* part,
                            cudaStream_t stream) {
  gs_sharded_front<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, lo, R, ss_live, sa_live, prev_rows,
                                                    fs, is, part);
  return (int)cudaGetLastError();
}

int gs_sharded_sa_launch(const TablesView* t, int g, int R, const float* rows, int K1, int mk,
                         float* fs, int* is, float* part_b, cudaStream_t stream) {
  gs_sharded_sa<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, R, rows, K1, mk, fs, is, part_b);
  return (int)cudaGetLastError();
}

int gs_sharded_score_launch(const TablesView* t, int g, int lo, int R, int ss_live, int sa_live,
                            const float* rows, int K1, const float* sa_red, float* fs, int* is,
                            double* row2, cudaStream_t stream) {
  gs_sharded_score<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, lo, R, ss_live, sa_live, rows, K1,
                                                    sa_red, fs, is, row2);
  return (int)cudaGetLastError();
}

int gs_sharded_finish_launch(const TablesView* t, int g, int lo, int R, int sa_live,
                             const double* rows, float* fs, int* is, cudaStream_t stream) {
  gs_sharded_finish<<<1, BLOCK_THREADS, 0, stream>>>(*t, g, lo, R, sa_live, rows, fs, is);
  return (int)cudaGetLastError();
}

}  // extern "C"
