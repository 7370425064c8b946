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
// What bounds it on an H100: like K2, a chain of dependent cross-node
// reductions, one step per pod (a few dozen bytes per node); latency bound.
// Design: one persistent thread-block cluster of C CTAs (cluster.cuh) loops
// over the segment's pods. CTA r owns a contiguous slice of the node axis
// and keeps its nodes' run constants (feasibility, capacity, interpod raw,
// floored Simon input, static terms, base per-node count, ScheduleAnyway
// ignore flag) and counts j in its shared memory for the whole segment; each
// CTA keeps its own copy of the live [Sd + Ss, D+1] rows in scratch and,
// knowing the chosen node, updates it as every other CTA does, with the
// DoNotSchedule minima kept level by level (dns_levels). So a commit
// touches no memory another CTA reads (but for the wide marks' copies,
// ordered as in K2: schedule.cu), and a pod step costs 2 rounds (3
// with ScheduleAnyway; cluster.cuh): round 1 carries the normalizer
// extrema, anyF, have_zones, the zone sums and the ScheduleAnyway marks,
// round 2 the ScheduleAnyway extrema, round 3 the first-max argmax. It
// reuses K2's device code (common.cuh) for the filters and the score
// formulas.
//
// K4 over lanes (schedule_group_serial_lanes_kernel, one cluster per lane)
// replaces `probe_group_serial_fanout` (:2320/:2322); see common.cuh
// `lane_view`.
//
// The exactness contract with the plain PyTorch version is in common.cuh.

#include "cluster.cuh"

// node bits of the run and of one step
#define GS_FEAS 1  // feasible without DoNotSchedule (run constant)
#define GS_IGN 2   // misses a ScheduleAnyway term's key (run constant)
#define GS_F 4     // feasible this step
#define GS_REL 8   // counts for ScheduleAnyway this step
#define K4_KEYS 9

// K4's per-node rows of a CTA: the run rows cap and j [chunk] i32, interpod
// raw, floored Simon input, static terms, base per-node count and the
// step's ScheduleAnyway raw [chunk] f32, and the bits [chunk] u8, padded to
// 4 bytes. They are the first part of its dynamic shared memory when they
// fit (cluster.cuh rows_on_chip), else its slice of scratch.
static __host__ __device__ inline long long k4_rows_bytes(int N, int C) {
  const long long chunk = (N + C - 1) / C;
  return 4LL * 7 * chunk + ((chunk + 3) & ~3LL);
}

static __host__ __device__ inline long long k4_rounds_bytes(const TablesView& t, int C) {
  return cluster_rounds_bytes(C, K4_KEYS, t.Ss, t.Z, t.D1);
}

// K4's dynamic shared memory at C, the one formula of it (ops/cluster.py
// takes it from here)
static __host__ __device__ inline long long k4_smem_bytes(const TablesView& t, int C) {
  return cluster_smem_bytes(k4_rows_bytes(t.N, C), k4_rounds_bytes(t, C));
}

// Floats of one lane's scratch: each CTA's live rows cnt [Sd, D1] and
// cnt_sa [Ss, D1], then each CTA's wide ScheduleAnyway bitsets (cluster.cuh
// wide_mark_words), then each CTA's per-node rows when they are not on chip
static __host__ __device__ inline long long k4_scratch_floats(const TablesView& t, int C) {
  const long long rows = k4_rows_bytes(t.N, C);
  return (long long)C * (t.Sd + t.Ss) * t.D1 + wide_mark_words(C, t.Ss, t.D1)
         + (rows_on_chip(rows, k4_rounds_bytes(t, C)) ? 0 : C * rows / 4);
}

// One lane's segment on this CTA's cluster. `t_in` is the launch's view
// (lane 0's for the lane kernel, moved to lane s by lane_view); j_out [N],
// placed_out [1], stats [STATS_WORDS] (cluster.cuh) are the lane's.
template <bool LANE>
static __device__ __forceinline__ void
schedule_group_serial_body(const TablesView& t_in, int s, int g, const uint8_t* valid, int P,
                           int cap1, int ss_live, int sa_live, int* j_out, int* placed_out,
                           float* fs, long long* stats) {
  __shared__ TablesView t;
  __shared__ PodCtx pc;
  __shared__ uint64_t s_mbar[2];
  SLOT_ARRAY(float, s_mn);  // the DoNotSchedule levels (dns_levels)
  SLOT_ARRAY(int, s_nmin);
  TERM_WORD(s_rescan);
  WARP_WORDS(s_warp);
  __shared__ int s_fin[2];
  // 4-byte words: a 16-byte alignment would pad the static shared memory of
  // every kernel of this file
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int C = cluster_ctas(), rank = cluster_rank();
  if (tid == 0) t = LANE ? lane_view(t_in, s) : t_in;
  __syncthreads();
  POD_BIND(pc, t);
  SLOT_BIND(s_mn, t, WR_MN);
  SLOT_BIND(s_nmin, t, WR_NMIN);
  TERM_BIND(s_rescan, t, WC_RESCAN);
  WARP_BIND(s_warp, t);
  const int N = t.N, R = t.R, D1 = t.D1, D = D1 - 1, Sd = t.Sd, Ss = t.Ss, Z = t.Z;
  const int chunk = (N + C - 1) / C, Wd = mark_words(D1);
  const int W = K4_KEYS + Z + mark_or_words(Ss, D1);
  const long long rows_b = k4_rows_bytes(N, C);
  const bool on_chip = rows_on_chip(rows_b, k4_rounds_bytes(t, C));
  // scratch past the live rows: the CTAs' wide mark copies, the node rows
  uint32_t* mk_g = (uint32_t*)(fs + (size_t)C * (Sd + Ss) * D1);
  float* rows_g = (float*)(mk_g + wide_mark_words(C, Ss, D1)) + (size_t)rank * (rows_b / 4);
  int* cap_s = on_chip ? (int*)smem : (int*)rows_g;
  int* j_s = cap_s + chunk;
  float* ip_s = (float*)(j_s + chunk);
  float* simon_s = ip_s + chunk;
  float* stat_s = simon_s + chunk;
  float* pern0_s = stat_s + chunk;
  float* sa_s = pern0_s + chunk;
  uint8_t* bits_s = (uint8_t*)(sa_s + chunk);
  uint32_t* mk_s = smem + (on_chip ? rows_b / 4 : 0);  // fused marks [2][mark_or_words]
  int* slots = (int*)(mk_s + 2 * mark_or_words(Ss, D1));
  int* fin = slots + 2 * C * W;
  float* part = (float*)(fin + W);
  float* cnt = fs + (size_t)rank * (Sd + Ss) * D1;  // this CTA's live rows
  float* cnt_sa = cnt + (size_t)Sd * D1;
  const size_t gN = (size_t)g * N;
  const int ss_id = max(t.ss_t[g], 0);
  const float gz_c = t.grp_nonzero[g * 2 + 0], gz_m = t.grp_nonzero[g * 2 + 1];
  Cluster cx = cluster_setup(N, W, slots, s_mbar);

  // ---- run constants: base feasibility without DoNotSchedule, capacity,
  // static score terms, the live rows' start values
  cta_prologue(t, g, true, 0, &pc, s_warp);
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
    const int l = n - cx.lo;
    int feas;
    segment_node_constants<false, LANE>(t, &pc, g, n, cap1, 0, 1, &feas, &cap_s[l], &ip_s[l],
                                        &simon_s[l], &stat_s[l]);
    pern0_s[l] = t.counter[(size_t)ss_id * D1 + t.counter_dom[(size_t)ss_id * N + n]];
    bool ignored = false;
    for (int s2 = 0; s2 < Ss; ++s2) {
      const int id = t.sa_t[g * Ss + s2];
      if (id >= 0 && t.counter_dom[(size_t)id * N + n] >= D) ignored = true;
    }
    bits_s[l] = (feas ? GS_FEAS : 0) | (ignored ? GS_IGN : 0);
    j_s[l] = 0;
  }
  for (size_t i = tid; i < (size_t)Sd * D1; i += CLUSTER_THREADS)
    cnt[i] = t.counter[(size_t)max(t.dns_t[g * Sd + i / D1], 0) * D1 + i % D1];
  for (size_t i = tid; i < (size_t)Ss * D1; i += CLUSTER_THREADS)
    cnt_sa[i] = t.counter[(size_t)max(t.sa_t[g * Ss + i / D1], 0) * D1 + i % D1];
  for (int z = tid; z < Z; z += CLUSTER_THREADS) part[z] = 0.0f;
  if (tid == 0) TERMS_ZERO(s_rescan, t);
  // the words a ScheduleAnyway term's marks can touch: up to its largest
  // domain below D on any node (zones: one word however wide D1 is); with
  // every term's within MARKS_FUSED_MAX, the marks ride round 1
  int wst = Wd;
  if (sa_live) {
    int dm = -1;
    for (int s2 = 0; s2 < Ss; ++s2) {
      const int id = t.sa_t[g * Ss + s2];
      if (id < 0) continue;
      for (int n = tid; n < N; n += CLUSTER_THREADS) {
        const int d = t.counter_dom[(size_t)id * N + n];
        if (d < D) dm = max(dm, d);
      }
    }
    const int r = __reduce_max_sync(FULL_MASK, dm);
    if ((tid & 31) == 0) s_warp[tid >> 5] = r;
    __syncthreads();
    if (tid < 32) {
      const int m = __reduce_max_sync(FULL_MASK, tid < CLUSTER_WARPS ? s_warp[tid] : -1);
      if (tid == 0) s_fin[0] = m;
    }
    __syncthreads();
    if (Ss * mark_words(s_fin[0] + 1) <= MARKS_FUSED_MAX) wst = mark_words(s_fin[0] + 1);
  }
  const bool fused = sa_live && wst * Ss <= MARKS_FUSED_MAX;
  // this CTA's two sets of marks [2][Ss][wst]: its shared memory, or its
  // copy in scratch (the CTAs' copies 2 * Ss * Wd words apart; wst is Wd
  // there)
  uint32_t* mk = fused ? mk_s : mk_g + (size_t)rank * 2 * Ss * Wd;
  if (sa_live)
    for (int i = tid; i < 2 * Ss * wst; i += CLUSTER_THREADS) mk[i] = 0u;
  cluster_barrier_uncounted();
  // the live DoNotSchedule minima, kept level by level: a commit at the
  // level's last eligible domain rescans that term (dns_levels)
  dns_levels(t, g, cnt, TERMS_ALL(t), &pc, s_mn, s_nmin, s_warp);

  int placed = 0, steps = 0, sa_pods = 0;
  for (int p = 0; p < P; ++p) {
    if (!valid[p]) continue;  // padded pod: commits nothing
    ++steps;
    // ---- A: the DoNotSchedule minimum of every valid term is pc.dns_min

    // this pod's bitsets: the other set's clears are ordered before the next
    // marks into it by this pod's mark round barrier
    uint32_t* mkp = mk + (size_t)(sa_pods & 1) * Ss * wst;
    sa_pods += sa_live;

    // ---- B: the feasible set and the normalizer inputs over it
    float mx[5] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float mn_simon = INFINITY, mn_ip = INFINITY;
    int anyF = 0, have_zones = 0;
    for (int base = cx.lo; base < cx.hi; base += CLUSTER_THREADS) {  // uniform trips
      const int n = base + tid;
      int zone_at = -1;
      float pn = 0.0f;
      bool rel = false;
      if (n < cx.hi) {
        const int l = n - cx.lo;
        const int b = bits_s[l];
        bool F = (b & GS_FEAS) && cap_s[l] - j_s[l] > 0;
        for (int s2 = 0; s2 < Sd && F; ++s2) {
          const int id = t.dns_t[g * Sd + s2];
          if (id < 0) continue;
          const int dom = t.counter_dom[(size_t)id * N + n];
          const float at = cnt[(size_t)s2 * D1 + dom];
          F = dom < D
              && at + t.dns_self[g * Sd + s2] - pc.dns_min[s2] <= t.dns_maxskew[g * Sd + s2];
        }
        int fl = b & (GS_FEAS | GS_IGN);
        if (F) {
          anyF = 1;
          fl |= GS_F;
          mx[0] = fmaxf(mx[0], simon_s[l]);
          mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
          mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
          mx[3] = fmaxf(mx[3], ip_s[l]);
          mn_simon = fminf(mn_simon, simon_s[l]);
          mn_ip = fminf(mn_ip, ip_s[l]);
          if (ss_live) {
            pn = pern0_s[l] + (float)j_s[l];
            mx[4] = fmaxf(mx[4], pn);
            const int zone = t.node_zone[n];
            if (zone > 0) have_zones = 1;
            if (zone >= 0 && zone < Z) zone_at = zone;
          }
          if (sa_live && !(b & GS_IGN)) {
            fl |= GS_REL;
            rel = true;
          }
        }
        bits_s[l] = (uint8_t)fl;
      }
      warp_add_at(part, zone_at, pn);
      if (sa_live) {
        for (int s2 = 0; s2 < Ss; ++s2) {
          const int id = t.sa_t[g * Ss + s2];
          const int dom = (rel && id >= 0) ? t.counter_dom[(size_t)id * N + n] : -1;
          warp_mark(mkp + (size_t)s2 * wst, dom, fused);
        }
      }
    }
    // ---- round 1: extrema, anyF, have_zones, zone sums, marks
    {
      int key[K4_KEYS];
      for (int k = 0; k < 5; ++k) key[k] = okey(mx[k]);
      key[5] = okey(mn_simon);
      key[6] = okey(mn_ip);
      key[7] = anyF;
      key[8] = have_zones;
      const unsigned mins = (1u << 5) | (1u << 6);
      // small bitsets ride the round as OR words, large ones as atomic ORs
      const int n_or = fused ? Ss * wst : 0;
      cluster_round_push<K4_KEYS>(cx, key, mins, part, Z, mkp, n_or, s_warp);
      if (sa_live && !fused) cluster_mark_push(cx, mkp, Ss * wst, 2LL * Ss * Wd);
      cluster_round_finish(cx, K4_KEYS, mins, Z, n_or, fin, sa_live && !fused);
    }
    for (int z = tid; z < Z; z += CLUSTER_THREADS) part[z] = 0.0f;  // pushed already
    // nothing feasible: nothing is committed, so no later pod fits either
    if (!fin[7]) break;
    const bool have_zones_b = fin[8];
    for (int k = 0; k < 5; ++k) mx[k] = ounkey(fin[k]);
    mn_simon = ounkey(fin[5]);
    mn_ip = ounkey(fin[6]);
    const float* zone_sums = (const float*)(fin + K4_KEYS);
    float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
    for (int z = 1; z < Z; ++z) maxZ = fmaxf(maxZ, zone_sums[z]);
    const Norms nm = {mx[0], mn_simon, fmaxf(mx[1], 0.0f), fmaxf(mx[2], 0.0f),
                      fmaxf(mx[3], 0.0f), fminf(mn_ip, 0.0f)};
    const float maxN = fmaxf(mx[4], 0.0f);

    // ---- C, D: ScheduleAnyway topology sizes over the relevant feasible
    // set (marks cleared), raw scores and their extrema
    float sa_hi = 0.0f, sa_lo = 0.0f;
    if (sa_live) {
      if (fused)
        fused_topology_weights(fin + K4_KEYS + Z, mkp, Ss, wst, D, pc.tpw);
      else
        cta_topology_weights(mkp, Ss, wst, D, s_warp, pc.tpw);
      float hi = -INFINITY, lo = INFINITY;
      for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
        const int l = n - cx.lo;
        if (!(bits_s[l] & GS_REL)) continue;
        float acc = 0.0f;
        for (int s2 = 0; s2 < Ss; ++s2) {
          const int id = t.sa_t[g * Ss + s2];
          if (id < 0) continue;
          const float c = cnt_sa[(size_t)s2 * D1 + t.counter_dom[(size_t)id * N + n]];
          acc = acc + (c * pc.tpw[s2] + (t.sa_maxskew[g * Ss + s2] - 1.0f));
        }
        const float raw = floorf(acc);
        sa_s[l] = raw;
        hi = fmaxf(hi, raw);
        lo = fminf(lo, raw);
      }
      const int key[2] = {okey(hi), okey(lo)};
      cluster_round<2>(cx, key, 2u, nullptr, 0, s_warp, s_fin);
      sa_hi = fmaxf(ounkey(s_fin[0]), 0.0f);
      const float l2 = ounkey(s_fin[1]);
      sa_lo = isfinite(l2) ? l2 : 0.0f;
    }

    // ---- E: the score and the first-max argmax over F
    float best = -INFINITY;
    int best_i = INT_HI;
    for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
      const int l = n - cx.lo;
      const int fl = bits_s[l];
      if (!(fl & GS_F)) continue;
      // the candidate pod counts toward its own usage, hence j + 1
      const float copies = (float)(j_s[l] + 1);
      float least, bal;
      least_balanced(t.nonzero[(size_t)n * 2 + 0] + gz_c * copies,
                     t.nonzero[(size_t)n * 2 + 1] + gz_m * copies,
                     t.alloc[(size_t)n * R + 0], t.alloc[(size_t)n * R + 1], &least, &bal);
      const float lb = t.w[W_LEAST] * least + t.w[W_BALANCED] * bal;
      float simon, nodeaff, taint, interpod;
      normalized_terms(nm, simon_s[l], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_s[l],
                       &simon, &nodeaff, &taint, &interpod);
      float score = lb + t.w[W_SIMON] * simon + t.w[W_NODEAFF] * nodeaff + t.w[W_TAINT] * taint
                    + t.w[W_INTERPOD] * interpod + stat_s[l];
      if (ss_live) {
        const int zone = t.node_zone[n];
        const float zs = (zone >= 0 && zone < Z) ? zone_sums[zone] : 0.0f;
        const float blend = selector_spread_blend(pern0_s[l] + (float)j_s[l], maxN, zs, maxZ,
                                                  have_zones_b && zone > 0);
        score = score + t.w[W_SS] * floorf(blend);
      }
      if (sa_live) {
        const float pts = (fl & GS_REL) ? sa_normalized(sa_s[l], sa_hi, sa_lo) : 0.0f;
        score = score + t.w[W_PTS] * pts;
      }
      argmax_update(score, n, &best, &best_i);
    }
    const int c = cluster_argmax(cx, best, best_i, s_warp, s_fin);

    // ---- F: commit the pod: j at the owner, every CTA's own live rows (the
    // DoNotSchedule rows from thread 0, the ScheduleAnyway rows from 256, so
    // that their load chains overlap)
    if (tid == CLUSTER_THREADS - 1 && c >= cx.lo && c < cx.hi) j_s[c - cx.lo] += 1;
    for (int s2 = tid; s2 < Sd; s2 += CLUSTER_THREADS) {
      const int id = t.dns_t[g * Sd + s2];
      if (id < 0 || !t.counter_sel_match_g[(size_t)id * t.G + g]) continue;
      const int dom = t.counter_dom[(size_t)id * N + c];
      float* at = &cnt[(size_t)s2 * D1 + dom];
      const float old = *at;
      *at = old + 1.0f;
      // one eligible domain fewer at the minimum; none left: rescan
      if (t.dns_edom[((size_t)g * Sd + s2) * D1 + dom] && old == s_mn[s2] && --s_nmin[s2] == 0)
        TERMS_ADD_ATOMIC(s_rescan, s2);
    }
    if (sa_live) {
      for (int s2 = (tid + CLUSTER_THREADS / 2) % CLUSTER_THREADS; s2 < Ss; s2 += CLUSTER_THREADS) {
        const int id = t.sa_t[g * Ss + s2];
        if (id < 0 || !t.counter_sel_match_g[(size_t)id * t.G + g]) continue;
        const int dom = t.counter_dom[(size_t)id * N + c];
        if (dom < D) cnt_sa[(size_t)s2 * D1 + dom] += 1.0f;
      }
    }
    ++placed;
    __syncthreads();
    const TermSet rescan = s_rescan;
    if (TERMS_ANY(rescan, t)) {
      dns_levels(t, g, cnt, rescan, &pc, s_mn, s_nmin, s_warp);
      if (tid == 0) TERMS_ZERO(s_rescan, t);  // every thread read it before the barriers
    }
  }
  for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) j_out[n] = j_s[n - cx.lo];
  if (rank == 0 && tid == 0) {
    *placed_out = placed;
    if (stats) {
      stats[0] = cx.rounds;
      stats[1] = cx.barriers;
      stats[2] = steps;
    }
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_group_serial_kernel(TablesView t, int g, const uint8_t* valid, int P, int cap1,
                             int ss_live, int sa_live, int* j, int* placed_out, float* fs,
                             long long* stats) {
  schedule_group_serial_body<false>(t, 0, g, valid, P, cap1, ss_live, sa_live, j, placed_out, fs,
                                    stats);
}

// K4 over lanes (JAX probe_group_serial_fanout :2320): cluster s scans lane
// s into its own j row [s, N], placed[s], scratch slice and stats row.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_group_serial_lanes_kernel(TablesView t, int g, const uint8_t* valid, int P, int cap1,
                                   int ss_live, int sa_live, int* j, int* placed_out, float* fs,
                                   long long fs_lane, long long* stats) {
  const int s = blockIdx.x / cluster_ctas();
  schedule_group_serial_body<true>(t, s, g, valid, P, cap1, ss_live, sa_live, j + (size_t)s * t.N,
                                   placed_out + s, fs + s * fs_lane,
                                   stats + STATS_WORDS * s);
}

// ------------------------------------------------------------ C interface --

extern "C" {

// Floats of one lane's K4 scratch, and K4's dynamic shared memory, at C
long long group_serial_scratch_floats(const TablesView* t, int C) {
  return k4_scratch_floats(*t, C);
}

long long group_serial_smem(const TablesView* t, int C) { return k4_smem_bytes(*t, C); }

// cluster_kernel_init (cluster.cuh) of K4's two kernels; schedule.cu
// cluster_kernels_init calls it
int group_serial_init() {
  cudaError_t e = cluster_kernel_init(schedule_group_serial_kernel);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_group_serial_lanes_kernel);
  return (int)e;
}

static bool gs_cluster_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

// One cluster of C CTAs with `smem` bytes each (group_serial_smem; any
// other value is refused). stats [STATS_WORDS] (cluster.cuh).
int schedule_group_serial_launch(const TablesView* t, int g, const uint8_t* valid, int P,
                                 int cap1, int ss_live, int sa_live, int* j, int* placed,
                                 float* fs, long long* stats, int C, long long smem,
                                 cudaStream_t stream) {
  if (!gs_cluster_size_ok(C) || smem != group_serial_smem(t, C)) return (int)cudaErrorInvalidValue;
  return cluster_launch(schedule_group_serial_kernel, C, 1, smem, stream, *t, g, valid, P, cap1,
                        ss_live, sa_live, j, placed, fs, stats);
}

// S lanes, one cluster of C CTAs each: the view is lane 0's with
// `t->active` the [S, N] mask; j [S, N], placed [S], fs S slices of
// group_serial_scratch_floats, stats [S, STATS_WORDS]
int schedule_group_serial_lanes_launch(const TablesView* t, int g, const uint8_t* valid, int P,
                                       int cap1, int ss_live, int sa_live, int S, int* j,
                                       int* placed, float* fs, long long* stats, int C,
                                       long long smem,
                                       cudaStream_t stream) {
  if (!gs_cluster_size_ok(C) || smem != group_serial_smem(t, C)) return (int)cudaErrorInvalidValue;
  return cluster_launch(schedule_group_serial_lanes_kernel, C, S, smem, stream, *t, g, valid, P,
                        cap1, ss_live, sa_live, j, placed, fs, group_serial_scratch_floats(t, C),
                        stats);
}

// Clusters of C CTAs with `smem` bytes that can be resident at once, into
// *out, for the single-lane (lanes 0) or the lane kernel
int group_serial_occupancy(int lanes, int C, long long smem, int* out) {
  if (!gs_cluster_size_ok(C)) return (int)cudaErrorInvalidValue;
  return lanes ? cluster_occupancy_of(schedule_group_serial_lanes_kernel, C, smem, out)
               : cluster_occupancy_of(schedule_group_serial_kernel, C, smem, out);
}

}  // extern "C"
