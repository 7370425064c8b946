// Hand-written Hopper kernel for the serial scheduling route.
//
// K2 schedule_batch_kernel replaces open_simulator_tpu/ops/kernels.py
//    `schedule_batch` (:2265, the lax.scan of `_step` :728): per pod,
//    feasibility, every score plugin, the first-max argmax and the commit
//    into the carry. (K1, the feasibility kernel, is feasibility.cu.)
//
// It takes the GPU-share and Open-Local branches (`enable_gpu`,
// `enable_storage`, runtime flags of the view) with `storage_alloc` (:274)
// as a device function (common.cuh): both masks, the Open-Local min-max
// score over the feasible set, and, at the chosen node, the GPU
// device-ledger and storage commits.
// JAX evaluates storage_alloc three times per step on the same inputs (XLA
// folds them into one); K2 evaluates it once per node in phase B and once
// more at the chosen node in phase F, from the carry before the commit,
// rather than keep an [N, MAXVG] buffer. K2 is built twice (EXT false and
// true); the launcher picks by the flags, so a batch without such demand
// runs the code of the earlier slices.
//
// What bounds it on an H100: K2 is a chain of dependent
// cross-node reductions: each pod needs the previous pod's commit, so the
// pods cannot run in parallel, and each pod's step reads ~100 bytes per node
// through chains of dependent loads, then reduces over every node. It is
// latency bound, far above its byte bound. Design: one persistent
// thread-block cluster of C CTAs (cluster.cuh) loops over the pods inside
// the kernel; CTA r owns a contiguous slice of the node axis, keeps its
// nodes' values of a step in its shared memory from phase B to the argmax,
// and the step's reductions travel in two or three fused cluster rounds
// (see schedule_batch_body). ops/cluster.py chooses C from N, the lane
// count and the occupancy query, so that a thread holds one or two nodes.
//
// K2 over lanes (schedule_batch_lanes_kernel) replaces the three fan-outs
// that vmap schedule_batch over S lanes, each lane with its own node-active
// mask: `probe_serial_fanout` (:2361, one pod stream for every lane),
// `serve_whatif_fanout` (:2383, one union pod stream, a `valid` row per
// lane) and `sweep_whatif_fanout` (:2480, a pod stream per lane). The pod
// arrays carry a lane stride (0 for a shared array, P for a per-lane one),
// so one body serves the three. One cluster per lane, so a round of S lanes
// costs about one single-lane launch while the clusters are resident; see
// common.cuh `lane_view`. An invalid row is a no-op (choice -1, no commit)
// that costs the lane one byte load: a lane does not stop after its last
// valid row.
//
// The exactness contract with the plain PyTorch version is in common.cuh.
// This file also holds the library's C interface helpers.

#include "cluster.cuh"

// ----------------------------------------------------------------- K2 ------

// node flags of one step
#define FL_F 1    // feasible
#define FL_REL 2  // counts for ScheduleAnyway (carries every term's key)
#define K2_KEYS(EXT) ((EXT) ? 11 : 9)

// K2's per-node rows of a CTA: least, balanced, simon, interpod, per-node
// count, ScheduleAnyway raw (and, with EXT, the raw Open-Local score)
// [chunk] f32 and the flags [chunk] u8, padded to 4 bytes. They are the
// first part of its dynamic shared memory when they fit (cluster.cuh
// rows_on_chip), else its slice of scratch.
static __host__ __device__ inline long long k2_rows_bytes(int N, int C, bool ext) {
  const long long chunk = (N + C - 1) / C;
  return 4LL * (ext ? 7 : 6) * chunk + ((chunk + 3) & ~3LL);
}

static __host__ __device__ inline long long k2_rounds_bytes(const TablesView& t, int C, bool ext) {
  return cluster_rounds_bytes(C, K2_KEYS(ext), t.Ss, t.Z, t.D1);
}

// K2's dynamic shared memory at C, the one formula of it (ops/cluster.py
// takes it from here)
static __host__ __device__ inline long long k2_smem_bytes(const TablesView& t, int C, bool ext) {
  return cluster_smem_bytes(k2_rows_bytes(t.N, C, ext), k2_rounds_bytes(t, C, ext));
}

// Floats of one lane's scratch: the counter and carrier rows of ranks 1 to
// C - 1 (rank 0 commits into the carry's own rows), then each CTA's wide
// ScheduleAnyway bitsets (cluster.cuh wide_mark_words), then each CTA's
// per-node rows when they are not on chip
static __host__ __device__ inline long long k2_scratch_floats(const TablesView& t, int C,
                                                              bool ext) {
  const long long rows = k2_rows_bytes(t.N, C, ext);
  return (long long)(C - 1) * (t.T + t.Tc) * t.D1 + wide_mark_words(C, t.Ss, t.D1)
         + (rows_on_chip(rows, k2_rounds_bytes(t, C, ext)) ? 0 : C * rows / 4);
}

// One lane's pod stream on this CTA's cluster. `t_in` is the launch's view
// (lane 0's for the lane kernel, moved to lane s by lane_view).
//
// Per pod, in every CTA: A the pod's scalars (cta_prologue: bootstrap flag
// and DoNotSchedule minima from this CTA's counter rows; CTA barriers
// only); B feasibility and every raw score term of the CTA's nodes, kept in
// its shared memory, with the zone sums and the ScheduleAnyway marks; round
// 1 carries the eight normalizer extrema, anyF, have_zones, the Open-Local
// extrema, the zone sums and the marks; C the ScheduleAnyway weights from
// the marks; D the ScheduleAnyway raw scores and round 2 (only for a group
// with such terms) their extrema; E the total and round 3, the first-max
// argmax; F the commit. That is 2 rounds a pod, 3 with ScheduleAnyway
// terms, 1 for a pod with nothing feasible; each is one exchange over
// distributed shared memory (cluster.cuh), with one cluster barrier more in
// round 1 when the marks are too wide to ride it (MARKS_FUSED_MAX): then
// they go as atomic ORs between the CTAs' copies in global scratch.
//
// Commit and visibility: every node-axis carry row (requested, nonzero,
// port_used, the GPU and storage ledgers) of node c is read only by the
// CTA that owns c, which writes it; the replicated counter and carrier rows
// are kept once per CTA (rank 0 the carry's rows, rank r > 0 a copy in
// scratch made at the start) and every CTA, knowing c, updates its own copy
// identically. So no CTA reads what another writes in global memory, but
// for the wide marks: a CTA barrier orders each commit before the next
// pod's reads, the rounds order only their own words in shared memory, and
// the mark round's cluster barrier (release / acquire at cluster scope,
// global memory included) orders the ORs into a CTA's copy before it counts
// them. A CTA clears its copy of one set after counting it; the next ORs
// into that set come two ScheduleAnyway pods later, after the next pod's
// mark barrier, which the clear precedes.
template <bool EXT, bool LANE>
static __device__ __forceinline__ void
schedule_batch_body(const TablesView& t_in, int s, const int* pod_group, const int* forced_node,
                    const uint8_t* valid_pod, int P, int* choices, float* scratch,
                    long long* stats) {
  constexpr int NK = K2_KEYS(EXT);
  __shared__ TablesView t;
  __shared__ PodCtx pc;
  WARP_WORDS(s_warp);
  __shared__ int s_fin[2];
  __shared__ float* s_src[2];
  __shared__ uint64_t s_mbar[2];
  // 4-byte words: a 16-byte alignment would pad the static shared memory of
  // every kernel of this file
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int C = cluster_ctas(), rank = cluster_rank();
  if (tid == 0) {
    t = LANE ? lane_view(t_in, s) : t_in;
    s_src[0] = t.counter;
    s_src[1] = t.carrier;
    if (rank > 0) {
      t.counter = scratch + (size_t)(rank - 1) * (t.T + t.Tc) * t.D1;
      t.carrier = t.counter + (size_t)t.T * t.D1;
    }
  }
  __syncthreads();
  WARP_BIND(s_warp, t);
  POD_BIND(pc, t);
  const int N = t.N, R = t.R, D1 = t.D1, D = D1 - 1, Z = t.Z, Ss = t.Ss;
  const int chunk = (N + C - 1) / C, Wd = mark_words(D1), W = NK + Z + mark_or_words(Ss, D1);
  const bool fused = !wide_marks(Ss, D1);  // the marks ride round 1
  const long long rows_b = k2_rows_bytes(N, C, EXT);
  const bool on_chip = rows_on_chip(rows_b, k2_rounds_bytes(t, C, EXT));
  // scratch past the counter copies: the CTAs' wide mark copies, the rows
  uint32_t* mk_g = (uint32_t*)(scratch + (size_t)(C - 1) * (t.T + t.Tc) * D1);
  float* rows_g = (float*)(mk_g + wide_mark_words(C, Ss, D1)) + (size_t)rank * (rows_b / 4);
  float* least_s = on_chip ? (float*)smem : rows_g;
  float* bal_s = least_s + chunk;
  float* simon_s = bal_s + chunk;
  float* ip_s = simon_s + chunk;
  float* pern_s = ip_s + chunk;
  float* sa_s = pern_s + chunk;
  float* st_s = sa_s + chunk;  // EXT only
  uint8_t* flags_s = (uint8_t*)(sa_s + (EXT ? 2 : 1) * chunk);
  uint32_t* mk_s = smem + (on_chip ? rows_b / 4 : 0);  // fused marks [2][mark_or_words]
  int* slots = (int*)(mk_s + 2 * mark_or_words(Ss, D1));
  int* fin = slots + 2 * C * W;
  // this CTA's two sets of marks [2][Ss][Wd]: its shared memory, or its
  // copy in scratch (the CTAs' copies 2 * Ss * Wd words apart)
  uint32_t* mk = fused ? mk_s : mk_g + (size_t)rank * 2 * Ss * Wd;
  float* part = (float*)(fin + W);
  if (rank > 0) {  // this CTA's copy of the counter and carrier rows
    for (size_t i = tid; i < (size_t)t.T * D1; i += CLUSTER_THREADS) t.counter[i] = s_src[0][i];
    for (size_t i = tid; i < (size_t)t.Tc * D1; i += CLUSTER_THREADS) t.carrier[i] = s_src[1][i];
  }
  for (int i = tid; i < 2 * Ss * Wd; i += CLUSTER_THREADS) mk[i] = 0u;
  for (int z = tid; z < Z; z += CLUSTER_THREADS) part[z] = 0.0f;
  Cluster cx = cluster_setup(N, W, slots, s_mbar);
  cluster_barrier_uncounted();
  int steps = 0, sa_pods = 0;

  for (int p = 0; p < P; ++p) {
    const int g = pod_group[p], forced = forced_node[p];
    if (!valid_pod[p]) {  // padded pod: feasible nowhere, commits nothing
      if (rank == 0 && tid == 0) choices[p] = -1;
      continue;
    }
    ++steps;
    // ---- A: per-pod scalars
    cta_prologue(t, g, true, t.f_spread ? t.Sd : 0, &pc, s_warp);
    const size_t gN = (size_t)g * N;
    const int ss_id = t.ss_t[g];
    const int ssi = ss_id > 0 ? ss_id : 0;
    bool any_sa = false;
    for (int s2 = 0; s2 < Ss; ++s2) any_sa = any_sa || t.sa_t[g * Ss + s2] >= 0;
    // this ScheduleAnyway pod's bitsets: the other set's clears are ordered
    // before the next marks into it by this pod's mark round barrier
    uint32_t* mkp = mk + (size_t)(sa_pods & 1) * Ss * Wd;
    sa_pods += any_sa;
    bool has_storage = false;
    if (EXT && t.f_storage) {
      for (int s2 = 0; s2 < t.SL; ++s2) has_storage = has_storage || t.grp_lvm_size[(size_t)g * t.SL + s2] > 0.0f;
      for (int s2 = 0; s2 < t.SD; ++s2) has_storage = has_storage || t.grp_sdev_size[(size_t)g * t.SD + s2] > 0.0f;
    }

    // ---- B: per node of this CTA, feasibility and every raw score term
    float mx[5] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float mn_simon = INFINITY, mn_ip = INFINITY, st_hi = -INFINITY, st_lo = INFINITY;
    int anyF = 0, have_zones = 0;
    for (int base = cx.lo; base < cx.hi; base += CLUSTER_THREADS) {  // uniform trips
      const int n = base + tid;
      int zone_at = -1;
      float pn = 0.0f;
      bool rel = false;
      if (n < cx.hi) {
        const int l = n - cx.lo;
        float st_raw = 0.0f;
        const uint32_t bits = node_feasibility<EXT, LANE>(t, &pc, g, forced, 1, 1, 1, n,
                                                          nullptr, &st_raw);
        uint8_t fl = 0;
        if ((bits >> BIT_FEASIBLE) & 1u) {
          anyF = 1;
          if (EXT && t.f_storage) {
            st_s[l] = st_raw;
            st_hi = fmaxf(st_hi, st_raw);
            st_lo = fminf(st_lo, st_raw);
          }
          const float used_c = t.nonzero[(size_t)n * 2 + 0] + t.grp_nonzero[g * 2 + 0];
          const float used_m = t.nonzero[(size_t)n * 2 + 1] + t.grp_nonzero[g * 2 + 1];
          least_balanced(used_c, used_m, t.alloc[(size_t)n * R + 0], t.alloc[(size_t)n * R + 1],
                         &least_s[l], &bal_s[l]);
          const float ss = floorf(100.0f * t.simon_raw[gN + n]);
          simon_s[l] = ss;
          const float ip = interpod_raw_at(t, g, n);
          ip_s[l] = ip;
          pn = t.counter[(size_t)ssi * D1 + t.counter_dom[(size_t)ssi * N + n]];
          pern_s[l] = pn;
          mx[0] = fmaxf(mx[0], ss);
          mx[1] = fmaxf(mx[1], t.nodeaff_raw[gN + n]);
          mx[2] = fmaxf(mx[2], t.taint_raw[gN + n]);
          mx[3] = fmaxf(mx[3], ip);
          mx[4] = fmaxf(mx[4], pn);
          mn_simon = fminf(mn_simon, ss);
          mn_ip = fminf(mn_ip, ip);
          const int zone = t.node_zone[n];
          if (zone > 0) have_zones = 1;
          if (zone >= 0 && zone < Z) zone_at = zone;
          // ScheduleAnyway: a node missing any valid term's key is ignored
          bool ignored = false;
          for (int s2 = 0; s2 < Ss; ++s2) {
            const int id = t.sa_t[g * Ss + s2];
            if (id >= 0 && t.counter_dom[(size_t)id * N + n] >= D) ignored = true;
          }
          fl = FL_F;
          if (!ignored) {
            fl |= FL_REL;
            rel = true;
          }
        }
        flags_s[l] = fl;
      }
      warp_add_at(part, zone_at, pn);
      if (any_sa) {
        for (int s2 = 0; s2 < Ss; ++s2) {
          const int id = t.sa_t[g * Ss + s2];
          const int dom = (rel && id >= 0) ? t.counter_dom[(size_t)id * N + n] : -1;
          warp_mark(mkp + (size_t)s2 * Wd, dom, fused);
        }
      }
    }
    // ---- round 1: extrema, anyF, have_zones, zone sums, marks
    {
      int key[NK];
      for (int k = 0; k < 5; ++k) key[k] = okey(mx[k]);
      key[5] = okey(mn_simon);
      key[6] = okey(mn_ip);
      key[7] = anyF;
      key[8] = have_zones;
      if constexpr (EXT) {
        key[9] = okey(st_hi);
        key[10] = okey(st_lo);
      }
      const unsigned mins = (1u << 5) | (1u << 6) | (EXT ? 1u << 10 : 0u);
      // small bitsets ride the round as OR words, large ones as atomic ORs
      const int n_or = any_sa && fused ? Ss * Wd : 0;
      cluster_round_push<NK>(cx, key, mins, part, Z, mkp, n_or, s_warp);
      if (any_sa && !fused) cluster_mark_push(cx, mkp, Ss * Wd, 2LL * Ss * Wd);
      cluster_round_finish(cx, NK, mins, Z, n_or, fin, any_sa && !fused);
    }
    for (int z = tid; z < Z; z += CLUSTER_THREADS) part[z] = 0.0f;  // pushed already
    if (!fin[7]) {  // nothing feasible: choice -1, commit nothing
      if (rank == 0 && tid == 0) choices[p] = -1;  // no node marked, no zone sum kept
      continue;
    }
    const bool have_zones_b = fin[8];
    for (int k = 0; k < 5; ++k) mx[k] = ounkey(fin[k]);
    mn_simon = ounkey(fin[5]);
    mn_ip = ounkey(fin[6]);
    const float* zone_sums = (const float*)(fin + NK);
    float maxZ = 0.0f;  // max(zone_sums with [0] set to 0)
    for (int z = 1; z < Z; ++z) maxZ = fmaxf(maxZ, zone_sums[z]);
    const Norms nm = {mx[0], mn_simon, fmaxf(mx[1], 0.0f), fmaxf(mx[2], 0.0f),
                      fmaxf(mx[3], 0.0f), fminf(mn_ip, 0.0f)};
    const float maxN = fmaxf(mx[4], 0.0f);
    // Open-Local normalizer: max(max_F raw, 0) and min_F raw (F is not empty)
    float st_rng = 0.0f;
    if (EXT && t.f_storage) {
      const float lo = ounkey(fin[10]);
      st_lo = isfinite(lo) ? lo : 0.0f;
      st_rng = fmaxf(ounkey(fin[9]), 0.0f) - st_lo;
    }

    // ---- C: topology sizes of the ScheduleAnyway terms (marked domains,
    // sentinel excluded), then D: their raw scores and extrema over the
    // relevant feasible set
    float sa_hi = 0.0f, sa_lo = 0.0f;
    if (any_sa) {
      if (fused)
        fused_topology_weights(fin + NK + Z, mkp, Ss, Wd, D, pc.tpw);
      else
        cta_topology_weights(mkp, Ss, Wd, D, s_warp, pc.tpw);
      float hi = -INFINITY, lo = INFINITY;
      for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
        const int l = n - cx.lo;
        if (!(flags_s[l] & FL_REL)) continue;
        float acc = 0.0f;
        for (int s2 = 0; s2 < Ss; ++s2) {
          const int id = t.sa_t[g * Ss + s2];
          if (id < 0) continue;
          const float cnt = t.counter[(size_t)id * D1 + t.counter_dom[(size_t)id * N + n]];
          acc = acc + (cnt * pc.tpw[s2] + (t.sa_maxskew[g * Ss + s2] - 1.0f));
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

    // ---- E: normalized components, total in COMPONENT_ORDER, first-max argmax
    const bool has_ss = ss_id >= 0, ss_skip = t.ss_skip[g];
    float best = -INFINITY;
    int best_i = INT_HI;
    for (int n = cx.lo + tid; n < cx.hi; n += CLUSTER_THREADS) {
      const int l = n - cx.lo;
      const uint8_t fl = flags_s[l];
      if (!fl) continue;  // infeasible: masked to -inf
      float simon, nodeaff, taint, interpod;
      normalized_terms(nm, simon_s[l], t.nodeaff_raw[gN + n], t.taint_raw[gN + n], ip_s[l],
                       &simon, &nodeaff, &taint, &interpod);
      const int zone = t.node_zone[n];
      const float zs = (zone >= 0 && zone < Z) ? zone_sums[zone] : 0.0f;
      const float blended = selector_spread_blend(pern_s[l], maxN, zs, maxZ,
                                                  have_zones_b && zone > 0);
      const float selector_spread = ss_skip ? 0.0f : (has_ss ? floorf(blended) : 100.0f);
      // without ScheduleAnyway terms sa_hi is 0: every relevant node scores 100
      const float pts = (fl & FL_REL) ? sa_normalized(any_sa ? sa_s[l] : 0.0f, sa_hi, sa_lo)
                                      : 0.0f;
      float total = t.w[W_LEAST] * least_s[l];
      total = total + t.w[W_BALANCED] * bal_s[l];
      const float openlocal = (EXT && has_storage && st_rng > 0.0f)
                                  ? floorf((st_s[l] - st_lo) * 100.0f / st_rng) : 0.0f;
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
    const int c = cluster_argmax(cx, best, best_i, s_warp, s_fin);

    // ---- F: commit at c (kernels.py:677-723): the owner's node rows, and
    // every CTA's own counter and carrier rows; the three run on disjoint
    // threads (from 384, 0 and 256), so their load chains overlap
    const int own = (tid + CLUSTER_THREADS / 4) % CLUSTER_THREADS;
    const int car = (tid + CLUSTER_THREADS / 2) % CLUSTER_THREADS;
    if (c >= cx.lo && c < cx.hi) {
      for (int r = own; r < R; r += CLUSTER_THREADS)
        t.requested[(size_t)c * R + r] += t.grp_requests[(size_t)g * R + r];
      if (own < 2) t.nonzero[(size_t)c * 2 + own] += t.grp_nonzero[g * 2 + own];
      for (int k = own; k < t.PP; k += CLUSTER_THREADS) {
        const int pid = t.grp_ports[g * t.PP + k];
        if (pid > 0) t.port_used[(size_t)c * t.PORT1 + pid] = 1;
      }
      if (own == 0) {
        if constexpr (EXT) {
          // the device ledgers at c: one node, a few devices, one thread
          if (t.f_gpu) gpu_commit_at(t, g, c);
          if (t.f_storage) storage_commit_at(t, g, c);
        }
        choices[p] = c;
      }
    }
    for (int r = tid; r < t.T; r += CLUSTER_THREADS) {
      const int dom = t.counter_dom[(size_t)r * N + c];
      if (dom < D && t.counter_sel_match_g[(size_t)r * t.G + g])
        t.counter[(size_t)r * D1 + dom] += 1.0f;
    }
    for (int r = car; r < t.Tc; r += CLUSTER_THREADS) {
      const int dom = t.carr_dom[(size_t)r * N + c];
      if (dom < D) t.carrier[(size_t)r * D1 + dom] += t.grp_carries[(size_t)g * t.Tc + r];
    }
    __syncthreads();
  }
  if (rank == 0 && tid == 0 && stats) {
    stats[0] = cx.rounds;
    stats[1] = cx.barriers;
    stats[2] = steps;
  }
  cluster_barrier_uncounted();  // no CTA leaves with its stores into another in flight
}

template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_batch_kernel(TablesView t, const int* pod_group, const int* forced_node,
                      const uint8_t* valid_pod, int P, int* choices, float* scratch,
                      long long* stats) {
  schedule_batch_body<EXT, false>(t, 0, pod_group, forced_node, valid_pod, P, choices, scratch,
                                  stats);
}

// K2 over lanes: cluster s (CTAs s * C to s * C + C - 1) scans lane s's pod
// rows (pod_group and forced_node at lane stride pod_lane, valid at
// valid_lane: 0 or P) into its own carry slice, choices row [s, P], scratch
// slice and stats row.
template <bool EXT>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
schedule_batch_lanes_kernel(TablesView t, const int* pod_group, const int* forced_node,
                            const uint8_t* valid_pod, int P, long long pod_lane,
                            long long valid_lane, int* choices, float* scratch,
                            long long scratch_lane, long long* stats) {
  const int s = blockIdx.x / cluster_ctas();
  schedule_batch_body<EXT, true>(t, s, pod_group + s * pod_lane, forced_node + s * pod_lane,
                                 valid_pod + s * valid_lane, P, choices + (size_t)s * P,
                                 scratch + s * scratch_lane, stats + STATS_WORDS * s);
}

// The latency floor of the rounds, with no node work: `rounds` times two
// rounds of K2's phase-B shape (K2_KEYS(false) keys and Z partial sums).
// mode 0: one fused round and one argmax round (the pod step's pair);
// otherwise two cluster barriers (what a mark round too wide to ride round
// 1 adds).
// out[0] keeps the results live.
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
cluster_round_probe_kernel(int rounds, int Z, int mode, int* out) {
  constexpr int NK = K2_KEYS(false);
  __shared__ int s_warp[(MAX_SLOTS + 1) * CLUSTER_WARPS];
  __shared__ int s_fin[2];
  __shared__ uint64_t s_mbar[2];
  // 4-byte words: a 16-byte alignment would pad the static shared memory of
  // every kernel of this file
  extern __shared__ uint32_t smem[];
  const int C = cluster_ctas(), W = NK + Z;
  int* slots = (int*)smem;
  int* fin = slots + 2 * C * W;
  float* part = (float*)(fin + W);
  for (int z = threadIdx.x; z < Z; z += CLUSTER_THREADS) part[z] = 1.0f;
  Cluster cx = cluster_setup(C * CLUSTER_THREADS, W, slots, s_mbar);
  cluster_barrier_uncounted();
  int acc = 0;
  for (int i = 0; i < rounds; ++i) {
    int key[NK];
    for (int k = 0; k < NK; ++k) key[k] = okey((float)((threadIdx.x * 7 + i + k) & 1023));
    if (mode == 0) {
      cluster_round<NK>(cx, key, 0x60u, part, Z, s_warp, fin);
      acc += cluster_argmax(cx, (float)(fin[0] & 255), cx.lo + (int)threadIdx.x, s_warp, s_fin);
    } else {
      cluster_barrier(cx);
      cluster_barrier(cx);
    }
  }
  if (cx.rank == 0 && threadIdx.x == 0) out[0] = acc;
  cluster_barrier_uncounted();
}

// ------------------------------------------------------------ C interface --

extern "C" {

int tables_view_size() { return (int)sizeof(TablesView); }

// 1 in the wide build (common.cuh OSIM_WIDE), else 0
int wide_build() { return OSIM_WIDE; }

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Floats of one lane's K2 scratch, and K2's dynamic shared memory, at C
long long schedule_scratch_floats(const TablesView* t, int C) {
  return k2_scratch_floats(*t, C, t->f_gpu || t->f_storage);
}

long long schedule_batch_smem(const TablesView* t, int C) {
  return k2_smem_bytes(*t, C, t->f_gpu || t->f_storage);
}

static bool cluster_size_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == 16; }

// One cluster of C CTAs with `smem` bytes each (schedule_batch_smem; any
// other value is refused). stats [STATS_WORDS] (cluster.cuh).
int schedule_batch_launch(const TablesView* t, const int* pod_group, const int* forced_node,
                          const uint8_t* valid, int P, int* choices, float* scratch,
                          long long* stats,
                          int C, long long smem, cudaStream_t stream) {
  if (!cluster_size_ok(C) || smem != schedule_batch_smem(t, C)) return (int)cudaErrorInvalidValue;
  if (t->f_gpu || t->f_storage)
    return cluster_launch(schedule_batch_kernel<true>, C, 1, smem, stream, *t, pod_group,
                          forced_node, valid, P, choices, scratch, stats);
  return cluster_launch(schedule_batch_kernel<false>, C, 1, smem, stream, *t, pod_group,
                        forced_node, valid, P, choices, scratch, stats);
}

// S lanes, one cluster of C CTAs each: the view is lane 0's, `t->active`
// the [S, N] mask; the pod arrays at lane strides pod_lane / valid_lane (0:
// shared, P: per lane); scratch holds S slices of schedule_scratch_floats,
// choices [S, P], stats [S, STATS_WORDS]
int schedule_batch_lanes_launch(const TablesView* t, const int* pod_group, const int* forced_node,
                                const uint8_t* valid, int P, long long pod_lane,
                                long long valid_lane, int S, int* choices, float* scratch,
                                long long* stats, int C, long long smem, cudaStream_t stream) {
  if (!cluster_size_ok(C) || smem != schedule_batch_smem(t, C)) return (int)cudaErrorInvalidValue;
  const long long lane = schedule_scratch_floats(t, C);
  if (t->f_gpu || t->f_storage)
    return cluster_launch(schedule_batch_lanes_kernel<true>, C, S, smem, stream, *t, pod_group,
                          forced_node, valid, P, pod_lane, valid_lane, choices, scratch, lane,
                          stats);
  return cluster_launch(schedule_batch_lanes_kernel<false>, C, S, smem, stream, *t, pod_group,
                        forced_node, valid, P, pod_lane, valid_lane, choices, scratch, lane,
                        stats);
}

// Clusters of C CTAs with `smem` bytes that can be resident at once, into
// *out, for the single-lane (lanes 0) or the lane kernel
int schedule_batch_occupancy(int lanes, int ext, int C, long long smem, int* out) {
  if (!cluster_size_ok(C)) return (int)cudaErrorInvalidValue;
  if (lanes)
    return ext ? cluster_occupancy_of(schedule_batch_lanes_kernel<true>, C, smem, out)
               : cluster_occupancy_of(schedule_batch_lanes_kernel<false>, C, smem, out);
  return ext ? cluster_occupancy_of(schedule_batch_kernel<true>, C, smem, out)
             : cluster_occupancy_of(schedule_batch_kernel<false>, C, smem, out);
}

// Allow every cluster kernel (K2, K3, K4, K5, the round probe) clusters of 16 and
// CLUSTER_SMEM_MAX bytes of dynamic shared memory; once per device.
int group_serial_init();  // group_serial.cu
int wave_cluster_init();  // wave.cu
int affinity_cluster_init();  // affinity_wave.cu

int cluster_kernels_init() {
  cudaError_t e = cluster_kernel_init(schedule_batch_kernel<false>);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_batch_kernel<true>);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_batch_lanes_kernel<false>);
  if (e == cudaSuccess) e = cluster_kernel_init(schedule_batch_lanes_kernel<true>);
  if (e == cudaSuccess) e = cluster_kernel_init(cluster_round_probe_kernel);
  if (e == cudaSuccess) e = (cudaError_t)group_serial_init();
  if (e == cudaSuccess) e = (cudaError_t)wave_cluster_init();
  return e == cudaSuccess ? affinity_cluster_init() : (int)e;
}

// cluster_round_probe_kernel on one cluster of C CTAs
long long cluster_round_probe_smem(int C, int Z) {
  const long long W = K2_KEYS(false) + Z;
  return 4LL * (2 * C * W + W + Z);
}

int cluster_round_probe_launch(int C, int rounds, int Z, int mode, int* out,
                               cudaStream_t stream) {
  if (!cluster_size_ok(C)) return (int)cudaErrorInvalidValue;
  return cluster_launch(cluster_round_probe_kernel, C, 1, cluster_round_probe_smem(C, Z), stream,
                        rounds, Z, mode, out);
}

}  // extern "C"
