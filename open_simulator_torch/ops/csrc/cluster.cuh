// Device code of the cluster kernels K2 (schedule.cu) and K4
// (group_serial.cu): one lane's pod stream runs on a thread-block cluster of
// C CTAs (C in 1, 2, 4, 8, 16), CTA r owning the contiguous node slice
// [r * chunk, (r + 1) * chunk) with chunk = ceil(N / C), so that each thread
// holds one or two nodes of a pod step instead of N / 1,024.
//
// A pod step's cross-node values are maxima, minima, integer-valued sums,
// marks and a first-max (value, node) pair, all exact in any grouping. They
// travel in fused rounds (cluster_round_push / cluster_round_finish):
//   1. each warp reduces its keys with one redux.sync per key (floats as
//      order-preserving integer keys, okey);
//   2. a CTA barrier; the CTA's warps reduce the warp partials and push
//      them, with the CTA's partial sums, into slot [parity][rank] of every
//      CTA's shared memory (distributed shared memory, st.async), each
//      store completing its bytes on the receiver's mbarrier;
//   3. every thread waits on its CTA's mbarrier until all C slots have
//      arrived (Cluster: why two buffers suffice);
//   4. each CTA combines the C slots (keys by redux, sums in rank order)
//      into `fin`, then a CTA barrier.
// A round waits for data, not for the other CTAs' progress, and its wait
// acquires at CTA scope only: a cluster barrier takes ~0.7 µs on an H100,
// and with one per round a pod's phase B also ran ~1.4 µs slower (PERF.md).
// The ScheduleAnyway marks ride round 1 as OR-combined words when they fit
// MARKS_FUSED_MAX; wider ones (hostname domains) live in global scratch, one
// copy a CTA, and travel as atomic ORs into the other CTAs' copies, ordered
// by one cluster barrier (barrier.cluster.arrive / wait: release / acquire
// at cluster scope, which covers global memory) in that round.
//
// Memory: a CTA keeps its nodes' per-node rows in its shared memory when
// they fit CLUSTER_SMEM_MAX with the rounds' words (cluster_smem_bytes);
// otherwise (above about 120,000 nodes at C 16) the same rows live in the
// CTA's slice of global scratch, read back only by the thread that wrote
// them. Nothing else of a CTA's shared memory grows with N or with the
// domain axis.
//
// Exactness: the same contract as common.cuh. okey maps an f32 to an i32
// whose signed order is the float order, so a redux max or min returns one
// of the inputs bit for bit (NaN never occurs in these rows). Zone sums and
// mark counts are integer-valued and below 2^24, exact in any order; the
// argmax keeps the smallest node among equal values, JAX's first-max.

#pragma once

#include "common.cuh"

// Threads of one CTA of K2 / K4: 512 leave each thread 128 registers (the
// measured choice; PERF.md).
#define CLUSTER_THREADS 512
#define CLUSTER_WARPS (CLUSTER_THREADS / 32)
#define INT_LO ((int)0x80000000)
#define INT_HI 0x7fffffff

// f32 -> i32 whose signed order is the float order, and back
static __device__ __forceinline__ int okey(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ INT_HI;
}
static __device__ __forceinline__ float ounkey(int k) {
  return __int_as_float(k >= 0 ? k : k ^ INT_HI);
}

static __device__ __forceinline__ int redux(int x, bool mn) {
  return mn ? __reduce_min_sync(FULL_MASK, x) : __reduce_max_sync(FULL_MASK, x);
}

// Words of one term's domain bitset
static __host__ __device__ __forceinline__ int mark_words(int D1) { return (D1 + 31) / 32; }

// When every ScheduleAnyway term's marks fit this many words, they ride
// round 1 as OR-combined words from the CTA's shared memory; larger
// bitsets (hostname domains) live in global scratch and travel as atomic
// ORs ordered by a cluster barrier (cluster_mark_push). A slot keeps room
// for mark_or_words of them.
#define MARKS_FUSED_MAX 64
static __host__ __device__ __forceinline__ int mark_or_words(int Ss, int D1) {
  return min(Ss * mark_words(D1), MARKS_FUSED_MAX);
}

// Whether the ScheduleAnyway bitsets can be too wide to ride round 1: then
// each CTA keeps two sets [2][Ss][mark_words(D1)] in global scratch
static __host__ __device__ __forceinline__ bool wide_marks(int Ss, int D1) {
  return Ss * mark_words(D1) > MARKS_FUSED_MAX;
}
static __host__ __device__ __forceinline__ long long wide_mark_words(int C, int Ss, int D1) {
  return wide_marks(Ss, D1) ? 2LL * C * Ss * mark_words(D1) : 0;
}

// The dynamic shared memory a CTA may ask for: the card's 227 KB less room
// for the kernels' static shared memory (ops/cluster.py SMEM_MAX)
#define CLUSTER_SMEM_MAX (232448 - 8192)

// The bytes of a CTA's shared memory besides its per-node rows: two sets
// of fused marks [2][mark_or_words], the round slots [2][C][W], fin [W] and
// the zone partial sums [Z], W = keys + Z + mark_or_words
static __host__ __device__ __forceinline__ long long cluster_rounds_bytes(int C, int keys, int Ss,
                                                                          int Z, int D1) {
  const long long m = mark_or_words(Ss, D1), W = keys + Z + m;
  return 8LL * m + 4LL * (2 * C * W + W + Z);
}

// The per-node rows (`rows` bytes a CTA) stay on chip when they fit with
// the rest; otherwise they live in global scratch
static __host__ __device__ __forceinline__ bool rows_on_chip(long long rows, long long rounds) {
  return rows + rounds <= CLUSTER_SMEM_MAX;
}
static __host__ __device__ __forceinline__ long long cluster_smem_bytes(long long rows,
                                                                        long long rounds) {
  return (rows_on_chip(rows, rounds) ? rows : 0) + rounds;
}

// A lane's stats (long long): rounds, cluster barriers, pods stepped
#define STATS_WORDS 3

// ---- cluster, distributed shared memory and mbarrier primitives (PTX, sm_90)

// This CTA's rank in its cluster, and the cluster's CTAs
static __device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
static __device__ __forceinline__ int cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of the same variable in CTA `rank`
static __device__ __forceinline__ uint32_t at_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Store v at `dst` of another CTA's shared memory; on arrival its 4 bytes
// complete a transaction on that CTA's mbarrier `mbar`.
static __device__ __forceinline__ void st_async(uint32_t dst, int v, uint32_t mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(dst), "r"(v), "r"(mbar) : "memory");
}

static __device__ __forceinline__ void mbar_init(uint32_t mbar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(mbar), "r"(count) : "memory");
}

// The local arrival of a phase that also awaits `bytes` of transactions
static __device__ __forceinline__ void mbar_arrive_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  asm volatile("{\n\t.reg .pred P1;\n"
               "WAIT:\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
               "@!P1 bra WAIT;\n"
               "}\n" :: "r"(mbar), "r"(parity) : "memory");
}

// One CTA's place in its cluster and the round state, uniform over the CTA.
//
// A round's pushes are st.async stores into slot [parity][rank] of every
// CTA, each completing its bytes on that CTA's mbarrier [parity]; the
// receiver's thread 0 arms the mbarrier with the round's C x words x 4
// bytes and every thread waits on its phase. So a round is one cluster-wide
// exchange without a cluster barrier: no CTA waits for more than the words
// it reads. The slots and mbarriers alternate by round: a CTA can push
// round i + 2 into buffer i % 2 only after its wait of round i + 1, which
// needs every CTA's round i + 1 push, which each CTA makes after it has
// read round i's slots.
struct Cluster {
  int rank, C;       // this CTA's rank, the cluster's CTAs
  int lo, hi;        // the node slice this CTA owns
  int W;             // words of one rank's slot
  int parity;        // slot buffer and mbarrier of the next round
  unsigned phases;   // bit b: the phase parity mbarrier b completes next
  int rounds;        // rounds made
  int barriers;      // cluster barriers passed (mark rounds)
  int* slots;        // [2][C][W], this CTA's shared memory
  uint32_t slots_a;  // its shared::cta address
  uint32_t mbar_a;   // the address of this CTA's two mbarriers
};

static __device__ __forceinline__ void cluster_barrier_uncounted() {
  // arrive: release; wait: acquire (the instructions' default semantics)
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;\n" ::: "memory");
}

// A mark round's cluster barrier, counted in cx.barriers
static __device__ __forceinline__ void cluster_barrier(Cluster& cx) {
  cluster_barrier_uncounted();
  ++cx.barriers;
}

// The CTA's slice of N nodes; `slots` its [2][C][W] words and `mbar` its two
// mbarriers (8-byte aligned shared memory), which thread 0 initializes. The
// caller passes a cluster barrier (cluster_barrier_uncounted) before the
// first round: after it every CTA of the cluster has started and made its
// mbarriers visible, the rule before any distributed shared memory access.
static __device__ Cluster cluster_setup(int N, int W, int* slots, uint64_t* mbar) {
  Cluster cx;
  cx.C = cluster_ctas();
  cx.rank = cluster_rank();
  const int chunk = (N + cx.C - 1) / cx.C;
  cx.lo = min(N, cx.rank * chunk);
  cx.hi = min(N, cx.lo + chunk);
  cx.W = W;
  cx.parity = 0;
  cx.phases = 0u;
  cx.rounds = 0;
  cx.barriers = 0;
  cx.slots = slots;
  cx.slots_a = smem_u32(slots);
  cx.mbar_a = smem_u32(mbar);
  if (threadIdx.x == 0) {
    mbar_init(cx.mbar_a, 1);
    mbar_init(cx.mbar_a + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return cx;
}

// Thread 0 arms this round's mbarrier for `words` from every CTA.
static __device__ __forceinline__ void round_arm(const Cluster& cx, int words) {
  if (threadIdx.x == 0) mbar_arrive_expect(cx.mbar_a + 8 * cx.parity, (uint32_t)(cx.C * words * 4));
}

// Lane l < C pushes word k of this CTA's slot, v, to CTA l.
static __device__ __forceinline__ void round_put(const Cluster& cx, int k, int v) {
  const int lane = threadIdx.x & 31;
  if (lane < cx.C)
    st_async(at_rank(cx.slots_a + 4 * ((cx.parity * cx.C + cx.rank) * cx.W + k), lane), v,
             at_rank(cx.mbar_a + 8 * cx.parity, lane));
}

// Every thread waits until every CTA's words of this round have arrived;
// returns this round's slots [C][W].
static __device__ __forceinline__ const int* round_wait(Cluster& cx) {
  mbar_wait(cx.mbar_a + 8 * cx.parity, (cx.phases >> cx.parity) & 1u);
  const int* src = cx.slots + cx.parity * cx.C * cx.W;
  cx.phases ^= 1u << cx.parity;
  cx.parity ^= 1;
  ++cx.rounds;
  return src;
}

// Round, first half: warp-reduce NK keys (bit k of `min_mask`: a minimum,
// else a maximum), a CTA barrier, then push the CTA's keys, its `ne`
// partial sums `part` and its `n_or` words `ors` to OR (both in this CTA's
// shared memory, written before the call) to every CTA. `s_warp` holds NK *
// CLUSTER_WARPS. The caller may push marks (cluster_mark_push) before
// finishing.
template <int NK>
static __device__ void cluster_round_push(Cluster& cx, const int (&key)[NK], unsigned min_mask,
                                          const float* part, int ne, const uint32_t* ors,
                                          int n_or, int* s_warp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  round_arm(cx, NK + ne + n_or);
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int r = redux(key[k], (min_mask >> k) & 1u);
    if (lane == 0) s_warp[k * CLUSTER_WARPS + wid] = r;
  }
  __syncthreads();
  for (int k = wid; k < NK + ne + n_or; k += CLUSTER_WARPS) {
    int val;
    if (k < NK) {
      const bool mn = (min_mask >> k) & 1u;
      val = redux(lane < CLUSTER_WARPS ? s_warp[k * CLUSTER_WARPS + lane] : (mn ? INT_HI : INT_LO),
                  mn);
    } else if (k < NK + ne) {
      val = __float_as_int(part[k - NK]);
    } else {
      val = (int)ors[k - NK - ne];
    }
    round_put(cx, k, val);
  }
}

// Round, second half: with `marks`, a cluster barrier (it orders the mark
// pushes); then the wait, fin[0, nk + ne + n_or) = the cluster's keys,
// sums (as f32 bits) and ORs, and a CTA barrier.
static __device__ void cluster_round_finish(Cluster& cx, int nk, unsigned min_mask, int ne,
                                            int n_or, int* fin, bool marks = false) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (marks) cluster_barrier(cx);
  const int W = cx.W;
  const int* src = round_wait(cx);
  for (int k = wid; k < nk + ne + n_or; k += CLUSTER_WARPS) {
    if (k >= nk + ne) {
      const unsigned r =
          __reduce_or_sync(FULL_MASK, lane < cx.C ? (unsigned)src[lane * W + k] : 0u);
      if (lane == 0) fin[k] = (int)r;
    } else if (k < nk) {
      const bool mn = (min_mask >> k) & 1u;
      const int r = redux(lane < cx.C ? src[lane * W + k] : (mn ? INT_HI : INT_LO), mn);
      if (lane == 0) fin[k] = r;
    } else if (lane == 0) {
      float acc = 0.0f;  // integer-valued partials, added in rank order
      for (int r = 0; r < cx.C; ++r) acc = acc + __int_as_float(src[r * W + k]);
      fin[k] = __float_as_int(acc);
    }
  }
  __syncthreads();
}

template <int NK>
static __device__ void cluster_round(Cluster& cx, const int (&key)[NK], unsigned min_mask,
                                     const float* part, int ne, int* s_warp, int* fin) {
  cluster_round_push<NK>(cx, key, min_mask, part, ne, nullptr, 0, s_warp);
  cluster_round_finish(cx, NK, min_mask, ne, 0, fin);
}

// The first-max argmax over the cluster (value desc, node asc) of each
// thread's (best, best_i); every thread returns the winning node. One round.
static __device__ int cluster_argmax(Cluster& cx, float best, int best_i, int* s_warp, int* fin) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  round_arm(cx, 2);
  const int k = okey(best);
  const int km = __reduce_max_sync(FULL_MASK, k);
  const int im = __reduce_min_sync(FULL_MASK, k == km ? best_i : INT_HI);
  if (lane == 0) {
    s_warp[wid] = km;
    s_warp[CLUSTER_WARPS + wid] = im;
  }
  __syncthreads();
  if (wid == 0) {
    const int x = lane < CLUSTER_WARPS ? s_warp[lane] : INT_LO;
    const int m = __reduce_max_sync(FULL_MASK, x);
    const int i = __reduce_min_sync(
        FULL_MASK, (lane < CLUSTER_WARPS && x == m) ? s_warp[CLUSTER_WARPS + lane] : INT_HI);
    round_put(cx, 0, m);
    round_put(cx, 1, i);
  }
  const int W = cx.W;
  const int* src = round_wait(cx);
  if (wid == 0) {
    const int x = lane < cx.C ? src[lane * W] : INT_LO;
    const int m = __reduce_max_sync(FULL_MASK, x);
    const int i = __reduce_min_sync(FULL_MASK, (lane < cx.C && x == m) ? src[lane * W + 1]
                                                                       : INT_HI);
    if (lane == 0) fin[0] = i;
  }
  __syncthreads();
  return fin[0];
}

// Warp-aggregated integer-valued sum into this CTA's shared `sums[z]`:
// lanes with equal z (z < 0: none) add once, through their lowest lane.
// Every lane of the warp must call it.
static __device__ __forceinline__ void warp_add_at(float* sums, int z, float v) {
  const unsigned peers = __match_any_sync(FULL_MASK, z);
  const int tot = __reduce_add_sync(peers, (int)v);  // integer counts: exact
  if (z >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&sums[z], (float)tot);
}

// Warp-aggregated mark of domain `dom` in this CTA's bitset `bits` (dom < 0:
// none): shared memory (`shared`, where a word already holding the bits is
// not written again) or global scratch. Every lane of the warp must call it.
static __device__ __forceinline__ void warp_mark(uint32_t* bits, int dom, bool shared) {
  const int w = dom < 0 ? -1 : dom >> 5;
  const unsigned peers = __match_any_sync(FULL_MASK, w);
  const unsigned b = __reduce_or_sync(peers, dom < 0 ? 0u : 1u << (dom & 31));
  if (w >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1 && !(shared && (bits[w] & b) == b))
    atomicOr(&bits[w], b);
}

// Push this CTA's nonzero mark words (n_words of its global copy `bits`)
// into every other CTA's copy (`stride` words apart, rank order), between
// cluster_round_push and cluster_round_finish: after the round's cluster
// barrier each CTA's copy holds the cluster's union. The words are read
// past L1 (ld.global.cg): the other CTAs' ORs land in L2.
static __device__ void cluster_mark_push(const Cluster& cx, uint32_t* bits, int n_words,
                                         long long stride) {
  if (cx.C == 1) return;
  for (int w = threadIdx.x; w < n_words; w += CLUSTER_THREADS) {
    const uint32_t v = __ldcg(&bits[w]);
    if (!v) continue;
    for (int r = 0; r < cx.C; ++r)
      if (r != cx.rank) atomicOr(&bits[(r - cx.rank) * stride + w], v);
  }
}

// After the round's cluster barrier: the ScheduleAnyway weight of each of
// the `n_terms` bitsets (each `wpt` words) of this CTA's global copy `bits`,
// ln(count of marked domains d < D + 2) as topology_weight takes it, into
// tpw[s]; clears the copy. Two CTA barriers; `s_warp` holds n_terms *
// CLUSTER_WARPS ints.
static __device__ void cta_topology_weights(uint32_t* bits, int n_terms, int wpt, int D,
                                            int* s_warp, float* tpw) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int s = 0; s < n_terms; ++s) {
    int cnt = 0;
    for (int w = threadIdx.x; w < wpt; w += CLUSTER_THREADS) {
      uint32_t v = __ldcg(&bits[(size_t)s * wpt + w]);
      const int first = w * 32;
      if (first + 32 > D) v &= first >= D ? 0u : (1u << (D - first)) - 1u;  // the sentinel
      cnt += __popc(v);
      bits[(size_t)s * wpt + w] = 0u;
    }
    const int r = __reduce_add_sync(FULL_MASK, cnt);
    if (lane == 0) s_warp[s * CLUSTER_WARPS + wid] = r;
  }
  __syncthreads();
  for (int s = wid; s < n_terms; s += CLUSTER_WARPS) {
    const int r =
        __reduce_add_sync(FULL_MASK, lane < CLUSTER_WARPS ? s_warp[s * CLUSTER_WARPS + lane] : 0);
    if (lane == 0) tpw[s] = topology_weight((float)r);
  }
  __syncthreads();
}

// After a round that carried the marks as OR-combined words `ors` (the
// cluster's union, n_terms bitsets of `wpt` words): tpw[s] as in
// cta_topology_weights, and this CTA's bitsets `bits` cleared. One CTA
// barrier.
static __device__ void fused_topology_weights(const int* ors, uint32_t* bits, int n_terms,
                                              int wpt, int D, float* tpw) {
  for (int s = threadIdx.x; s < n_terms; s += CLUSTER_THREADS) {
    int cnt = 0;
    for (int w = 0; w < wpt; ++w) {
      uint32_t v = (uint32_t)ors[s * wpt + w];
      const int first = w * 32;
      if (first + 32 > D) v &= first >= D ? 0u : (1u << (D - first)) - 1u;  // the sentinel
      cnt += __popc(v);
    }
    tpw[s] = topology_weight((float)cnt);
  }
  for (int w = threadIdx.x; w < n_terms * wpt; w += CLUSTER_THREADS) bits[w] = 0u;
  __syncthreads();
}

// pod_prologue (common.cuh) in one pass of CTA barriers: the bootstrap flag
// of required affinity (with `boot`) and the minimum over its eligible
// domains of each of the first n_dns DoNotSchedule terms, from the counter
// rows. Every thread of the CTA calls it; `s_warp` holds (n_dns + 1) *
// CLUSTER_WARPS ints (WARP_WORDS). Ends with a CTA barrier, except when there is
// nothing to reduce: then every thread writes the same `bootstrap` 0 (the
// previous readers of `pc` passed a barrier since).
static __device__ void cta_prologue(const TablesView& t, int g, bool boot, int n_dns, PodCtx* pc,
                                    int* s_warp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int D = t.D1 - 1, Sd = t.Sd;
  const bool need_boot = boot && t.f_interpod && t.grp_aff_self[g];
  if (!need_boot && n_dns == 0) {
    pc->bootstrap = 0;
    return;
  }
  for (int s = 0; s < n_dns; ++s) {
    const int id = t.dns_t[g * Sd + s];
    float m = INFINITY;
    if (id >= 0) {
      const float* row = t.counter + (size_t)id * t.D1;
      const uint8_t* edom = t.dns_edom + ((size_t)g * Sd + s) * t.D1;
      for (int d = threadIdx.x; d < t.D1; d += CLUSTER_THREADS)
        if (edom[d]) m = fminf(m, row[d]);
    }
    const int r = __reduce_min_sync(FULL_MASK, okey(m));
    if (lane == 0) s_warp[s * CLUSTER_WARPS + wid] = r;
  }
  bool has_aff = false;
  int nz = 0;
  if (need_boot) {
    for (int a = 0; a < t.A; ++a) {
      const int id = t.req_aff_t[g * t.A + a];
      if (id < 0) continue;
      has_aff = true;
      // counters are non-negative counts, so sum == 0 iff every entry is 0
      const float* row = t.counter + (size_t)id * t.D1;
      for (int d = threadIdx.x; d < D; d += CLUSTER_THREADS)
        if (row[d] != 0.0f) nz = 1;
    }
  }
  const int r = __reduce_max_sync(FULL_MASK, nz);
  if (lane == 0) s_warp[n_dns * CLUSTER_WARPS + wid] = r;
  __syncthreads();
  for (int s = wid; s <= n_dns; s += CLUSTER_WARPS) {
    const bool mn = s < n_dns;
    const int x = redux(lane < CLUSTER_WARPS ? s_warp[s * CLUSTER_WARPS + lane]
                                             : (mn ? INT_HI : 0), mn);
    if (lane != 0) continue;
    if (!mn) {
      pc->bootstrap = has_aff && !x;
    } else {
      const float m = ounkey(x);
      pc->dns_min[s] = (t.dns_t[g * Sd + s] >= 0 && isfinite(m)) ? m : 0.0f;
    }
  }
  __syncthreads();
}

// The DoNotSchedule levels of the terms in `terms` (bit s of the first Sd,
// common.cuh TermSet;
// K4 group_serial.cu and K5 affinity_wave.cu keep them across pods):
// the minimum over its eligible domains of the live row cnt[s]
// (pc->dns_min, 0 when no domain is eligible; `mn` keeps it raw) and how
// many eligible domains hold it (`nmin`). Four CTA barriers.
static __device__ void dns_levels(const TablesView& t, int g, const float* cnt,
                                  TermSet terms, PodCtx* pc, float* mn, int* nmin,
                                  int* s_warp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, Sd = t.Sd, D1 = t.D1;
  for (int pass = 0; pass < 2; ++pass) {
    for (int s = 0; s < Sd; ++s) {
      if (!TERM_IN(terms, s)) continue;
      const int id = t.dns_t[g * Sd + s];
      const float* row = cnt + (size_t)s * D1;
      const uint8_t* edom = t.dns_edom + ((size_t)g * Sd + s) * D1;
      int r;
      if (pass == 0) {  // the minimum
        float m = INFINITY;
        if (id >= 0)
          for (int d = threadIdx.x; d < D1; d += CLUSTER_THREADS)
            if (edom[d]) m = fminf(m, row[d]);
        r = __reduce_min_sync(FULL_MASK, okey(m));
      } else {  // the eligible domains at it
        int k = 0;
        if (id >= 0 && isfinite(mn[s]))
          for (int d = threadIdx.x; d < D1; d += CLUSTER_THREADS)
            if (edom[d] && row[d] == mn[s]) ++k;
        r = __reduce_add_sync(FULL_MASK, k);
      }
      if (lane == 0) s_warp[s * CLUSTER_WARPS + wid] = r;
    }
    __syncthreads();
    for (int s = wid; s < Sd; s += CLUSTER_WARPS) {
      if (!TERM_IN(terms, s)) continue;
      if (pass == 0) {
        const float m = ounkey(__reduce_min_sync(
            FULL_MASK, lane < CLUSTER_WARPS ? s_warp[s * CLUSTER_WARPS + lane] : INT_HI));
        if (lane == 0) {
          mn[s] = m;
          pc->dns_min[s] = (t.dns_t[g * Sd + s] >= 0 && isfinite(m)) ? m : 0.0f;
        }
      } else {
        const int k = __reduce_add_sync(
            FULL_MASK, lane < CLUSTER_WARPS ? s_warp[s * CLUSTER_WARPS + lane] : 0);
        if (lane == 0) nmin[s] = k;
      }
    }
    __syncthreads();
  }
}

// Allow `kernel` clusters of 16 and CLUSTER_SMEM_MAX bytes of dynamic
// shared memory on the current device; once per device, before any
// occupancy query or launch (cluster_kernels_init).
template <typename... Params>
static cudaError_t cluster_kernel_init(void (*kernel)(Params...)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CLUSTER_SMEM_MAX);
  return e;
}

// Launch `kernel` on S clusters of C CTAs of CLUSTER_THREADS threads with
// `smem` bytes of dynamic shared memory (the wide build first allocates the
// launch's scratch and points every TablesView argument at it: common.cuh
// wide_open). A refused launch returns its cudaError; nothing is retried in
// another shape.
template <typename... Params, typename... Args>
static int cluster_launch(void (*kernel)(Params...), int C, int S, long long smem,
                          cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * S), 1, 1);
  cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#if OSIM_WIDE
  WideScratch ws;
  const int we = wide_open(ws, (long long)C * S, CLUSTER_THREADS, stream, args...);
  if (we != 0) return we;
#endif
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of C CTAs with `smem` bytes can be resident at once
// (cudaOccupancyMaxActiveClusters), into *out.
template <typename... Params>
static int cluster_occupancy_of(void (*kernel)(Params...), int C, long long smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, 1, 1);
  cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}
