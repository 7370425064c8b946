// Device code shared by the port's CUDA kernels (schedule.cu: K1, K2;
// wave.cu: K3, K3c; group_serial.cu: K4; affinity_wave.cu: K5, and the lane
// kernels of K2-K5): the tables view, the filters of `feasibility`, the
// score formulas, the block reductions and the lanes' view.
//
// Exactness contract with the plain PyTorch versions (ops/kernels.py):
// - built with --fmad=false and without fast math: every multiply and add is
//   rounded separately, in the order of the JAX expression;
// - log is taken in f64 and rounded once to f32 (the plain version does the
//   same), so the ScheduleAnyway weights agree bit for bit;
// - sums over the small slot axes run left to right from 0;
// - the sums that run in parallel (zone sums, topology sizes, domain counts)
//   add integer-valued f32 counts, exact in any order below 2^24, so atomics
//   are safe there;
// - every argmax carries (value, index) pairs and prefers the smaller index
//   on equal values (JAX's first-max argmax); the argmins over a node's
//   devices and volume groups likewise keep the first minimum;
// - sums over a node's GPU devices and volume groups run left to right from
//   0 on one thread.
//
// The GPU-share and Open-Local branches (`f_gpu`, `f_storage`) are runtime
// flags of the view. The device code that evaluates them is compiled only
// into the instantiations with EXT = true (node_feasibility<EXT>,
// segment_node_constants<EXT>, K2, K3), which the launchers pick when a flag
// is on: with both off, a kernel runs the code it ran before the branches
// existed (the same registers, no stack for their per-node arrays).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_SLOTS 64
// per-node GPU devices, volume groups and storage devices one thread holds
#define MAX_NODE_DEVS 32
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
  const float* grp_gpu_mem;      // [G]
  const float* grp_gpu_num;      // [G]
  const uint8_t* grp_gpu_pre;    // [G]
  const float* grp_gpu_take;     // [G, MAXDEV]
  const float* dev_total;        // [N, MAXDEV]
  const float* grp_lvm_size;     // [G, SL]
  const int* grp_lvm_vg;         // [G, SL]
  const float* grp_sdev_size;    // [G, SD]
  const int* grp_sdev_media;     // [G, SD]
  const float* vg_cap;           // [N, MAXVG]
  const int* vg_nameid;          // [N, MAXVG]
  const float* sdev_cap;         // [N, MAXSD]
  const int* sdev_media;         // [N, MAXSD]
  float* requested;              // carry [N, R]
  float* nonzero;                // carry [N, 2]
  uint8_t* port_used;            // carry [N, PORT1]
  float* counter;                // carry [T, D1]
  float* carrier;                // carry [Tc, D1]
  float* dev_used;               // carry [N, MAXDEV]
  float* vg_req;                 // carry [N, MAXVG]
  float* sdev_alloc;             // carry [N, MAXSD]
  // [N] node-active row of the lane a lane kernel runs (lane_view); the
  // single-lane kernels never read it
  const uint8_t* active;
  int N, R, G, T, Tc, D1, PORT1, PP, A, B, Cp, Sd, Ss, Ca, Cw, Z;
  int MAXDEV, MAXVG, MAXSD, SL, SD;
  int f_fit, f_ports, f_interpod, f_spread, f_gpu, f_storage;
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
static __device__ void block_reduce(float (&v)[K], const int (&op)[K], float* s_red) {
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

static __device__ float block_min(float x, float* s_red) {
  float v[1] = {x};
  const int op[1] = {OP_MIN};
  block_reduce<1>(v, op, s_red);
  return v[0];
}

// Bootstrap flag of required affinity (kernels.py:427-437) and, with
// include_dns, the DoNotSchedule minimum over eligible domains per term
// (:461-464). Block-uniform control flow; thread 0 writes `pc`; ends with a
// barrier.
static __device__ void pod_prologue(const TablesView& t, int g, int include_dns, PodCtx* pc,
                                    float* s_red) {
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
  if (t.f_spread && include_dns) {
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

// ---- GPU-share (kernels.py :475-498, :693-716) ----

// Whole units of `safe_mem` device d of node n still holds (0 off a device)
static __device__ __forceinline__ float gpu_units_at(const TablesView& t, const float* used,
                                                     int n, int d, float safe_mem) {
  const float tot = t.dev_total[(size_t)n * t.MAXDEV + d];
  const float u = tot > 0.0f ? floorf((tot - used[d]) / safe_mem) : 0.0f;
  return fmaxf(u, 0.0f);
}

// Open-Gpu-Share Filter of group g on node n: the node's total GPU memory
// covers the per-GPU request and its devices hold the requested units; a
// pre-assigned gpu-index skips the device fit.
static __device__ bool gpu_ok_at(const TablesView& t, int g, int n) {
  const float gmem = t.grp_gpu_mem[g];
  if (!(gmem > 0.0f)) return true;
  const float gnum = t.grp_gpu_num[g], safe_mem = fmaxf(gmem, 1.0f);
  const float* used = t.dev_used + (size_t)n * t.MAXDEV;
  float total = 0.0f, units = 0.0f;
  bool any_dev = false;
  for (int d = 0; d < t.MAXDEV; ++d) {
    const float tot = t.dev_total[(size_t)n * t.MAXDEV + d];
    total = total + tot;
    any_dev = any_dev || tot > 0.0f;
    units = units + gpu_units_at(t, used, n, d, safe_mem);
  }
  if (t.grp_gpu_pre[g]) return total >= gmem && gnum > 0.0f && any_dev;
  return total >= gmem && units >= gnum && gnum > 0.0f;
}

// Units per device one copy of group g takes on node n (AllocateGpuId):
// one GPU, the tightest device that fits (first on ties, device 0 when none
// fits); several, the first `gnum` units in device order. `used` is the
// node's ledger row; `take` gets MAXDEV values.
static __device__ void gpu_take_at(const TablesView& t, const float* used, int n, float gmem,
                                   float gnum, float safe_mem, bool single, float* take) {
  const float* tot = t.dev_total + (size_t)n * t.MAXDEV;
  if (single) {
    float best = INFINITY;
    int cand = 0;
    for (int d = 0; d < t.MAXDEV; ++d) {
      const float idle = tot[d] - used[d];
      if (idle >= gmem && tot[d] > 0.0f && idle < best) {
        best = idle;
        cand = d;
      }
    }
    for (int d = 0; d < t.MAXDEV; ++d) take[d] = d == cand ? 1.0f : 0.0f;
    return;
  }
  float cum = 0.0f;  // whole numbers: exact
  for (int d = 0; d < t.MAXDEV; ++d) {
    const float u = gpu_units_at(t, used, n, d, safe_mem);
    cum = cum + u;
    take[d] = fminf(fmaxf(gnum - (cum - u), 0.0f), u);
  }
}

// The serial commit's GPU ledger update at node c (kernels.py:693-716): a
// pre-assigned gpu-index charges exactly the annotated devices. One thread.
static __device__ void gpu_commit_at(const TablesView& t, int g, int c) {
  const float gmem = t.grp_gpu_mem[g];
  if (!(gmem > 0.0f)) return;  // adds take * gmem * 0
  float take[MAX_NODE_DEVS];
  float* used = t.dev_used + (size_t)c * t.MAXDEV;
  if (t.grp_gpu_pre[g]) {
    for (int d = 0; d < t.MAXDEV; ++d) take[d] = t.grp_gpu_take[(size_t)g * t.MAXDEV + d];
  } else {
    const float gnum = t.grp_gpu_num[g];
    gpu_take_at(t, used, c, gmem, gnum, fmaxf(gmem, 1.0f), gnum == 1.0f, take);
  }
  for (int d = 0; d < t.MAXDEV; ++d) used[d] = used[d] + take[d] * gmem;
}

// ---- Open-Local (kernels.py storage_alloc :274) ----

// Open-Local allocation of group g's volumes on node n against the carry's
// VG/device state: LVM volumes in slot order (a named VG exactly, else
// Binpack: the tightest VG that fits, first on ties), then device volumes
// (the smallest free device of the media type that fits), with the
// reference's quirks (a per-media count pre-check; a volume fails the node
// only when the last free device is too small; volumes past a consumed last
// device are dropped). Returns ok (true without storage demand); writes the
// raw Binpack score to *raw, and the node's lvm_add[MAXVG] / dev_add[MAXSD]
// rows when those are not null. A slot without a volume changes nothing and
// is skipped.
static __device__ bool storage_alloc_at(const TablesView& t, int g, int n, float* raw,
                                        float* lvm_out, float* dev_out) {
  const int V = t.MAXVG, Dv = t.MAXSD;
  const float* vcap = t.vg_cap + (size_t)n * V;
  const int* vname = t.vg_nameid + (size_t)n * V;
  const float* vreq = t.vg_req + (size_t)n * V;
  float lvm_add[MAX_NODE_DEVS];
  for (int v = 0; v < V; ++v) lvm_add[v] = 0.0f;
  bool ok = true, has_lvm = false, has_dev = false;
  for (int s = 0; s < t.SL; ++s) {
    const float size = t.grp_lvm_size[(size_t)g * t.SL + s];
    if (!(size > 0.0f)) continue;
    has_lvm = true;
    const int nid = t.grp_lvm_vg[(size_t)g * t.SL + s];
    bool fit = false;
    int tgt = 0;
    if (nid > 0) {  // named VG: the first VG of that name
      int first = -1;
      for (int v = 0; v < V; ++v) {
        if (vname[v] != nid) continue;
        if (first < 0) first = v;
        if (vcap[v] - (vreq[v] + lvm_add[v]) >= size) fit = true;
      }
      tgt = first < 0 ? 0 : first;
    } else {  // Binpack: the tightest VG that fits
      float best = INFINITY;
      for (int v = 0; v < V; ++v) {
        const float fr = vcap[v] - (vreq[v] + lvm_add[v]);
        if (vcap[v] > 0.0f && fr >= size) {
          fit = true;
          if (fr < best) {
            best = fr;
            tgt = v;
          }
        }
      }
    }
    if (fit) lvm_add[tgt] = lvm_add[tgt] + size;
    ok = ok && fit;
  }

  const float* dcap = t.sdev_cap + (size_t)n * Dv;
  const int* dmed = t.sdev_media + (size_t)n * Dv;
  const float* dal = t.sdev_alloc + (size_t)n * Dv;
  // per media (1 hdd, 2 ssd): the last device in (capacity, index) order
  // among the free ones, and the count pre-check
  int last[3] = {0, 0, 0};
  for (int m = 1; m <= 2; ++m) {
    float maxcap = -1.0f;
    int n_free = 0, n_vols = 0;
    for (int d = 0; d < Dv; ++d) {
      if (!(dmed[d] == m && dal[d] < 0.5f && dcap[d] > 0.0f)) continue;
      ++n_free;
      if (dcap[d] >= maxcap) {
        maxcap = dcap[d];
        last[m] = d;
      }
    }
    for (int s = 0; s < t.SD; ++s)
      if (t.grp_sdev_media[(size_t)g * t.SD + s] == m && t.grp_sdev_size[(size_t)g * t.SD + s] > 0.0f)
        ++n_vols;
    ok = ok && (n_free >= n_vols || n_vols == 0);
  }
  uint32_t taken = 0;  // dev_add as bits
  float dev_acc = 0.0f, dev_units = 0.0f;
  for (int s = 0; s < t.SD; ++s) {
    const float size = t.grp_sdev_size[(size_t)g * t.SD + s];
    if (!(size > 0.0f)) continue;
    has_dev = true;
    const int m = t.grp_sdev_media[(size_t)g * t.SD + s] == 2 ? 2 : 1;
    bool fit = false;
    int tgt = 0;
    float best = INFINITY;
    for (int d = 0; d < Dv; ++d) {
      const bool free_now = dmed[d] == m && dal[d] < 0.5f && dcap[d] > 0.0f && !((taken >> d) & 1u);
      if (free_now && dcap[d] >= size) {
        fit = true;
        if (dcap[d] < best) {
          best = dcap[d];
          tgt = d;
        }
      }
    }
    const int li = last[m];
    const bool last_free = dmed[li] == m && dal[li] < 0.5f && dcap[li] > 0.0f && !((taken >> li) & 1u);
    ok = ok && !(!fit && last_free);
    if (fit) {
      taken |= 1u << tgt;
      dev_acc = dev_acc + size / fmaxf(dcap[tgt], 1.0f);
      dev_units = dev_units + 1.0f;
    }
  }

  // ScoreLVM (Binpack): the mean over the used VGs of used / capacity x 10
  float frac = 0.0f, n_used = 0.0f;
  for (int v = 0; v < V; ++v) {
    const bool used = lvm_add[v] > 0.0f;
    frac = frac + ((used && vcap[v] > 0.0f) ? lvm_add[v] / fmaxf(vcap[v], 1.0f) : 0.0f);
    n_used = n_used + (used ? 1.0f : 0.0f);
  }
  const float lvm_raw = (has_lvm && n_used > 0.0f) ? floorf(frac / fmaxf(n_used, 1.0f) * 10.0f) : 0.0f;
  const float dev_raw = (has_dev && dev_units > 0.0f)
                            ? floorf(dev_acc / fmaxf(dev_units, 1.0f) * 10.0f) : 0.0f;
  if (raw) *raw = lvm_raw + dev_raw;
  if (lvm_out)
    for (int v = 0; v < V; ++v) lvm_out[v] = lvm_add[v];
  if (dev_out)
    for (int d = 0; d < Dv; ++d) dev_out[d] = (float)((taken >> d) & 1u);
  return ok || !(has_lvm || has_dev);
}

// The serial commit's Open-Local bind at node c (kernels.py:718-723): the
// take is computed from the carry before the commit. One thread.
static __device__ void storage_commit_at(const TablesView& t, int g, int c) {
  float lvm_add[MAX_NODE_DEVS], dev_add[MAX_NODE_DEVS];
  storage_alloc_at(t, g, c, nullptr, lvm_add, dev_add);
  // sdo = has_storage: without storage demand both rows are zero
  for (int v = 0; v < t.MAXVG; ++v)
    t.vg_req[(size_t)c * t.MAXVG + v] = t.vg_req[(size_t)c * t.MAXVG + v] + lvm_add[v];
  for (int d = 0; d < t.MAXSD; ++d)
    t.sdev_alloc[(size_t)c * t.MAXSD + d] = t.sdev_alloc[(size_t)c * t.MAXSD + d] + dev_add[d];
}

// Every filter of `feasibility` (kernels.py:379-521) for one node;
// include_dns=0 drops DoNotSchedule, include_interpod=0 the InterPodAffinity
// filters; with EXT, the view's f_gpu / f_storage switch the GPU-share and
// Open-Local filters on. Returns the stage bits plus BIT_FEASIBLE; writes
// fit_each[R] when `fit_each` is not null, and the node's raw Open-Local
// score to *st_raw when that is not null and f_storage is on. With LANE, the
// lane's node-active row folds into the static mask, the single root every
// filter ANDs into (JAX `_mask_active`): an inactive node is infeasible for
// every pod, so it drops out of every normalizer, count and sum that the
// kernels take over the feasible set, exactly as the plain version's masked
// static_mask makes it.
template <bool EXT, bool LANE = false>
static __device__ uint32_t node_feasibility(const TablesView& t, const PodCtx* pc, int g,
                                            int forced, int valid, int include_dns,
                                            int include_interpod, int n, uint8_t* fit_each,
                                            float* st_raw = nullptr) {
  const int N = t.N, R = t.R, D = t.D1 - 1;
  const size_t gn = (size_t)g * N + n;
  bool smask = t.static_mask[gn];
  if constexpr (LANE) smask = smask && t.active[n];

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
  if (t.f_interpod && include_interpod) {
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
  if (t.f_spread && include_dns) {
    for (int s = 0; s < t.Sd; ++s) {
      const int id = t.dns_t[g * t.Sd + s];
      if (id < 0) continue;
      const int dom = t.counter_dom[(size_t)id * N + n];
      const float at = t.counter[(size_t)id * t.D1 + dom];
      const float skew = at + t.dns_self[g * t.Sd + s] - pc->dns_min[s];
      dns_ok = dns_ok && (dom < D) && (skew <= t.dns_maxskew[g * t.Sd + s]);
    }
  }

  bool gpu_ok = true, storage_ok = true;
  if constexpr (EXT) {
    if (t.f_gpu) gpu_ok = gpu_ok_at(t, g, n);
    if (t.f_storage) storage_ok = storage_alloc_at(t, g, n, st_raw, nullptr, nullptr);
  }

  bool feasible = smask && fit && !conflict && aff_ok && !blocked_in && !blocked_ex && dns_ok
                  && gpu_ok && storage_ok;
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
  bits |= (uint32_t)gpu_ok << ST_GPU;
  bits |= (uint32_t)storage_ok << ST_STORAGE;
  bits |= (uint32_t)feasible << BIT_FEASIBLE;
  return bits;
}

// One block of this many threads runs each of K2, K3, K3c, K4 and K5 (one
// block per lane in their lane kernels).
#define BLOCK_THREADS 1024

// ---- lanes (the capacity probe's fan-out, JAX probe_*_fanout :2300-2378) ----
//
// A lane kernel runs S candidate node-active masks at once, one block per
// lane. The wrapper passes the view of lane 0: every carry field is an
// [S, ...] tensor, contiguous, whose lane-0 slice the view points at, and
// `active` is the [S, N] mask. lane_view moves each carry pointer and the
// mask to lane s; the lane's block keeps it in shared memory. Every lane
// reads the one copy of the tables and writes only its own carry, scratch
// and outputs, so the lanes never touch each other's memory and every
// atomic stays inside its lane.
static __device__ TablesView lane_view(const TablesView& t, int s) {
  TablesView v = t;
  const size_t N = (size_t)t.N, S = (size_t)s;
  v.requested += S * N * t.R;
  v.nonzero += S * N * 2;
  v.port_used += S * N * t.PORT1;
  v.counter += S * (size_t)t.T * t.D1;
  v.carrier += S * (size_t)t.Tc * t.D1;
  v.dev_used += S * N * t.MAXDEV;
  v.vg_req += S * N * t.MAXVG;
  v.sdev_alloc += S * N * t.MAXSD;
  if (v.active) v.active += S * N;
  return v;
}

// The lane kernels' prologue: block blockIdx.x (or blockIdx.y for K3c) runs
// lane `s` from the view `lt` in shared memory.
#define LANE_VIEW(lt, t, s)                     \
  __shared__ TablesView lt;                     \
  if (threadIdx.x == 0) lt = lane_view(t, s);   \
  __syncthreads();

// weight slots of TablesView::w (ops/kernels.py _view)
enum { W_LEAST = 0, W_BALANCED, W_OPENLOCAL, W_SIMON, W_NODEAFF, W_TAINT, W_INTERPOD, W_SS,
       W_PTS, W_AVOID, W_IMAGE };

static __device__ __forceinline__ float floor_div100(float num, float den) {
  return floorf(num * 100.0f / den);
}

// NodeResourcesLeastAllocated + NodeResourcesBalancedAllocation on nonzero
// cpu/memory usage (kernels.py:255-270)
static __device__ __forceinline__ void least_balanced(float used_c, float used_m, float a_c,
                                                      float a_m, float* least, float* bal) {
  const float lc = (a_c > 0.0f && used_c <= a_c) ? floor_div100(a_c - used_c, a_c) : 0.0f;
  const float lm = (a_m > 0.0f && used_m <= a_m) ? floor_div100(a_m - used_m, a_m) : 0.0f;
  *least = floorf((lc + lm) / 2.0f);
  const float cf = a_c > 0.0f ? used_c / a_c : 1.0f;
  const float mf = a_m > 0.0f ? used_m / a_m : 1.0f;
  *bal = (cf >= 1.0f || mf >= 1.0f) ? 0.0f : floorf((1.0f - fabsf(cf - mf)) * 100.0f);
}

// The preferred-term part of the InterPodAffinity raw score, left to right
static __device__ float interpod_pref_at(const TablesView& t, int g, int n) {
  float acc = 0.0f;
  for (int k = 0; k < t.Cp; ++k) {
    const int id = t.pref_t[g * t.Cp + k];
    if (id < 0) continue;
    const int dom = t.counter_dom[(size_t)id * t.N + n];
    acc = acc + t.pref_w[g * t.Cp + k] * t.counter[(size_t)id * t.D1 + dom];
  }
  return acc;
}

// InterPodAffinity raw score (kernels.py:237-252): preferred terms, then the
// existing pods' weighted carrier terms
static __device__ float interpod_raw_at(const TablesView& t, int g, int n) {
  const float acc = interpod_pref_at(t, g, n);
  float acc2 = 0.0f;
  for (int k = 0; k < t.Cw; ++k) {
    const int id = t.carr_w_t[g * t.Cw + k];
    if (id < 0) continue;
    const int dom = t.carr_dom[(size_t)id * t.N + n];
    acc2 = acc2 + t.carr_w_w[g * t.Cw + k] * t.carrier[(size_t)id * t.D1 + dom];
  }
  return acc + acc2;
}

// The normalizers over the feasible set (kernels.py _wave_norms)
struct Norms {
  float simon_hi, simon_lo, na_max, t_max, ip_max, ip_min;
};

// Simon, NodeAffinity, TaintToleration and InterPodAffinity, normalized
// (kernels.py score_components :546-600)
static __device__ __forceinline__ void normalized_terms(const Norms& nm, float simon_s,
                                                        float na_raw, float t_raw, float ip,
                                                        float* simon, float* nodeaff,
                                                        float* taint, float* interpod) {
  const float rng = nm.simon_hi - nm.simon_lo, ip_rng = nm.ip_max - nm.ip_min;
  *simon = (rng > 0.0f && isfinite(rng)) ? floorf((simon_s - nm.simon_lo) * 100.0f / rng) : 0.0f;
  *nodeaff = nm.na_max > 0.0f ? floorf(na_raw * 100.0f / nm.na_max) : 0.0f;
  *taint = nm.t_max > 0.0f ? 100.0f - floorf(t_raw * 100.0f / nm.t_max) : 100.0f;
  *interpod = ip_rng > 0.0f ? floorf(100.0f * (ip - nm.ip_min) / ip_rng) : 0.0f;
}

// SelectorSpread (kernels.py:173-189), unfloored: the per-node count score,
// blended 1/3 : 2/3 with the zone score on a zoned node of a zoned set
static __device__ __forceinline__ float selector_spread_blend(float pn, float maxN, float zs,
                                                              float maxZ, bool blend) {
  const float node_score = maxN > 0.0f ? 100.0f * (maxN - pn) / maxN : 100.0f;
  const float zscore = maxZ > 0.0f ? 100.0f * (maxZ - zs) / maxZ : 100.0f;
  return blend ? node_score * (float)(1.0 / 3.0) + zscore * (float)(2.0 / 3.0) : node_score;
}

// ln(topology size + 2) in f64, rounded once (kernels.py topology_weight)
static __device__ __forceinline__ float topology_weight(float topo_size) {
  return (float)log((double)(topo_size + 2.0f));
}

// PodTopologySpread ScheduleAnyway normalization of a relevant node
// (kernels.py:205-215)
static __device__ __forceinline__ float sa_normalized(float raw, float sa_hi, float sa_lo) {
  return sa_hi > 0.0f ? floorf((sa_hi + sa_lo - raw) * 100.0f / sa_hi) : 100.0f;
}

// Copies of group g node n can take in one segment (kernels.py
// _wave_capacity :945 and the filters.fit=False branch of schedule_wave)
static __device__ int segment_capacity(const TablesView& t, int g, int n, int cap1, bool feasible) {
  if (!feasible) return 0;
  int cap;
  if (t.f_fit) {
    float c = INFINITY;
    for (int r = 0; r < t.R; ++r) {
      const float req = t.grp_requests[(size_t)g * t.R + r];
      if (!(req > 0.0f)) continue;
      const float a = t.alloc[(size_t)n * t.R + r];
      const float eps = a * (float)1e-6;
      const float room = a + eps - t.requested[(size_t)n * t.R + r];
      c = fminf(c, floorf(room / fmaxf(req, (float)1e-30)));
    }
    cap = (int)fminf(fmaxf(c, 0.0f), 2147483000.0f);
  } else {
    cap = 2147483000;
  }
  return cap1 ? min(cap, 1) : cap;
}

// Per-node constants of a one-group segment (K3, K4, K5; kernels.py
// _wave_statics :868 and the capacity): base feasibility (include_dns=0
// drops DoNotSchedule, include_interpod=0 InterPodAffinity; the view's
// f_gpu adds the GPU filter, and GPU units then clamp the capacity as
// _gpu_capacity :963 does; EXT only), copies the node can take, the
// interpod raw score, the floored Simon input and the static score terms.
template <bool EXT, bool LANE = false>
static __device__ void segment_node_constants(const TablesView& t, const PodCtx* pc, int g, int n,
                                              int cap1, int include_dns, int include_interpod,
                                              int* feas, int* cap, float* ip, float* simon_s,
                                              float* stat) {
  const size_t gn = (size_t)g * t.N + n;
  const bool f = (node_feasibility<EXT, LANE>(t, pc, g, -1, 1, include_dns, include_interpod,
                                              n, nullptr) >> BIT_FEASIBLE) & 1u;
  *feas = f;
  *cap = segment_capacity(t, g, n, cap1, f);
  const float gmem = t.grp_gpu_mem[g];
  if (EXT && t.f_gpu && gmem > 0.0f) {
    // every copy takes num whole units: floor(total units / max(num, 1))
    const float safe_mem = fmaxf(gmem, 1.0f), gnum = fmaxf(t.grp_gpu_num[g], 1.0f);
    const float* used = t.dev_used + (size_t)n * t.MAXDEV;
    float units = 0.0f;
    for (int d = 0; d < t.MAXDEV; ++d) units = units + gpu_units_at(t, used, n, d, safe_mem);
    *cap = min(*cap, (int)floorf(units / gnum));
  }
  *ip = interpod_raw_at(t, g, n);
  *simon_s = floorf(100.0f * t.simon_raw[gn]);
  *stat = t.w[W_AVOID] * t.avoid_raw[gn] + t.w[W_IMAGE] * t.image_raw[gn] + t.extra_raw[gn];
}

// Block-wide first-max argmax: (value desc, index asc); every thread gets
// the winner. Two barriers; `s_val`/`s_idx` hold 32 entries each.
static __device__ void block_argmax(float* best, int* best_i, float* s_val, int* s_idx) {
  float b = *best;
  int bi = *best_i;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, b, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    if (ov > b || (ov == b && oi < bi)) {
      b = ov;
      bi = oi;
    }
  }
  __syncthreads();  // the previous call's readers are done with s_val/s_idx
  const int lane = threadIdx.x & 31, nw = (blockDim.x + 31) >> 5;
  if (lane == 0) {
    s_val[threadIdx.x >> 5] = b;
    s_idx[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  b = lane < nw ? s_val[lane] : -INFINITY;
  bi = lane < nw ? s_idx[lane] : 0x7fffffff;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, b, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    if (ov > b || (ov == b && oi < bi)) {
      b = ov;
      bi = oi;
    }
  }
  *best = b;
  *best_i = bi;
}

static __device__ __forceinline__ void argmax_update(float v, int i, float* best, int* best_i) {
  if (v > *best || (v == *best && i < *best_i)) {
    *best = v;
    *best_i = i;
  }
}

// Block-wide integer sum; every thread gets the result. Two barriers.
static __device__ int block_sum_int(int x, int* s_int) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  __syncthreads();
  const int lane = threadIdx.x & 31, nw = (blockDim.x + 31) >> 5;
  if (lane == 0) s_int[threadIdx.x >> 5] = x;
  __syncthreads();
  x = lane < nw ? s_int[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

// Block-wide max of unsigned 64-bit keys; every thread gets the result.
static __device__ unsigned long long block_max_u64(unsigned long long x,
                                                   unsigned long long* s_u64) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(FULL_MASK, x, o);
    x = y > x ? y : x;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, nw = (blockDim.x + 31) >> 5;
  if (lane == 0) s_u64[threadIdx.x >> 5] = x;
  __syncthreads();
  x = lane < nw ? s_u64[lane] : 0ull;
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(FULL_MASK, x, o);
    x = y > x ? y : x;
  }
  return x;
}
