// Hand-written Hopper kernel for the capacity probe's node-axis growth.
//
// K6 extend_tables_kernel replaces open_simulator_tpu/parallel/mesh.py
//    `_extend_tables_impl` (:672, run by `extend_tables_on_device` :703): the
//    device-resident tables of a probe session grow by k copies of the
//    template column, then re-pad with the phantom fill, without a round trip
//    through the host. Every field is a [outer, N, inner] array (a [G, N] or
//    [T, N] table: inner 1; an [N, width] node matrix: outer 1) of 1- or
//    4-byte elements; output element (o, i, c) of the new node axis is
//      src[o, i, c]             for i < n_real,
//      src[o, template_col, c]  for n_real <= i < n_real + k,
//      the field's fill         after that
//    (false / 0 for the tables and node matrices, the domain sentinel for
//    counter_dom, topo_dom and carr_dom: pad_batch_tables' phantoms).
//
// What bounds it on an H100: bytes. It reads each kept input element once
// and writes each output element once; there is no arithmetic beyond the
// index. At the probe's shapes (a few dozen [*, 1,024] rows) it is launch
// bound. Design: ONE launch for every field: the fields' descriptors travel
// in the kernel's parameter block, grid dimension y picks the field and a
// grid-stride loop over x covers its output elements, neighbouring threads on
// neighbouring elements.

#include <cuda_runtime.h>
#include <stdint.h>

#define EXT_MAX_FIELDS 32
#define EXT_THREADS 256

struct ExtField {
  const uint8_t* src;  // [outer, n_old, inner]
  uint8_t* dst;        // [outer, n_new, inner]
  long long outer;
  int inner;
  int elem;            // bytes per element: 1 or 4
  uint32_t fill;       // the phantom fill's bit pattern (low byte for 1-byte fields)
  int pad_;
};

struct ExtArgs {
  ExtField f[EXT_MAX_FIELDS];
  int n_fields, n_old, n_new, n_real, k, template_col;
};

__global__ void __launch_bounds__(EXT_THREADS)
extend_tables_kernel(const ExtArgs a) {
  const ExtField f = a.f[blockIdx.y];
  const long long row = (long long)a.n_new * f.inner;
  const long long total = f.outer * row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const long long o = e / row;
    const long long r = e - o * row;
    const int i = (int)(r / f.inner), c = (int)(r - (long long)i * f.inner);
    const int src_i = i < a.n_real ? i : (i < a.n_real + a.k ? a.template_col : -1);
    const long long at = (o * a.n_old + src_i) * f.inner + c;
    if (f.elem == 4) {
      reinterpret_cast<uint32_t*>(f.dst)[e] =
          src_i >= 0 ? reinterpret_cast<const uint32_t*>(f.src)[at] : f.fill;
    } else {
      f.dst[e] = src_i >= 0 ? f.src[at] : (uint8_t)f.fill;
    }
  }
}

extern "C" {

int ext_args_size() { return (int)sizeof(ExtArgs); }

int extend_tables_launch(const ExtArgs* a, long long max_elems, cudaStream_t stream) {
  if (a->n_fields < 1 || a->n_fields > EXT_MAX_FIELDS) return (int)cudaErrorInvalidValue;
  long long blocks = (max_elems + EXT_THREADS - 1) / EXT_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  extend_tables_kernel<<<dim3((unsigned)blocks, a->n_fields), EXT_THREADS, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
