// Hash-grid table gradients from an update stream: (L, n) int32 keys and
// value planes -> (L, T, 2) f32 dL/dtable, the exact f32 sums. Entry k of
// level l adds its (feature 0, feature 1) pair c to table entry
// keys[l, k] + off[c] of level l, for each offset of the family:
//
//   tcnn_table_grad   off {0}            replaces the Pallas kernels
//       radnerf_tpu/ops/hashgrid_window.py::_window_scatter_kernel (via
//       sorted_table_grad_window) and radnerf_tpu/ops/hashgrid_pallas.py::
//       _grad_kernel (via hashgrid_table_grad: the same function from
//       point-major input, which is the same stream);
//   slab_table_grad   off {0, 1}         replaces hashgrid_window.py::
//       _window_scatter_pair_kernel (via sorted_table_grad_window_pair);
//       the k + 1 == T half is dropped, as the reference's spare slab row
//       drops it;
//   brick_table_grad  off {0, 1, 11, 12} replaces radnerf_tpu/ops/
//       hashgrid_brick.py::_make_brick_kernel (via sorted_table_grad_brick).
//
// vals is (2 * |off|, L, n) f32: plane 2c holds feature 0 and plane 2c + 1
// feature 1 of offset c. The TPU kernels need the stream sorted by row
// (sorting is the TPU's substitute for a scatter) and then walk windows of
// rows with one-hot VPU or MXU sums. Hopper has atomics; the wrapper
// zero-fills the table. The stream may come in any order; a zero value
// adds nothing and is skipped (masked samples carry zero gradients).
//
// tcnn_table_grad (the dedup path of every float32 run, and the pallas
// path) has its own kernel: one thread per (level, entry), the warp's
// lanes with the same table entry aggregated (warp_aggregate.cuh: the
// group's (v0, v1) summed in a fixed shuffle order), and one 8-byte
// red.global.add.v2.f32 per group. The dedup stream is corner-major
// (consecutive entries are consecutive samples at one corner, and a ray's
// samples are neighbours), so the coarse levels aggregate well; the
// point-major pallas stream aggregates less, and the sums are right in
// any order. slab_table_grad and brick_table_grad keep the first design:
// one thread per (level, entry) and one scalar f32 atomicAdd per nonzero
// value.
//
// What bounds them on Hopper: the bytes bound is the 64 MiB output
// (L = 16, T = 2^19) written once plus the stream read once (4 + 8 |off|
// bytes per entry; a 131,072-sample microbatch gives 8 x 131,072 tcnn
// entries per level). In practice the atomics bound them: random
// read-modify-writes of a table larger than the 50 MB L2, at the L2's
// atomic rate. Atomic order varies from run to run, so the f32 sums do
// too (a few ulp of the sum of |terms|).
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_aggregate.cuh"

template <int K>
struct Offsets {
  int v[K];
};

template <int K>
__global__ void stream_table_grad_kernel(
    const int* __restrict__ keys, const float* __restrict__ vals,
    float* __restrict__ out, int64_t n, int n_levels, int64_t table_size,
    Offsets<K> off) {
  const int64_t total = n * n_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t l = i / n;
  const int64_t key = __ldg(keys + i);
  float* o = out + 2 * l * table_size;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float v0 = __ldg(vals + (2 * c) * total + i);
    const float v1 = __ldg(vals + (2 * c + 1) * total + i);
    const int64_t e = key + off.v[c];
    if (e < 0 || e >= table_size) continue;   // slab: k + 1 == T
    if (v0 != 0.0f) atomicAdd(o + 2 * e, v0);
    if (v1 != 0.0f) atomicAdd(o + 2 * e + 1, v1);
  }
}

template <int K>
static int launch(const void* keys, const void* vals, void* out, int64_t n,
                  int n_levels, int64_t table_size, Offsets<K> off,
                  void* stream) {
  const int64_t total = n * n_levels;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    stream_table_grad_kernel<K><<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
        (const int*)keys, (const float*)vals, (float*)out, n, n_levels,
        table_size, off);
  }
  return (int)cudaGetLastError();
}

__global__ void tcnn_table_grad_kernel(
    const int* __restrict__ keys, const float* __restrict__ vals,
    float* __restrict__ out, int64_t n, int n_levels, int64_t table_size) {
  const int64_t total = n * n_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // every lane of the warp takes part in the aggregation: no early return
  float v[2] = {0.0f, 0.0f};
  int64_t e = -1;                       // flat (L * T) entry; -1: inactive
  if (i < total) {
    const int64_t key = __ldg(keys + i);
    v[0] = __ldg(vals + i);
    v[1] = __ldg(vals + total + i);
    if (key >= 0 && key < table_size && (v[0] != 0.0f || v[1] != 0.0f))
      e = (i / n) * table_size + key;
  }
  // a warp may straddle two levels: the key is the flat entry
  const WarpGroup grp = warp_group((unsigned long long)e);
  warp_group_sum(v, grp.next);
  if (e >= 0 && grp.leader) red_add_f32x2(out + 2 * e, v[0], v[1]);
}

extern "C" int tcnn_table_grad(const void* keys, const void* vals, void* out,
                               int64_t n, int n_levels, int64_t table_size,
                               void* stream) {
  const int64_t total = n * n_levels;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    tcnn_table_grad_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const int*)keys, (const float*)vals, (float*)out, n, n_levels,
        table_size);
  }
  return (int)cudaGetLastError();
}

extern "C" int slab_table_grad(const void* keys, const void* vals, void* out,
                               int64_t n, int n_levels, int64_t table_size,
                               void* stream) {
  return launch<2>(keys, vals, out, n, n_levels, table_size, {{0, 1}},
                   stream);
}

extern "C" int brick_table_grad(const void* keys, const void* vals,
                                void* out, int64_t n, int n_levels,
                                int64_t table_size, void* stream) {
  return launch<4>(keys, vals, out, n, n_levels, table_size,
                   {{0, 1, 11, 12}}, stream);
}
