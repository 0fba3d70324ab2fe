// Hash-grid table gradients from an update stream: (L, n) int32 keys and
// value planes -> (L, T, 2) f32 dL/dtable, the exact f32 sums. Entry k of
// level l adds its (feature 0, feature 1) pair c to table entry
// keys[l, k] + off[c] of level l, for each offset of the family; a table
// entry at T or beyond is dropped:
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
// What bounds them on Hopper: the bytes bound is the 64 MiB output
// (L = 16, T = 2^19) written once plus the stream read once (4 + 8 |off|
// bytes per entry; a 131,072-sample microbatch gives 8 x 131,072 tcnn,
// 4 x 131,072 slab and 2 x 131,072 brick entries per level, the same
// 8 x 131,072 (f0, f1) terms each). In practice the reductions bound
// them: random read-modify-writes of a table larger than the 50 MB L2,
// at the L2's atomic rate, one scalar f32 atomic per nonzero value in the
// first design (~33.3 M a call).
//
// The design (all three kernels) cuts the count of reductions:
//  - one thread per (level, entry), with the flat entry level * T + key as
//    its key (a warp may straddle two levels);
//  - warp aggregation (warp_aggregate.cuh): the lanes with the same key
//    form a group, whose values are summed in a fixed shuffle order onto
//    the leader. The streams are corner-major (consecutive entries are
//    consecutive samples at one corner, and a ray's samples are
//    neighbours), so the coarse levels aggregate well. A lane past the end
//    of the stream, with a key outside [0, T), or whose values are all
//    zero takes the sentinel key and adds nothing;
//  - vector reductions: the leader writes each entry's (f0, f1) pair with
//    one 8-byte red.global.add.v2.f32, and two neighbouring entries (k,
//    k + 1) whose 16 bytes are aligned (k even) with one 16-byte
//    red.global.add.v4.f32 (red_add_entry_pair). tcnn: one 8-byte
//    reduction a group. slab: one 16-byte (k even) or two 8-byte (k odd).
//    brick: k and k + 11 differ in parity, so exactly one of the pairs
//    (k, k + 1), (k + 11, k + 12) is aligned: one 16-byte and two 8-byte
//    reductions a group, against 8 scalar atomics an entry before. An
//    entry whose summed pair is zero issues nothing.
// The atomics' order varies from run to run, so the f32 sums do too (a
// few ulp of the sum of |terms|); the group sums themselves are fixed.
//
// nvcc 12.9 -Xptxas -v for sm_90a: tcnn 22 registers, slab 28, brick 32;
// no stack frame and no spills in any of the three.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_aggregate.cuh"

#define THREADS 256

// Thread i's entry of the flat (L * n) stream: its 2P values (zero past
// the end) and its key within the level; returns the flat table entry
// level * T + key, or -1 (inactive: past the end, a key outside [0, T),
// or every value zero).
template <int P>
__device__ __forceinline__ int64_t load_entry(
    const int* __restrict__ keys, const float* __restrict__ vals,
    int64_t n, int64_t total, int64_t table_size, int64_t i,
    float (&v)[2 * P], int64_t& key) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < 2 * P; ++j) {
    v[j] = i < total ? __ldg(vals + j * total + i) : 0.0f;
    any |= v[j] != 0.0f;
  }
  key = i < total ? __ldg(keys + i) : -1;
  if (!any || key < 0 || key >= table_size) return -1;
  return (i / n) * table_size + key;
}

static unsigned grid_of(int64_t total) {
  return (unsigned)((total + THREADS - 1) / THREADS);
}

__global__ void __launch_bounds__(THREADS) tcnn_table_grad_kernel(
    const int* __restrict__ keys, const float* __restrict__ vals,
    float* __restrict__ out, int64_t n, int n_levels, int64_t table_size) {
  const int64_t total = n * n_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // every lane of the warp takes part in the aggregation: no early return
  float v[2];
  int64_t key;
  const int64_t e = load_entry<1>(keys, vals, n, total, table_size, i, v,
                                  key);
  const WarpGroup grp = warp_group((unsigned long long)e);
  warp_group_sum(v, grp.next);
  if (e >= 0 && grp.leader) red_add_f32x2(out + 2 * e, v[0], v[1]);
}

// slab: entry k carries (k, k + 1), 4 contiguous floats.
__global__ void __launch_bounds__(THREADS) slab_table_grad_kernel(
    const int* __restrict__ keys, const float* __restrict__ vals,
    float* __restrict__ out, int64_t n, int n_levels, int64_t table_size) {
  const int64_t total = n * n_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v[4];
  int64_t key;
  const int64_t e = load_entry<2>(keys, vals, n, total, table_size, i, v,
                                  key);
  const WarpGroup grp = warp_group((unsigned long long)e);
  warp_group_sum(v, grp.next);
  // k + 1 == T is dropped; T - 1 is odd, so it never takes the 16 bytes
  if (e >= 0 && grp.leader)
    red_add_entry_pair(out, e, v, true, key + 1 < table_size);
}

// brick: entry k carries (k, k + 1) and (k + 11, k + 12), two runs of 4
// contiguous floats (keys row * 128 + lane0 with lane0 + 12 < 128, so
// both lie in the level; the checks keep the stream's contract).
__global__ void __launch_bounds__(THREADS) brick_table_grad_kernel(
    const int* __restrict__ keys, const float* __restrict__ vals,
    float* __restrict__ out, int64_t n, int n_levels, int64_t table_size) {
  const int64_t total = n * n_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float v[8];
  int64_t key;
  const int64_t e = load_entry<4>(keys, vals, n, total, table_size, i, v,
                                  key);
  const WarpGroup grp = warp_group((unsigned long long)e);
  warp_group_sum(v, grp.next);
  if (e >= 0 && grp.leader) {
    red_add_entry_pair(out, e, v, true, key + 1 < table_size);
    red_add_entry_pair(out, e + 11, v + 4, key + 11 < table_size,
                       key + 12 < table_size);
  }
}

extern "C" int tcnn_table_grad(const void* keys, const void* vals, void* out,
                               int64_t n, int n_levels, int64_t table_size,
                               void* stream) {
  const int64_t total = n * n_levels;
  if (total > 0)
    tcnn_table_grad_kernel<<<grid_of(total), THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const int*)keys, (const float*)vals, (float*)out, n, n_levels,
        table_size);
  return (int)cudaGetLastError();
}

extern "C" int slab_table_grad(const void* keys, const void* vals, void* out,
                               int64_t n, int n_levels, int64_t table_size,
                               void* stream) {
  const int64_t total = n * n_levels;
  if (total > 0)
    slab_table_grad_kernel<<<grid_of(total), THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const int*)keys, (const float*)vals, (float*)out, n, n_levels,
        table_size);
  return (int)cudaGetLastError();
}

extern "C" int brick_table_grad(const void* keys, const void* vals,
                                void* out, int64_t n, int n_levels,
                                int64_t table_size, void* stream) {
  const int64_t total = n * n_levels;
  if (total > 0)
    brick_table_grad_kernel<<<grid_of(total), THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const int*)keys, (const float*)vals, (float*)out, n, n_levels,
        table_size);
  return (int)cudaGetLastError();
}
