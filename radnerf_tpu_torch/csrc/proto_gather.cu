// Row gather and row scatter-add of a (T, 2) f32 table (the
// proto_pallas_gather prototype):
//
//   pallas_gather   out[i] = table[idx[i]]                 replaces the Pallas
//       kernel examples/proto_pallas_gather.py:52 gather_kernel (call :61 in
//       pallas_gather);
//   pallas_scatter  out = zeros(T, 2); out[idx[i]] += vals[i]   replaces
//       examples/proto_pallas_gather.py:84 scatter_kernel (call :99 in
//       pallas_scatter).
//
// The TPU kernels hold the whole 4 MB table in VMEM, and the scatter adds
// the updates one after another in a fori_loop, carried from one grid
// step to the next. Hopper has no 4 MB of shared memory (227 KB a block)
// and runs blocks in no order, but the table sits in the 50 MB L2 and a
// thread can add atomically.
//
// The gather (kept design: one thread a row). Each thread loads its
// index (4 bytes, coalesced, so an idx view at any element offset will
// do), reads its row through the read-only path and stores it: one 8-byte
// load where the table is 8-byte aligned, two 4-byte loads where it is
// only 4-byte aligned (a view at an odd element offset, which jnp.take
// also gathers; the entry point picks the instantiation, so the aligned
// path pays nothing). Four waves of 256-thread blocks keep the index
// stream, the row reads and the stores of different blocks in flight
// together. Designs that gave a thread 2, 4 or 8 rows (one 8- or 16-byte
// index load, every row's load issued before any is used, 16-byte
// stores), with evict-first streams or a grid of the resident blocks
// walking the rows, were 3-40% slower on an H100 80GB HBM3 at 700 W:
// with a wave or two, every block waits on its indices, then on its
// rows, then stores, at the same time. Other block sizes, evict-first
// streams and prefetching the next index changed nothing (within 1%).
//
// The scatter, into an output the wrapper zero-fills: one thread per
// update and one 8-byte vector reduction (red.global.add.v2.f32) each,
// since a row's two values are contiguous and 8-byte aligned: half the L2
// reduction requests of two scalar f32 atomics (the first port), and 1.7x
// faster. idx and vals are read with coalesced 4-byte loads, so a view at
// any element offset will do. Two other designs bought nothing on the
// card: four updates a thread with 16-byte loads, and warp aggregation of
// equal rows, which the prototype's stream (uniform over 2^19 rows)
// hardly has: 2e-5 of a warp's updates share a row.
// The TPU's serial sum is deterministic and the atomics' order is not:
// each entry is within 2 (n - 1) 2^-24 sum|terms| of the serial sum of its
// n terms.
//
// What bounds them on Hopper. Bytes would allow 5.0 us: at the
// prototype's default (M = 2^20 indices, T = 2^19 rows) each kernel
// moves 16 MiB (indices, rows, table) at 3.35 TB/s. But each random
// 8-byte row read or reduction touches its own 32-byte L2 sector, and
// the L2's rate of random sectors bounds both: on an H100 80GB HBM3 at
// 700 W the M random row reads alone (no index or output stream) take
// 9.6-9.7 us, and the gather takes 10.4-10.5 us, 7-9% more.
//
// An index i in [-T, 0) is counted from the end of the table, row T + i,
// as jnp.take and jnp's .at[].add count it. An index outside [-T, T)
// gathers NaN (jnp.take's default fill for floats), and its update is
// dropped (the default of .at[].add); no thread reads or writes outside
// the table.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_aggregate.cuh"

// idx as a row of a table of t rows: [-t, 0) counted from the end.
__device__ __forceinline__ int64_t table_row(int i, int64_t t) {
  return i < 0 ? i + t : i;
}

// Row i of the table (NaN outside it): one 8-byte load, or two 4-byte
// loads where the table is only 4-byte aligned.
template <bool kRow8>
__device__ __forceinline__ float2 gather_row(const float* __restrict__ table,
                                             int i, int64_t t) {
  const int64_t r = table_row(i, t);
  const float nan = __int_as_float(0x7fc00000);
  if (r < 0 || r >= t) return make_float2(nan, nan);
  if (kRow8) return __ldg(reinterpret_cast<const float2*>(table) + r);
  return make_float2(__ldg(table + 2 * r), __ldg(table + 2 * r + 1));
}

template <bool kRow8>
__global__ void row_gather_kernel(const float* __restrict__ table,
                                  const int* __restrict__ idx,
                                  float2* __restrict__ out, int64_t m,
                                  int64_t t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  out[i] = gather_row<kRow8>(table, __ldg(idx + i), t);
}

__device__ __forceinline__ void add_row(float* __restrict__ out, int i,
                                        float a, float b, int64_t t) {
  const int64_t r = table_row(i, t);
  if (r >= 0 && r < t) red_add_f32x2(out + 2 * r, a, b);
}

__global__ void row_scatter_add_kernel(const int* __restrict__ idx,
                                       const float* __restrict__ vals,
                                       float* __restrict__ out, int64_t m,
                                       int64_t t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  add_row(out, __ldg(idx + i), __ldg(vals + 2 * i), __ldg(vals + 2 * i + 1),
          t);
}

static int blocks_of(int64_t m, int threads) {
  return (int)((m + threads - 1) / threads);
}

extern "C" int pallas_gather(const void* table, const void* idx, void* out,
                             int64_t m, int64_t t, void* stream) {
  if (m > 0) {
    const int blocks = blocks_of(m, 256);
    cudaStream_t s = (cudaStream_t)stream;
    if ((uintptr_t)table % 8 == 0)
      row_gather_kernel<true><<<blocks, 256, 0, s>>>(
          (const float*)table, (const int*)idx, (float2*)out, m, t);
    else
      row_gather_kernel<false><<<blocks, 256, 0, s>>>(
          (const float*)table, (const int*)idx, (float2*)out, m, t);
  }
  return (int)cudaGetLastError();
}

extern "C" int pallas_scatter(const void* idx, const void* vals, void* out,
                              int64_t m, int64_t t, void* stream) {
  if ((uintptr_t)out % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (m > 0) {
    row_scatter_add_kernel<<<blocks_of(m, 256), 256, 0,
                             (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)vals, (float*)out, m, t);
  }
  return (int)cudaGetLastError();
}
