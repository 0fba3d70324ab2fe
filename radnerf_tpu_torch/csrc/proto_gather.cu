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
// thread can add atomically: one thread per row gathers one 8-byte float2
// through the read-only path and stores it; one thread per update adds its
// two values with f32 atomicAdd into the output, which the wrapper
// zero-fills. The TPU's serial sum is deterministic and the atomics' order
// is not: each entry is within 2 (n - 1) 2^-24 sum|terms| of the serial sum
// of its n terms.
//
// What bounds it on Hopper: bytes. At the prototype's default (M = 2^20
// updates, T = 2^19 rows) each kernel moves 16 MiB (indices, rows, table):
// 5.0 us at 3.35 TB/s. Each random 8-byte read or atomic touches a 32-byte
// L2 sector, so the L2's rate is expected to bound both.
//
// An index outside the table gathers NaN (jnp.take's default fill for
// floats), and its update is dropped (the default of jnp's .at[].add); no
// thread reads or writes outside the table.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void row_gather_kernel(const float2* __restrict__ table,
                                  const int* __restrict__ idx,
                                  float2* __restrict__ out, int64_t m,
                                  int64_t t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int r = __ldg(idx + i);
  const float nan = __int_as_float(0x7fc00000);
  out[i] = (r >= 0 && r < t) ? __ldg(table + r) : make_float2(nan, nan);
}

__global__ void row_scatter_add_kernel(const int* __restrict__ idx,
                                       const float2* __restrict__ vals,
                                       float* __restrict__ out, int64_t m,
                                       int64_t t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int r = __ldg(idx + i);
  if (r < 0 || r >= t) return;
  const float2 v = __ldg(vals + i);
  atomicAdd(out + 2 * (int64_t)r, v.x);
  atomicAdd(out + 2 * (int64_t)r + 1, v.y);
}

static int blocks_of(int64_t m, int threads) {
  return (int)((m + threads - 1) / threads);
}

extern "C" int pallas_gather(const void* table, const void* idx, void* out,
                             int64_t m, int64_t t, void* stream) {
  if (m > 0) {
    row_gather_kernel<<<blocks_of(m, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float2*)table, (const int*)idx, (float2*)out, m, t);
  }
  return (int)cudaGetLastError();
}

extern "C" int pallas_scatter(const void* idx, const void* vals, void* out,
                              int64_t m, int64_t t, void* stream) {
  if (m > 0) {
    row_scatter_add_kernel<<<blocks_of(m, 256), 256, 0,
                             (cudaStream_t)stream>>>(
        (const int*)idx, (const float2*)vals, (float*)out, m, t);
  }
  return (int)cudaGetLastError();
}
