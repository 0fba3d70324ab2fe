// Candidate occupancy of the multi-cascade grid: (N, K, 3) positions and
// (N, K) step sizes -> (N, K) bools, exactly occupancy_lookup's.
//
// Replaces the Pallas kernel radnerf_tpu/ops/marching.py::
// _make_occ_extract_kernel (launched by occupancy_lookup_bricks). The TPU
// kernel dedups runs of 4x4x8-cell bricks and broadcasts each brick row
// to its candidates with one-hot MXU matmuls, because the TPU has no fast
// gather. Here one thread per candidate computes the (cascade, cell) of
// _occ_mip_cell and reads that cell's byte of the (C, G, G, G) bool grid
// directly: the grid is 2 MB at G = 128, so it stays in the 50 MB L2 and
// the kernel is bound by streaming the 17 bytes per candidate of xyz, dt
// and the result. No run cap, no fallback; the ragged tail is masked.
//
// Arithmetic matches the plain PyTorch twin (ops/marching.py::
// occupancy_lookup) exactly: frexp exponents, an IEEE division by the
// cascade's power-of-two bound, and 0.5 * (q + 1) * G rounded step by
// step (built with -fmad=false).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void occ_lookup_kernel(
    const float* __restrict__ xyz, const float* __restrict__ dt,
    const uint8_t* __restrict__ occ, uint8_t* __restrict__ out, int64_t n,
    int cascades, int grid, float scale) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {__ldg(xyz + 3 * i), __ldg(xyz + 3 * i + 1),
                      __ldg(xyz + 3 * i + 2)};
  const float g = (float)grid;
  // mip_from_pos: exponent of frexp(max|xyz|) + 1; mip_from_dt: of dt*G
  int e1, e2;
  frexpf(fmaxf(fmaxf(fabsf(p[0]), fabsf(p[1])), fabsf(p[2])), &e1);
  frexpf(__fmul_rn(__ldg(dt + i), g), &e2);
  const int m1 = min(max(e1 + 1, 0), cascades - 1);
  const int m2 = min(max(e2, 0), cascades - 1);
  const int mip = max(m1, m2);
  const float bound = fminf(ldexpf(1.0f, mip - 1), scale);
  int64_t flat = mip;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float q = __fadd_rn(__fdiv_rn(p[d], bound), 1.0f);
    float v = __fmul_rn(__fmul_rn(0.5f, q), g);
    v = fminf(fmaxf(v, 0.0f), g - 1.0f);
    flat = flat * grid + (int)v;
  }
  out[i] = occ[flat];
}

extern "C" int occ_lookup(
    const void* xyz, const void* dt, const void* occ, void* out, int64_t n,
    int cascades, int grid_size, float scale, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    occ_lookup_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)xyz, (const float*)dt, (const uint8_t*)occ,
        (uint8_t*)out, n, cascades, grid_size, scale);
  }
  return (int)cudaGetLastError();
}
