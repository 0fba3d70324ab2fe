// brick3 hash-grid encode, forward: (N, 3) positions in [0, 1]^3 ->
// (N, 2L) bf16 features, level-major.
//
// Replaces the Pallas kernel radnerf_tpu/ops/hashgrid_brick3.py::
// _make_extract_kernel (launched by _extract_runs_pallas from
// hashgrid_encode_brick3_fwd_impl, fw_mode="runs") and the XLA gather of
// fw_mode="plain". The table is (L, T, 2) f32 packed to bf16x2 words,
// viewed as rows of 128 words; row r of level l holds the 5x5x5 lattice
// cube of one patch, so all 8 trilinear corners of a sample sit in one
// row, at words lane0 + {0,1,5,6,25,26,30,31}.
//
// What bounds it on Hopper: random reads, one 128-byte stretch of one
// table row per (sample, level), i.e. memory latency and L2/DRAM sector
// traffic. The TPU kernel dedups runs of equal rows and broadcasts them
// with one-hot MXU matmuls because the TPU has no fast gather; a Hopper
// thread simply loads its 8 words (two 128-byte lines at most), and
// samples of one ray that share a row hit in L1/L2. So: one thread per
// (sample, level), no run cap, no fallback, a ragged tail masked by the
// bounds check.
//
// Arithmetic matches the plain PyTorch twin (ops/hashgrid_brick3.py::
// _encode_plain) bit for bit: pos = fma(x, scale, 0.5) (the reference's
// XLA contraction), weights ((wx*wy)*wz), and the 8 products summed in
// corner order with separate roundings (built with -fmad=false).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_LEVELS 32
#define LANES 128

struct Brick3Levels {
  float scale[MAX_LEVELS];
  uint32_t np[MAX_LEVELS];      // patches per axis (dense levels)
  uint32_t dense[MAX_LEVELS];   // 1: row = px + np*(py + np*pz); 0: hashed
};

__device__ __forceinline__ uint32_t brick3_row(
    uint32_t px, uint32_t py, uint32_t pz, uint32_t np, bool dense,
    int level, uint32_t rows) {
  if (dense) return (px + np * (py + np * pz)) & (rows - 1u);
  uint32_t h = (px * 2654435761u) ^ (py * 805459861u) ^ (pz * 3674653429u);
  h += 0x9E3779B9u * (uint32_t)(level + 1);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h & (rows - 1u);
}

__global__ void brick3_encode_fwd_kernel(
    const uint32_t* __restrict__ packed, const float* __restrict__ x,
    __nv_bfloat162* __restrict__ out, int64_t n, int n_levels,
    uint32_t rows, Brick3Levels lv) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * n_levels) return;
  const int64_t s = i / n_levels;
  const int l = (int)(i - s * n_levels);
  const float scale = lv.scale[l];

  int c[3];
  float f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fmaf_rn(__ldg(x + 3 * s + d), scale, 0.5f);
    const float fl = floorf(pos);
    f[d] = __fsub_rn(pos, fl);
    c[d] = (int)fl;
  }
  // patch coords (floor division by 4) and the cell's base lane
  const int px = c[0] >> 2, py = c[1] >> 2, pz = c[2] >> 2;
  const int lane0 =
      (c[0] - 4 * px) + 5 * (c[1] - 4 * py) + 25 * (c[2] - 4 * pz);
  const uint32_t row = brick3_row((uint32_t)px, (uint32_t)py, (uint32_t)pz,
                                  lv.np[l], lv.dense[l] != 0u, l, rows);
  const uint32_t* w =
      packed + ((uint64_t)l * rows + row) * LANES + lane0;

  const float wx[2] = {__fsub_rn(1.0f, f[0]), f[0]};
  const float wy[2] = {__fsub_rn(1.0f, f[1]), f[1]};
  const float wz[2] = {__fsub_rn(1.0f, f[2]), f[2]};
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wc = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
        const uint32_t word = __ldg(w + dx + 5 * dy + 25 * dz);
        const float lo = __uint_as_float(word << 16);          // feature 0
        const float hi = __uint_as_float(word & 0xFFFF0000u);  // feature 1
        a0 = __fadd_rn(a0, __fmul_rn(wc, lo));
        a1 = __fadd_rn(a1, __fmul_rn(wc, hi));
      }
    }
  }
  out[i] = __floats2bfloat162_rn(a0, a1);   // (.x, .y) = features (0, 1)
}

extern "C" int brick3_encode_fwd(
    const void* packed, const void* x, void* out, int64_t n, int n_levels,
    int rows_per_level, const float* scales, const int* nps,
    const int* dense, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Brick3Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    lv.scale[l] = scales[l];
    lv.np[l] = (uint32_t)nps[l];
    lv.dense[l] = (uint32_t)dense[l];
  }
  const int64_t total = n * n_levels;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    brick3_encode_fwd_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (const float*)x, (__nv_bfloat162*)out, n,
        n_levels, (uint32_t)rows_per_level, lv);
  }
  return (int)cudaGetLastError();
}
