// brick3 hash-grid encode, forward: (N, 3) positions in [0, 1]^3 ->
// (N, 2L) bf16 features, level-major.
//
// Replaces the Pallas kernel radnerf_tpu/ops/hashgrid_brick3.py::
// _make_extract_kernel (launched by _extract_runs_pallas from
// hashgrid_encode_brick3_fwd_impl, fw_mode="runs") and the XLA gather of
// fw_mode="plain". The table's flat entry e = (l * rows + row) * 128 +
// lane; row r of level l holds the 5x5x5 lattice cube of one patch, so all
// 8 trilinear corners of a sample sit in one row, at lanes lane0 + {0, 1,
// 5, 6, 25, 26, 30, 31} (brick3_common.cuh). The table comes in one of two
// forms, a compile-time switch:
//  - packed: (L * T / 128, 128) bf16x2 words (pack_brick3_table), one
//    4-byte load per corner; the render and the grid update pack once for
//    many calls;
//  - f32: the (L, T, 2) f32 table as it is, one 8-byte load per corner,
//    each value rounded to bf16 in registers (__float2bfloat16_rn: round
//    to nearest even, the bits of .to(torch.bfloat16)); the training step
//    calls the encode once per table, and this form spares it a pass that
//    casts the whole table (64 MiB read, 32 MiB written) before each call.
//
// What bounds it on Hopper: random reads of a few 32-byte sectors of one
// table row per (sample, level), i.e. L2/DRAM sector traffic and latency;
// the bytes bound counts x in, the features out and the distinct table
// entries read. The TPU kernel dedups runs of equal rows and broadcasts
// them with one-hot MXU matmuls because the TPU has no fast gather; a
// Hopper thread simply loads its 8 corners. The design:
//  - Level-major tiles: a block takes a tile of TILE consecutive samples
//    and stages their x in shared memory with coalesced loads; each warp
//    then walks one level over 32 consecutive samples. The level's
//    parameters and its dense/hashed branch are warp-uniform (no divergence,
//    one constant-cache broadcast), and neighbouring samples of a ray that
//    share a cell read the same words in one load instruction.
//  - Staged output: the tile's (TILE, L) bf16x2 words go to shared memory
//    (row stride L | 1, odd, against bank conflicts) and back to device
//    memory in coalesced stores, a warp's 32 words to 128 contiguous bytes
//    (the tile is contiguous there). 16-byte stores, four words a thread,
//    were slower on the card: their reads of the odd-stride tile conflict
//    in shared memory.
//  - No 64-bit division: a warp's task gives its level and sample slice.
//
// Arithmetic matches the plain PyTorch twin (ops/hashgrid_brick3.py::
// _encode_plain) bit for bit: pos = fma(x, scale, 0.5) (the reference's
// XLA contraction), weights ((wx*wy)*wz), and the 8 products summed in
// corner order with separate roundings (built with -fmad=false).
#include <cuda_bf16.h>

#include "brick3_common.cuh"

#define TILE 64          // samples per block
#define THREADS 256      // 8 warps

// The (feature 0, feature 1) pair of flat entry e, as bf16 values in f32.
template <bool F32_TABLE>
__device__ __forceinline__ float2 brick3_corner(const void* __restrict__ t,
                                                uint64_t e) {
  if (F32_TABLE) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(t) + e);
    return make_float2(__bfloat162float(__float2bfloat16_rn(v.x)),
                       __bfloat162float(__float2bfloat16_rn(v.y)));
  }
  const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(t) + e);
  return make_float2(__uint_as_float(word << 16),           // feature 0
                     __uint_as_float(word & 0xFFFF0000u));  // feature 1
}

// The bf16x2 feature word of position p at level l.
template <bool F32_TABLE>
__device__ __forceinline__ uint32_t brick3_feature(
    const void* __restrict__ t, const float (&p)[3], int l, uint32_t rows,
    const Brick3Levels& lv) {
  const Brick3Cell cell = brick3_cell_at(p, l, rows, lv);
  const float wx[2] = {__fsub_rn(1.0f, cell.f[0]), cell.f[0]};
  const float wy[2] = {__fsub_rn(1.0f, cell.f[1]), cell.f[1]};
  const float wz[2] = {__fsub_rn(1.0f, cell.f[2]), cell.f[2]};
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {    // corner c = dx + 2 dy + 4 dz
    const float wc = __fmul_rn(
        __fmul_rn(wx[c & 1], wy[(c >> 1) & 1]), wz[c >> 2]);
    const float2 v = brick3_corner<F32_TABLE>(
        t, cell.word0 + (c & 1) + 5 * ((c >> 1) & 1) + 25 * (c >> 2));
    a0 = __fadd_rn(a0, __fmul_rn(wc, v.x));
    a1 = __fadd_rn(a1, __fmul_rn(wc, v.y));
  }
  const __nv_bfloat162 r = __floats2bfloat162_rn(a0, a1);  // (.x, .y)
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <bool F32_TABLE>
__global__ void __launch_bounds__(THREADS) brick3_encode_fwd_kernel(
    const void* __restrict__ table, const float* __restrict__ x,
    uint32_t* __restrict__ out, int64_t n, int n_levels, uint32_t rows,
    Brick3Levels lv) {
  // x tile (TILE, 3), then the feature tile (TILE, ow) words
  extern __shared__ float smem[];
  float* xs = smem;
  uint32_t* os = reinterpret_cast<uint32_t*>(smem + 3 * TILE);
  const int ow = n_levels | 1;
  const int64_t s0 = (int64_t)blockIdx.x * TILE;
  const int nt = n - s0 < TILE ? (int)(n - s0) : TILE;  // samples here
  for (int i = threadIdx.x; i < 3 * nt; i += THREADS)
    xs[i] = __ldg(x + 3 * s0 + i);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tasks = n_levels * (TILE / 32);
  for (int task = warp; task < n_tasks; task += THREADS / 32) {
    const int l = task % n_levels;
    const int j = (task / n_levels) * 32 + lane;   // sample in the tile
    if (j < nt) {
      const float p[3] = {xs[3 * j], xs[3 * j + 1], xs[3 * j + 2]};
      os[j * ow + l] = brick3_feature<F32_TABLE>(table, p, l, rows, lv);
    }
  }
  __syncthreads();

  // the tile's nt * L words are contiguous in out
  uint32_t* o = out + s0 * n_levels;
  for (int w = threadIdx.x; w < nt * n_levels; w += THREADS) {
    const int j = w / n_levels;
    o[w] = os[j * ow + (w - j * n_levels)];
  }
}

// table: packed words (table_is_f32 == 0) or the (L, T, 2) f32 table.
extern "C" int brick3_encode_fwd(
    const void* table, int table_is_f32, const void* x, void* out,
    int64_t n, int n_levels, int rows_per_level, const float* scales,
    const int* nps, const int* dense, void* stream) {
  Brick3Levels lv;
  const int err = brick3_levels(&lv, n_levels, scales, nps, dense);
  if (err) return err;
  if (n > 0) {
    const int64_t blocks = (n + TILE - 1) / TILE;
    const size_t smem = sizeof(float) * TILE * (3 + (n_levels | 1));
    if (table_is_f32) {
      brick3_encode_fwd_kernel<true><<<(unsigned)blocks, THREADS, smem,
                                       (cudaStream_t)stream>>>(
          table, (const float*)x, (uint32_t*)out, n, n_levels,
          (uint32_t)rows_per_level, lv);
    } else {
      brick3_encode_fwd_kernel<false><<<(unsigned)blocks, THREADS, smem,
                                        (cudaStream_t)stream>>>(
          table, (const float*)x, (uint32_t*)out, n, n_levels,
          (uint32_t)rows_per_level, lv);
    }
  }
  return (int)cudaGetLastError();
}
