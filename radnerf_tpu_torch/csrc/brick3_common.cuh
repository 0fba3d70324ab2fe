// brick3 addressing shared by the encode forward (brick3_encode_fwd.cu)
// and the table gradient (brick3_table_grad.cu), so the two kernels read
// and write the same table words by construction.
//
// Per (sample, level): pos = fma(x, scale, 0.5) (the reference's XLA
// contraction), floor coords c and fractions f, the cube patch
// (c >> 2) and its table row, and the base lane of the cell; the 8
// corners sit at lane0 + dx + 5 dy + 25 dz of that row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BRICK3_MAX_LEVELS 32
#define BRICK3_LANES 128

struct Brick3Levels {
  float scale[BRICK3_MAX_LEVELS];
  uint32_t np[BRICK3_MAX_LEVELS];     // patches per axis (dense levels)
  uint32_t dense[BRICK3_MAX_LEVELS];  // 1: row = px + np*(py + np*pz); 0: hashed
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

struct Brick3Cell {
  uint64_t word0;   // index of the cell's base word: (l * rows + row) * 128 + lane0
  float f[3];       // trilinear fractions (x, y, z)
};

// The cell of position (x[0], x[1], x[2]) at level l.
__device__ __forceinline__ Brick3Cell brick3_cell_at(
    const float (&x)[3], int l, uint32_t rows, const Brick3Levels& lv) {
  const float scale = lv.scale[l];
  Brick3Cell cell;
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fmaf_rn(x[d], scale, 0.5f);
    const float fl = floorf(pos);
    cell.f[d] = __fsub_rn(pos, fl);
    c[d] = (int)fl;
  }
  // patch coords (floor division by 4) and the cell's base lane
  const int px = c[0] >> 2, py = c[1] >> 2, pz = c[2] >> 2;
  const int lane0 =
      (c[0] - 4 * px) + 5 * (c[1] - 4 * py) + 25 * (c[2] - 4 * pz);
  const uint32_t row = brick3_row((uint32_t)px, (uint32_t)py, (uint32_t)pz,
                                  lv.np[l], lv.dense[l] != 0u, l, rows);
  cell.word0 = ((uint64_t)l * rows + row) * BRICK3_LANES + lane0;
  return cell;
}

// The cell of sample s (x: (N, 3) f32) at level l.
__device__ __forceinline__ Brick3Cell brick3_cell(
    const float* __restrict__ x, int64_t s, int l, uint32_t rows,
    const Brick3Levels& lv) {
  const float p[3] = {__ldg(x + 3 * s), __ldg(x + 3 * s + 1),
                      __ldg(x + 3 * s + 2)};
  return brick3_cell_at(p, l, rows, lv);
}

// Host side: the per-level parameters of the C entry points.
static inline int brick3_levels(Brick3Levels* lv, int n_levels,
                                const float* scales, const int* nps,
                                const int* dense) {
  if (n_levels < 1 || n_levels > BRICK3_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_levels; ++l) {
    lv->scale[l] = scales[l];
    lv->np[l] = (uint32_t)nps[l];
    lv->dense[l] = (uint32_t)dense[l];
  }
  return 0;
}
