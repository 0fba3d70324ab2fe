// brick3 hash-grid table gradient: (N, 3) positions and the (N, 2L) f32
// gradient of the encode's output -> (L, T, 2) f32 dL/dtable, the exact
// f32 gradient (the reference's exact=True path, and the f32 golden
// jax.grad of hashgrid_encode_brick3_ref).
//
// Replaces the Pallas kernel radnerf_tpu/ops/hashgrid_brick3.py::
// _make_brick3_kernel (launched by sorted_table_grad_brick3 from
// hashgrid_table_grad_brick3). The TPU kernel sorts the (level, sample)
// stream by row, builds a transposed trilinear stencil and accumulates
// one-hot MXU window matmuls, because the TPU has no fast scatter. Hopper
// has atomics, and the cost is their number: one thread per (sample,
// level) with 16 scalar f32 atomics (the first port) issued ~33.5 M
// atomics at a 131,072-sample microbatch and ran at 18x the bytes bound.
//
// The design cuts the atomics where samples share a cell. The flat layout
// stores a ray's samples next to each other, and at the coarse levels
// neighbouring samples of a ray fall in the same cell.
//  - Level-major warps: a block takes a tile of TILE consecutive samples
//    and stages their x and g in shared memory with coalesced loads; each
//    warp then walks one level over 32 consecutive samples of the tile.
//  - Warp aggregation (warp_aggregate.cuh): lanes whose sample has the
//    same cell (the same base word) form a group; each lane forms its 16
//    products exactly as before, ((wx wy) wz) g rounded once each; the
//    group sums them corner by corner in a fixed shuffle order and its
//    leader issues the reductions. A lane with no sample (past the end) or
//    a zero gradient takes a sentinel key and adds nothing.
//  - 8-byte vector reductions: one red.global.add.v2.f32 per corner (the
//    (f0, f1) pair is contiguous), 8 per group instead of 16 per sample.
// The cell addressing is brick3_common.cuh's, as in brick3_encode_fwd.cu,
// so the two kernels touch the same words by construction. No sort, no
// quantization, any input order; the wrapper zero-fills the output.
//
// What bounds it on Hopper: the bytes bound is the 64 MiB output written
// once (the wrapper's zero-fill) plus x and g read once. In practice the
// reductions bound it: they read-modify-write random 8-byte entries of a
// table larger than the 50 MB L2, at the L2's atomic rate, and the count
// left after aggregation depends on how many samples share a cell (the
// dense coarse levels aggregate well, the fine hashed levels hardly at
// all). The f32 sums' order varies from run to run with the atomics
// (within a few ulp of the sum of |terms|).
#include "brick3_common.cuh"
#include "warp_aggregate.cuh"

#define TILE 64          // samples per block
#define THREADS 256      // 8 warps

__global__ void __launch_bounds__(THREADS) brick3_table_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    float* __restrict__ out, int64_t n, int n_levels, uint32_t rows,
    Brick3Levels lv) {
  // x tile (TILE, 3) and g tile (TILE, 2L + 1): the odd row stride keeps
  // a warp's reads of one level's pair free of bank conflicts
  extern __shared__ float smem[];
  float* xs = smem;
  float* gs = smem + 3 * TILE;
  const int gw = 2 * n_levels;
  const int64_t s0 = (int64_t)blockIdx.x * TILE;
  const int nt = n - s0 < TILE ? (int)(n - s0) : TILE;  // samples here
  for (int i = threadIdx.x; i < 3 * nt; i += THREADS)
    xs[i] = __ldg(x + 3 * s0 + i);
  for (int i = threadIdx.x; i < gw * nt; i += THREADS) {
    const int s = i / gw;
    gs[s * (gw + 1) + (i - s * gw)] = __ldg(g + s0 * gw + i);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tasks = n_levels * (TILE / 32);
  for (int task = warp; task < n_tasks; task += THREADS / 32) {
    const int l = task % n_levels;
    const int j = (task / n_levels) * 32 + lane;   // sample in the tile
    float p[3] = {0.0f, 0.0f, 0.0f};
    float g0 = 0.0f, g1 = 0.0f;
    if (j < nt) {
      p[0] = xs[3 * j];
      p[1] = xs[3 * j + 1];
      p[2] = xs[3 * j + 2];
      g0 = gs[j * (gw + 1) + 2 * l];
      g1 = gs[j * (gw + 1) + 2 * l + 1];
    }
    const bool active = j < nt && !(g0 == 0.0f && g1 == 0.0f);
    const Brick3Cell cell = brick3_cell_at(p, l, rows, lv);
    // the warp holds one level: the cell's word within the level is its key
    const uint32_t key =
        active ? (uint32_t)(cell.word0 - (uint64_t)l * rows * BRICK3_LANES)
               : 0xFFFFFFFFu;
    const WarpGroup grp = warp_group(key);

    const float wx[2] = {__fsub_rn(1.0f, cell.f[0]), cell.f[0]};
    const float wy[2] = {__fsub_rn(1.0f, cell.f[1]), cell.f[1]};
    const float wz[2] = {__fsub_rn(1.0f, cell.f[2]), cell.f[2]};
    float v[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {    // corner c = dx + 2 dy + 4 dz
      const float wc = __fmul_rn(
          __fmul_rn(wx[c & 1], wy[(c >> 1) & 1]), wz[c >> 2]);
      v[2 * c] = __fmul_rn(wc, g0);
      v[2 * c + 1] = __fmul_rn(wc, g1);
    }
    warp_group_sum(v, grp.next);
    if (active && grp.leader) {
      float* o = out + 2 * cell.word0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        red_add_f32x2(o + 2 * ((c & 1) + 5 * ((c >> 1) & 1) + 25 * (c >> 2)),
                      v[2 * c], v[2 * c + 1]);
    }
  }
}

extern "C" int brick3_table_grad(
    const void* x, const void* g, void* out, int64_t n, int n_levels,
    int rows_per_level, const float* scales, const int* nps,
    const int* dense, void* stream) {
  Brick3Levels lv;
  const int err = brick3_levels(&lv, n_levels, scales, nps, dense);
  if (err) return err;
  if (n > 0) {
    const int64_t blocks = (n + TILE - 1) / TILE;
    const size_t smem = sizeof(float) * TILE * (3 + 2 * n_levels + 1);
    brick3_table_grad_kernel<<<(unsigned)blocks, THREADS, smem,
                               (cudaStream_t)stream>>>(
        (const float*)x, (const float*)g, (float*)out, n, n_levels,
        (uint32_t)rows_per_level, lv);
  }
  return (int)cudaGetLastError();
}
