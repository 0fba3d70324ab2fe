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
// has one: one thread per (sample, level) recomputes the forward's cell
// (brick3_common.cuh, the same arithmetic as brick3_encode_fwd.cu) and
// atomically adds w_corner * g_f into the 8 corner entries of its row
// (16 f32 atomics). No sort, no quantization.
//
// What bounds it on Hopper: bytes. The output is 64 MiB at L = 16,
// T = 2^19 and is zero-filled by the wrapper; the atomics then
// read-modify-write the touched words in L2. x and g are ~17 MB at a
// 131,072-sample microbatch. Atomic order varies from run to run, so the
// f32 sums do too (a few ulp of the sum of |terms|). A privatised or
// warp-aggregated scatter is later work.
#include "brick3_common.cuh"

__global__ void brick3_table_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    float* __restrict__ out, int64_t n, int n_levels, uint32_t rows,
    Brick3Levels lv) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * n_levels) return;
  const int64_t s = i / n_levels;
  const int l = (int)(i - s * n_levels);
  const Brick3Cell cell = brick3_cell(x, s, l, rows, lv);
  // g is (N, 2L) level-major: (feature 0, feature 1) of level l at 2l
  const float g0 = __ldg(g + 2 * i);
  const float g1 = __ldg(g + 2 * i + 1);
  if (g0 == 0.0f && g1 == 0.0f) return;
  float* o = out + 2 * cell.word0;

  const float wx[2] = {__fsub_rn(1.0f, cell.f[0]), cell.f[0]};
  const float wy[2] = {__fsub_rn(1.0f, cell.f[1]), cell.f[1]};
  const float wz[2] = {__fsub_rn(1.0f, cell.f[2]), cell.f[2]};
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wc = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
        float* p = o + 2 * (dx + 5 * dy + 25 * dz);
        atomicAdd(p, __fmul_rn(wc, g0));
        atomicAdd(p + 1, __fmul_rn(wc, g1));
      }
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
  const int64_t total = n * n_levels;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    brick3_table_grad_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)x, (const float*)g, (float*)out, n, n_levels,
        (uint32_t)rows_per_level, lv);
  }
  return (int)cudaGetLastError();
}
