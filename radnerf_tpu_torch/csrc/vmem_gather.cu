// Word gathers from a (R, 128) table of 32-bit words (the bench_vmem_gather
// microbenchmark; the port holds the u32 words as int32 with the same bits):
//
//   tal_sublane       out[i, j] = tbl[rows[i, j], j]      replaces the Pallas
//       kernel examples/bench_vmem_gather.py:54 _tal_kernel (call :60 in
//       tal_sublane): take_along_axis over the rows, the lane fixed;
//   rowgather_onehot  out[i, k] = tbl[row[i, k], lane[i, k]]   replaces
//       examples/bench_vmem_gather.py:72 _rowgather_kernel (call :97 in
//       rowgather_onehot): the general gather tbl.flat[row * 128 + lane].
//
// The TPU kernels stage the table in VMEM and, for the general gather,
// pick the lane with a one-hot sum, because a TPU lane cannot be indexed
// dynamically. A CUDA thread indexes directly: one thread per output word
// reads its row (and lane) coalesced, loads the word through the read-only
// path and writes it coalesced. The 2 MB table does not fit one block's
// 227 KB of shared memory, but it sits in the 50 MB L2, so device memory
// sees it once.
//
// What bounds it on Hopper: bytes. At the microbenchmark's default (E =
// 4,194,304 words, R = 4096) the indices and the output move 32 MiB
// (tal_sublane) or 48 MiB (rowgather_onehot) besides the 2 MiB table:
// 10.6 / 15.6 us at 3.35 TB/s. Each random 4-byte table read still moves
// a 32-byte L2 sector, so the L2 rate, not device memory, is expected to
// bound the gather.
//
// An index outside the table writes 0xFFFFFFFF, the value jnp.take's
// default fill mode gives an unsigned word; the kernel never reads outside
// the table.
#include <cuda_runtime.h>
#include <stdint.h>

template <bool kFixedLane>
__global__ void vmem_gather_kernel(const int* __restrict__ tbl,
                                   const int* __restrict__ row,
                                   const int* __restrict__ lane,
                                   int* __restrict__ out, int64_t n,
                                   int n_rows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = __ldg(row + i);
  const int c = kFixedLane ? (int)(i & 127) : __ldg(lane + i);
  const bool in = (unsigned)r < (unsigned)n_rows && (unsigned)c < 128u;
  out[i] = in ? __ldg(tbl + (((int64_t)r << 7) | c)) : -1;
}

template <bool kFixedLane>
static int launch(const void* tbl, const void* row, const void* lane,
                  void* out, int64_t n, int n_rows, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    vmem_gather_kernel<kFixedLane><<<(unsigned)blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
        (const int*)tbl, (const int*)row, (const int*)lane, (int*)out, n,
        n_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" int tal_sublane(const void* tbl, const void* rows, void* out,
                           int64_t n, int n_rows, void* stream) {
  return launch<true>(tbl, rows, nullptr, out, n, n_rows, stream);
}

extern "C" int rowgather_onehot(const void* tbl, const void* row,
                                const void* lane, void* out, int64_t n,
                                int n_rows, void* stream) {
  return launch<false>(tbl, row, lane, out, n, n_rows, stream);
}
