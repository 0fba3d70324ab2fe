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
// Indices outside the table, as the JAX kernels take them: a row in
// [-R, 0) reads row R + r (take_along_axis counts it from the end); a row
// outside [-R, R) gives 0xFFFFFFFF (-1), take_along_axis's fill for an
// unsigned word; in rowgather_onehot a lane outside [0, 128) gives 0,
// whatever the row, because the one-hot sum matches no lane. No kernel
// reads outside the table.
//
// What bounds them on Hopper. At the microbenchmark's default (E =
// 4,194,304 words, R = 4096: a 2 MiB table) the indices and the output
// move 32 MiB (tal_sublane) or 48 MiB (rowgather_onehot), 10.6 / 15.6 us
// at 3.35 TB/s. A thread that reads its word of the table from L2 makes
// one random 4-byte read, which moves a whole 32-byte L2 sector: E such
// reads alone take ~0.032 ms on an H100, and they, not the stream, set the
// pace of a gather through L2.
//
//   tal_sublane stages the table in shared memory. The lane is fixed by
//   the output column, so a block that serves the lanes [8g, 8g + 8) needs
//   only tbl[:, 8g:8g + 8], R x 32 bytes (128 KiB at R = 4096). The grid is
//   the 16 lane groups x row chunks, about one block an SM. A block
//   stages its slice with cp.async and loads its first indices before it
//   waits on the copy, then streams its index rows' 8-lane segments (one
//   32-byte sector each) with evict-first loads and stores. It takes
//   tables up to 7264 rows (232,448 bytes of shared memory a block); a
//   larger table goes to tal_sublane_l2, a thread a word through L2; the
//   caller picks by R (radnerf_tpu_torch/examples/bench_vmem_gather.py).
//   The table must be 16-byte aligned (cp.async), which the caller checks.
//
//   rowgather_onehot reads a word from anywhere in the table, so no lane
//   split applies, and one block cannot hold the table. It gives each word
//   a thread that reads the table through L2 and streams the indices and
//   the output with evict-first loads and stores. The table staged across
//   a thread block cluster of 16 (distributed shared memory) measured
//   slower: random 4-byte reads of another block's shared memory run at
//   about half the L2's rate, and only 7 clusters of 16 fit 132 SMs
//   (PERF.md, the gathers' design steps).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kLanes = 128;
constexpr int kChunks = kLanes / 4;   // 16-byte chunks a table row
constexpr int kThreads = 1024;        // tal_sublane: one block an SM
constexpr int kUnroll = 4;            // segments a thread loads ahead
constexpr int kSlice = 8;             // lanes a block stages
constexpr int kGroups = kLanes / kSlice;

// The row r names in a table of n_rows rows: [-n_rows, 0) counts from the
// end; any row outside [-n_rows, n_rows) comes out >= n_rows.
__device__ __forceinline__ unsigned table_row(int r, int n_rows) {
  return (unsigned)(r < 0 ? r + n_rows : r);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread a word, the table read through L2 (any R), the indices and the
// output streamed evict-first.
template <bool kFixedLane>
__global__ void gather_words_kernel(const int* __restrict__ tbl,
                                    const int* __restrict__ row,
                                    const int* __restrict__ lane,
                                    int* __restrict__ out, int64_t n,
                                    int n_rows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned r = table_row(__ldcs(row + i), n_rows);
  const int c = kFixedLane ? (int)(i & (kLanes - 1)) : __ldcs(lane + i);
  int v = 0;
  if ((unsigned)c < (unsigned)kLanes)
    v = r < (unsigned)n_rows ? __ldg(tbl + (((int64_t)r << 7) | c)) : -1;
  __stcs(out + i, v);
}

// tal_sublane, staged: block (g, c) serves the lanes [8g, 8g + 8) of the
// index rows of chunk c; its thread t takes lane t % 8 of segments
// t / 8, t / 8 + 128, ... of the chunk. Shared memory: slice[r * 8 + l] =
// tbl[r, 8g + l].
__global__ void __launch_bounds__(kThreads)
    tal_staged_kernel(const int* __restrict__ tbl,
                      const int* __restrict__ rows, int* __restrict__ out,
                      int64_t n_seg, int n_rows) {
  extern __shared__ int4 slice4[];
  const int* slice = reinterpret_cast<const int*>(slice4);
  const int g = blockIdx.x;
  const int4* src = reinterpret_cast<const int4*>(tbl) + 2 * g;
  for (int k = threadIdx.x; k < 2 * n_rows; k += kThreads)
    cp_async16(slice4 + k, src + (int64_t)(k >> 1) * kChunks + (k & 1));
  cp_async_commit();

  constexpr int kPass = kThreads / kSlice;   // segments a pass
  const int l = threadIdx.x & (kSlice - 1);
  const int* in = rows + kSlice * g + l;     // segment s's word: in[s * 128]
  int* dst = out + kSlice * g + l;
  const int64_t per = (n_seg + gridDim.y - 1) / gridDim.y;
  const int64_t end = min(n_seg, per * (blockIdx.y + 1));
  int64_t s = per * blockIdx.y + threadIdx.x / kSlice;
  int r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t t = s + u * kPass;
    r[u] = t < end ? __ldcs(in + t * kLanes) : 0;
  }
  cp_async_wait_all();
  __syncthreads();
  for (; s < end; s += kUnroll * kPass) {
    int next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = s + (kUnroll + u) * kPass;
      next[u] = t < end ? __ldcs(in + t * kLanes) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = s + u * kPass;
      if (t < end) {
        const unsigned row = table_row(r[u], n_rows);
        __stcs(dst + t * kLanes,
               row < (unsigned)n_rows ? slice[row * kSlice + l] : -1);
      }
      r[u] = next[u];
    }
  }
}

template <bool kFixedLane>
int launch_words(const void* tbl, const void* row, const void* lane,
                 void* out, int64_t n, int n_rows, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    gather_words_kernel<kFixedLane><<<(unsigned)blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
        (const int*)tbl, (const int*)row, (const int*)lane, (int*)out, n,
        n_rows);
  }
  return (int)cudaGetLastError();
}

// A refused call returns its error and clears it, so that the next
// launch's cudaGetLastError() does not report it again.
int refused(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" int tal_sublane_l2(const void* tbl, const void* rows, void* out,
                              int64_t n, int n_rows, void* stream) {
  return launch_words<true>(tbl, rows, nullptr, out, n, n_rows, stream);
}

extern "C" int rowgather_onehot(const void* tbl, const void* row,
                                const void* lane, void* out, int64_t n,
                                int n_rows, void* stream) {
  return launch_words<false>(tbl, row, lane, out, n, n_rows, stream);
}

extern "C" int tal_sublane(const void* tbl, const void* rows, void* out,
                           int64_t n, int n_rows, void* stream) {
  const int64_t n_seg = n / kLanes;
  if (n_seg <= 0) return (int)cudaGetLastError();
  const int smem = n_rows * kSlice * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tal_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tal_staged_kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorLaunchOutOfResources;
  if (err != cudaSuccess) return refused(err);
  // about one block an SM: the lane groups x as many row chunks as fit
  const int64_t chunks = std::max<int64_t>(
      1, std::min<int64_t>(n_seg, (int64_t)per_sm * sms / kGroups));
  tal_staged_kernel<<<dim3(kGroups, (unsigned)chunks), kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const int*)tbl, (const int*)rows, (int*)out, n_seg, n_rows);
  return (int)cudaGetLastError();
}
