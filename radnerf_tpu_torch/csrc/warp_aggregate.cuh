// Warp aggregation of equal keys, shared by the table-gradient scatters
// brick3_table_grad.cu and stream_table_grad.cu (tcnn_table_grad).
//
// The lanes of a warp that hold the same key (the same table entry, or
// the same brick3 cell) form a group (__match_any_sync). Each group sums
// its lanes' values onto its lowest lane, the leader, which then issues
// one reduction per value pair for the whole group. The sum runs in a
// fixed order that depends only on the group's members: a suffix sum by
// pointer jumping over the group's lanes in lane order (step k adds the
// partial sum of the member k ranks ahead), so the same warp contents
// give the same bits on every run. Every lane of the warp must take part
// in every call, active or not: an inactive lane holds a sentinel key and
// never issues a reduction.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WARP_ALL 0xffffffffu

struct WarpGroup {
  int next;      // lane of the next member (lane order), 32 if none
  bool leader;   // the lowest lane of the group
};

template <typename Key>
__device__ __forceinline__ WarpGroup warp_group(Key key) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = __match_any_sync(WARP_ALL, key);
  const unsigned above = mask & ~((2u << lane) - 1u);   // 2u << 31 == 0
  WarpGroup g;
  g.next = above ? __ffs(above) - 1 : 32;
  g.leader = (mask & ((1u << lane) - 1u)) == 0u;
  return g;
}

// v[k] of each group's leader becomes the sum of v[k] over the group;
// other lanes keep partial sums. ceil(log2(largest group)) steps, each one
// shuffle per value.
template <int N>
__device__ __forceinline__ void warp_group_sum(float (&v)[N], int next) {
  const int lane = threadIdx.x & 31;
  while (__any_sync(WARP_ALL, next < 32)) {
    const bool has = next < 32;
    const int src = has ? next : lane;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float o = __shfl_sync(WARP_ALL, v[k], src);
      if (has) v[k] = __fadd_rn(v[k], o);
    }
    const int nn = __shfl_sync(WARP_ALL, next, src);
    next = has ? nn : 32;
  }
}

// One 8-byte vector reduction of (a, b) into p[0], p[1] (sm_90: the
// float2 atomicAdd, compiled to red.global.add.v2.f32 when its result is
// unused). p must be 8-byte aligned.
__device__ __forceinline__ void red_add_f32x2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}
