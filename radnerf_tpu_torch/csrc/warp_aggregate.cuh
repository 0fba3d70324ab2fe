// Warp aggregation of equal keys, shared by the table-gradient scatters
// brick3_table_grad.cu and stream_table_grad.cu (tcnn_table_grad,
// slab_table_grad, brick_table_grad).
//
// The lanes of a warp that hold the same key (the same table entry, or
// the same brick3 cell) form a group (__match_any_sync). Each group sums
// its lanes' values onto its lowest lane, the leader, which then issues
// the reductions for the whole group. The sum runs in a fixed order that
// depends only on the group's members: a suffix sum by pointer jumping
// over the group's lanes in lane order (step k adds the partial sum of
// the member k ranks ahead), so the same warp contents give the same bits
// on every run. Every lane of the warp must take part in every call,
// active or not: an inactive lane holds a sentinel key and never issues a
// reduction.
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

// One 16-byte vector reduction of (a, b, c, d) into p[0..3] (sm_90: the
// float4 atomicAdd, red.global.add.v4.f32 when its result is unused).
// p must be 16-byte aligned.
__device__ __forceinline__ void red_add_f32x4(float* p, float a, float b,
                                              float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// Adds (v[0], v[1]) to the (feature 0, feature 1) pair of flat entry e of
// an (entries, 2) f32 table o and (v[2], v[3]) to entry e + 1; `first`
// and `second` say whether each entry exists (false: dropped). An entry
// whose two values are both zero is skipped. Where both are written and
// e is even, the four floats are 16-byte aligned (o must be) and go as
// one 16-byte reduction; else one 8-byte reduction per entry written.
__device__ __forceinline__ void red_add_entry_pair(float* o, int64_t e,
                                                   const float* v,
                                                   bool first, bool second) {
  first = first && (v[0] != 0.0f || v[1] != 0.0f);
  second = second && (v[2] != 0.0f || v[3] != 0.0f);
  if (first && second && (e & 1) == 0) {
    red_add_f32x4(o + 2 * e, v[0], v[1], v[2], v[3]);
    return;
  }
  if (first) red_add_f32x2(o + 2 * e, v[0], v[1]);
  if (second) red_add_f32x2(o + 2 * e + 2, v[2], v[3]);
}
