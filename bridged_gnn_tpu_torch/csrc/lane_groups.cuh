// Lane-group helpers shared by the attention kernels (attention_fwd.cu,
// attention_bwd.cu), and the 4-column loads and stores and element types
// that they and the sender reduce (slot_reduce.cu) take.
//
// A destination row's lanes split into groups of kG lanes; lane gl of a
// group holds columns 4·(gl + kG·i) + j for i < kPer, j < 4, so the padded
// width is 4·kG·kPer. Loads and stores move those 4 columns at once: one
// vector access when kVec (D % 4 == 0 and the tensor aligned to 4
// elements: 16 bytes in f32, 8 in bf16), scalar ones otherwise.
//
// Message tables (u1, u2, ud) and the backward's dm are float or
// __nv_bfloat16, chosen at compile time; every other tensor is float. A
// bf16 element is widened to f32 on load and rounded once, to nearest
// even, on store, through cuda_bf16.h's intrinsics only; all arithmetic is
// f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// A row with more than kHeavySlots slots gets a thread block of its own
// (the reason is in attention_fwd.cu's header); = HEAVY_SLOTS in Python.
constexpr int kHeavySlots = 128;
// The widest row a lane group holds in registers: 32 lanes of kPer = 2 ×
// 4 columns. Wider rows take each attention kernel's wide path, chosen at
// launch; = LANE_GROUP_COLUMNS in Python.
constexpr int kLaneGroupColumns = 256;

// kStream marks data read once (evict-first in L2), so that it leaves the
// cache to the u tables.
template <bool kVec, bool kStream = false>
__device__ __forceinline__ void load4(const float* __restrict__ p, int c,
                                      int d, float (&v)[4]) {
  if (kVec) {  // d % 4 == 0 and p 16-byte aligned: c < d covers c + 3
    if (c < d) {
      const float4* q = reinterpret_cast<const float4*>(p + c);
      const float4 t = kStream ? __ldcs(q) : *q;
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c + j < d ? (kStream ? __ldcs(p + c + j) : p[c + j]) : 0.f;
  }
}

// Output rows are written once and not read again: streaming stores.
template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ p, int c, int d,
                                       const float (&v)[4]) {
  if (kVec) {
    if (c < d) __stcs(reinterpret_cast<float4*>(p + c),
                      make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < d) __stcs(p + c + j, v[j]);
  }
}

// Four bf16 columns as one 8-byte access.
union Bf16x4 {
  uint2 u;
  __nv_bfloat162 h[2];
};

template <bool kVec, bool kStream = false>
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p,
                                      int c, int d, float (&v)[4]) {
  if (kVec) {  // d % 4 == 0 and p 8-byte aligned: c < d covers c + 3
    if (c < d) {
      const uint2* q = reinterpret_cast<const uint2*>(p + c);
      Bf16x4 t;
      t.u = kStream ? __ldcs(q) : *q;
      const float2 lo = __bfloat1622float2(t.h[0]);
      const float2 hi = __bfloat1622float2(t.h[1]);
      v[0] = lo.x;
      v[1] = lo.y;
      v[2] = hi.x;
      v[3] = hi.y;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c + j < d
                 ? __bfloat162float(kStream ? __ldcs(p + c + j) : p[c + j])
                 : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ p, int c,
                                       int d, const float (&v)[4]) {
  if (kVec) {
    if (c < d) {
      Bf16x4 t;
      t.h[0] = __floats2bfloat162_rn(v[0], v[1]);
      t.h[1] = __floats2bfloat162_rn(v[2], v[3]);
      __stcs(reinterpret_cast<uint2*>(p + c), t.u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < d) __stcs(p + c + j, __float2bfloat16_rn(v[j]));
  }
}

// One element, widened to f32 or rounded from it.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// G = min(32, ⌈D/4⌉) rounded up to a power of two: the lanes of one group.
// The launchers switch on it and take kPer = 2 at G = 32 past D = 128, so
// that 4·G·kPer >= D up to kLaneGroupColumns.
__host__ __device__ constexpr int group_lanes(int d) {
  return d <= 4 ? 1 : d <= 8 ? 2 : d <= 16 ? 4 : d <= 32 ? 8
         : d <= 64 ? 16 : 32;
}

template <int kG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Light rows per warp: at D <= 8 a row of the main path (~33 slots) would
// leave most of a warp's 16 or 32 groups idle, so 2 (or, at D <= 4, 4) rows
// share a warp, each on a sub-warp of 32/kRows lanes.
__host__ __device__ constexpr int light_rows_per_warp(int g) {
  return g == 1 ? 4 : (g == 2 ? 2 : 1);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A tensor of T aligned for kVec's 4-element accesses: 16 bytes in f32, 8
// in bf16.
template <typename T>
inline bool aligned_vec(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

}  // namespace
