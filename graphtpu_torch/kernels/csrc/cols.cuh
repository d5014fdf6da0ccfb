// Per-thread column access shared by the kernels of csrc/: each thread owns
// kCols consecutive columns of a row, read and written with one 16-byte
// (f32) or 8-byte (4 bf16) access when `vec` holds, else element by element
// with the ragged edge (col >= c) masked; or, for bf16 rows, kCols16
// columns with one 16-byte access.  Values are f32 in registers; bf16 is
// widened on load and rounded to nearest even on store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace gt {

constexpr int kThreads = 256;
constexpr int kCols = 4;                     // columns per thread
constexpr int kTile = kThreads * kCols;      // columns per block
constexpr int kCols16 = 8;                   // bf16 columns per thread in one 16-byte access

__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int64_t col0, int64_t c, bool vec,
                                          float (&v)[kCols]) {
  if (vec) {
    if (col0 < c) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + col0));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      v[e] = (col0 + e < c) ? __ldg(row + col0 + e) : 0.f;
  }
}

__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ row,
                                          int64_t col0, int64_t c, bool vec,
                                          float (&v)[kCols]) {
  if (vec) {
    if (col0 < c) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(row + col0));
      __nv_bfloat16 h[kCols];
      memcpy(h, &q, sizeof(q));
#pragma unroll
      for (int e = 0; e < kCols; ++e) v[e] = __bfloat162float(h[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kCols; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      v[e] = (col0 + e < c) ? __bfloat162float(row[col0 + e]) : 0.f;
  }
}

__device__ __forceinline__ void store_cols(float* __restrict__ row, int64_t col0,
                                           int64_t c, bool vec,
                                           const float (&v)[kCols]) {
  if (vec) {
    if (col0 < c)
      *reinterpret_cast<float4*>(row + col0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      if (col0 + e < c) row[col0 + e] = v[e];
  }
}

__device__ __forceinline__ void store_cols(__nv_bfloat16* __restrict__ row,
                                           int64_t col0, int64_t c, bool vec,
                                           const float (&v)[kCols]) {
  __nv_bfloat16 h[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) h[e] = __float2bfloat16_rn(v[e]);
  if (vec) {
    if (col0 < c) {
      uint2 q;
      memcpy(&q, h, sizeof(q));
      *reinterpret_cast<uint2*>(row + col0) = q;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      if (col0 + e < c) row[col0 + e] = h[e];
  }
}

__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ row,
                                          int64_t col0, int64_t c, bool vec,
                                          float (&v)[kCols16]) {
  if (vec) {
    if (col0 < c) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + col0));
      __nv_bfloat16 h[kCols16];
      memcpy(h, &q, sizeof(q));
#pragma unroll
      for (int e = 0; e < kCols16; ++e) v[e] = __bfloat162float(h[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kCols16; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols16; ++e)
      v[e] = (col0 + e < c) ? __bfloat162float(row[col0 + e]) : 0.f;
  }
}

__device__ __forceinline__ void store_cols(__nv_bfloat16* __restrict__ row, int64_t col0,
                                           int64_t c, bool vec, const float (&v)[kCols16]) {
  __nv_bfloat16 h[kCols16];
#pragma unroll
  for (int e = 0; e < kCols16; ++e) h[e] = __float2bfloat16_rn(v[e]);
  if (vec) {
    if (col0 < c) {
      uint4 q;
      memcpy(&q, h, sizeof(q));
      *reinterpret_cast<uint4*>(row + col0) = q;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols16; ++e)
      if (col0 + e < c) row[col0 + e] = h[e];
  }
}

}  // namespace gt
