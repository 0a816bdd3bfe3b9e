// Shared by the attention kernels: element conversions (flash_attention.cu,
// decode_attention.cu), and the staging of rows from device memory into f32
// shared memory in 16-byte loads, several in flight per thread
// (flash_attention.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements of T in one 16-byte load
template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// Stage `rows` rows of `d` elements (d * sizeof(T) a multiple of 16) into
// dst (row r at dst + r * dst_stride) as f32 times scale(r), by the NT
// threads of the block: row r starts at src(r), a 16-byte aligned pointer,
// or is zero when src(r) is null (a row past the sequence, an invisible
// slot: its weight is 0, and 0 * a stale NaN would not be). Each thread
// issues up to 4 loads before it stores any, so a block keeps 4 * NT loads
// in flight instead of waiting on one at a time.
template <typename T, int NT, typename Src, typename Scale>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride, int rows, int d,
                                           Src src, Scale scale) {
  constexpr int ROUND = 4;
  const int cpr = d / kVec<T>;   // chunks per row
  const int n = rows * cpr;
  for (int c0 = 0; c0 < n; c0 += NT * ROUND) {
    uint4 buf[ROUND];
    const T* from[ROUND];
#pragma unroll
    for (int u = 0; u < ROUND; ++u) {
      const int c = c0 + static_cast<int>(threadIdx.x) + u * NT;
      from[u] = c < n ? src(c / cpr) : nullptr;
      if (from[u] != nullptr)
        buf[u] = *reinterpret_cast<const uint4*>(from[u] + (c % cpr) * kVec<T>);
    }
#pragma unroll
    for (int u = 0; u < ROUND; ++u) {
      const int c = c0 + static_cast<int>(threadIdx.x) + u * NT;
      if (c >= n) continue;
      const int r = c / cpr;
      float* out = dst + r * dst_stride + (c % cpr) * kVec<T>;
      if (from[u] == nullptr) {
#pragma unroll
        for (int i = 0; i < kVec<T>; ++i) out[i] = 0.f;
        continue;
      }
      const float s = scale(r);
      const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
      for (int i = 0; i < kVec<T>; ++i) out[i] = to_f32(e[i]) * s;
    }
  }
}

}  // namespace attn
