// Device helpers shared by the port's top-k kernels (cosine_topk.cu,
// ivf_topk.cu): key conversion to f32 and a top-k list held by one warp.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace warp_topk {

constexpr unsigned FULL = 0xffffffffu;
// A list keeps entry j in lane j, so k costs no registers up to a warp's
// 32 lanes: a k=16 probe and a k=4 search run the same code.
constexpr int MAX_K = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v) * (1.0f / 127.0f); }

// (as, ai) ranks before (bs, bi): the higher score, then the lower id. The
// id is a slot id in the exact search and a candidate position in the IVF
// search, which is how each kernel breaks ties.
__device__ __forceinline__ bool ranks_before(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Offers each lane's candidate (s, id), where ok, to a top-k list held by the
// warp: lane j < k holds entry j in (ls, li), sorted by ranks_before, with
// (-inf, -1) for an empty entry. Every lane of the warp must call it.
__device__ __forceinline__ void warp_offer(float s, int id, bool ok, int k, int lane,
                                           float& ls, int& li) {
  float ts = __shfl_sync(FULL, ls, k - 1);
  int ti = __shfl_sync(FULL, li, k - 1);
  bool pass = ok && ranks_before(s, id, ts, ti);
  unsigned mask = __ballot_sync(FULL, pass);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const float cs = __shfl_sync(FULL, s, src);
    const int ci = __shfl_sync(FULL, id, src);
    // the candidate beats entry k-1, so it goes before some entry; the list
    // is sorted, so the entries it beats are a suffix starting at `pos`
    const unsigned beaten = __ballot_sync(FULL, lane < k && ranks_before(cs, ci, ls, li));
    const int pos = __ffs(beaten) - 1;
    const float us = __shfl_up_sync(FULL, ls, 1);
    const int ui = __shfl_up_sync(FULL, li, 1);
    if (lane == pos) {
      ls = cs;
      li = ci;
    } else if (lane > pos && lane < k) {
      ls = us;
      li = ui;
    }
    ts = __shfl_sync(FULL, ls, k - 1);
    ti = __shfl_sync(FULL, li, k - 1);
    pass = pass && lane != src && ranks_before(s, id, ts, ti);
    mask = __ballot_sync(FULL, pass);
  }
}

}  // namespace warp_topk
