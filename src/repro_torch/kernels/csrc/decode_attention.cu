// Single-token decode attention over a (ring) KV cache, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_decode_kernel
// (decode_attention_pallas), the attention of Model.decode_step. One query
// token per sequence attends over every visible slot of one layer's cache:
//   q (B, 1, H, D) f32 or bf16; k, v (B, S, HKV, D) f32, bf16 or int8 with
//   per-(b, s, kv-head) f32 scales; slot_pos (S,) int32, -1 = empty; pos.
// Slot s is visible when 0 <= slot_pos[s] <= pos and, with a window (> 0),
// slot_pos[s] > pos - window or slot_pos[s] < n_sink. Visibility comes from
// slot_pos alone, so a ring never needs unrotating. Query head h reads KV
// head h / G, G = H / HKV. The output (B, 1, H, D) is in q's dtype; a row
// with no visible slot is 0 (the TPU kernel's l = max(l, 1e-30)). The plain
// version is kernels/ref.py::decode_attention_ref.
//
// Bound on an H100 SXM at the serve path's shape (B = the misses of a batch,
// about 40; S = 96 slots, of which 65-88 are visible over the 23 decode
// steps; H = 32, HKV = 4, D = 128, bf16): the bytes of the visible K and V,
// about 40 * 77 * 4 * 128 * 2 B * 2 = 6.3 MB, or 1.9 us at 3.35 TB/s, while
// the operations (4 * D FLOP per query head and visible slot, 50 MFLOP) take
// 0.05 us at the bf16 rate. So it is bound by bytes.
//
// Design. The TPU kernel's grid walks S in sequence with the online-softmax
// statistics in VMEM scratch. Here one block of 128 threads handles one
// (b, kv-head) and walks S in tiles of 64 slots itself, with a running max,
// sum and f32 accumulator per query head, so the K and V of a group are read
// once for its G query heads, as the TPU kernel's (G, D) tile does.
//   Scores: the 4 warps take the tile's slots round robin; a warp skips an
//     invisible slot without loading it, else each lane loads D / 32
//     elements of the K row (lane + 32 e: one coalesced load per e), turns
//     them to f32 (int8 times the slot's scale, after the load, so device
//     memory moves 1 byte an element) and forms its part of the G dot
//     products against the queries held in shared memory; a butterfly adds
//     the 32 parts.
//   Softmax: one warp per query head takes the tile's 64 scores (2 a lane),
//     updates the running max, rescales, and writes the weights back.
//   P.V: thread t owns columns t and t + 128 of all G heads in registers
//     and reads each visible V row once, coalesced.
// Staging each tile's K and V rows in shared memory first, all loads in
// flight (as flash_attention.cu does), was tried and left the time where it
// was (0.064 against 0.062 ms at the serve shape on an H100 SXM), and
// slowed it to 0.160 ms with one block per query head: what bounds this
// kernel is not yet known (PERF.md).
// No split of S across blocks (flash-decoding): at S = 96 a block has two
// tiles of work, and B * HKV = 160 blocks cover the 132 SMs. With B * HKV
// well under the SM count and a long cache, a split of S with a merge pass
// is the next step. Limits: G <= 16, D a multiple of 32 up to 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;

constexpr int NT = 128;        // threads per block: 4 warps
constexpr int NW = NT / 32;
constexpr int TS = 64;         // cache slots per tile
constexpr int MAX_G = 16;      // query heads per KV head
constexpr int MAX_D = 256;     // head dim
constexpr int MAX_EPL = MAX_D / 32;
constexpr int MAX_COLS = MAX_D / NT;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;   // (B, S, HKV) for int8 caches, else unused
  const float* v_scale;
  const int* slot_pos;
  void* out;
  int B, S, H, HKV, D, pos, window, n_sink;
  float scale;
};

template <typename QT, typename KT>
__global__ void __launch_bounds__(NT) decode_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int G = a.H / a.HKV;
  const int D = a.D;
  float* qs = smem;                        // (G, D) queries, f32
  float* sc = qs + G * D;                  // (G, TS + 1) scores, then weights
  float* corr = sc + G * (TS + 1);         // (G,) rescale of this tile
  float* lsum = corr + G;                  // (G,) running sums
  float* mrun = lsum + G;                  // (G,) running maxima
  int* vis = reinterpret_cast<int*>(mrun + G);   // (TS,) slot visible?

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const QT* q = static_cast<const QT*>(a.q) + (static_cast<size_t>(b) * a.H + kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) qs[i] = to_f32(q[i]);
  if (tid < G) {
    lsum[tid] = 0.f;
    mrun[tid] = -INFINITY;
  }
  const int epl = D / 32;
  float acc[MAX_G][MAX_COLS];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) acc[g][c] = 0.f;

  const size_t row_stride = static_cast<size_t>(a.HKV) * D;   // between slots
  const KT* kbase = static_cast<const KT*>(a.k) + static_cast<size_t>(b) * a.S * row_stride +
                    static_cast<size_t>(kvh) * D;
  const KT* vbase = static_cast<const KT*>(a.v) + static_cast<size_t>(b) * a.S * row_stride +
                    static_cast<size_t>(kvh) * D;
  const size_t scale_base = static_cast<size_t>(b) * a.S * a.HKV + kvh;
  const bool quantized = a.k_scale != nullptr;

  for (int s0 = 0; s0 < a.S; s0 += TS) {
    __syncthreads();   // qs written / the previous tile's weights consumed
    // ---- scores of the tile's slots --------------------------------------
    for (int j = warp; j < TS; j += NW) {
      const int s = s0 + j;
      bool visible = false;
      if (s < a.S) {
        const int sp = a.slot_pos[s];
        visible = sp >= 0 && sp <= a.pos;
        if (a.window > 0) visible = visible && (sp > a.pos - a.window || sp < a.n_sink);
      }
      if (lane == 0) vis[j] = visible;
      if (!visible) {
        for (int g = lane; g < G; g += 32) sc[g * (TS + 1) + j] = -INFINITY;
        continue;
      }
      const KT* krow = kbase + static_cast<size_t>(s) * row_stride;
      float kv[MAX_EPL];
#pragma unroll
      for (int e = 0; e < MAX_EPL; ++e)
        kv[e] = e < epl ? to_f32(krow[lane + 32 * e]) : 0.f;
      if (quantized) {
        const float ks = a.k_scale[scale_base + static_cast<size_t>(s) * a.HKV];
#pragma unroll
        for (int e = 0; e < MAX_EPL; ++e) kv[e] *= ks;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < MAX_EPL; ++e)
            if (e < epl) part = fmaf(qs[g * D + lane + 32 * e], kv[e], part);
          part = warp_sum(part);
          if (lane == 0) sc[g * (TS + 1) + j] = part * a.scale;
        }
      }
    }
    __syncthreads();
    // ---- online softmax, one warp per query head --------------------------
    for (int g = warp; g < G; g += NW) {
      float* row = sc + g * (TS + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      const float tmax = warp_max(fmaxf(x0, x1));
      const float m_old = mrun[g];
      const float m_new = fmaxf(m_old, tmax);
      // m_new is -inf only while nothing has been visible: weights 0, no
      // rescale (the accumulator is still 0)
      const float c = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      const float p0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float tsum = warp_sum(p0 + p1);
      if (lane == 0) {
        lsum[g] = lsum[g] * c + tsum;
        mrun[g] = m_new;
        corr[g] = c;
      }
    }
    __syncthreads();
    // ---- acc = acc * corr + P . V ----------------------------------------
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) {
        const float c = corr[g];
#pragma unroll
        for (int cc = 0; cc < MAX_COLS; ++cc) acc[g][cc] *= c;
      }
    const int jmax = min(TS, a.S - s0);
    for (int j = 0; j < jmax; ++j) {
      if (!vis[j]) continue;
      const int s = s0 + j;
      const KT* vrow = vbase + static_cast<size_t>(s) * row_stride;
      const float vs = quantized ? a.v_scale[scale_base + static_cast<size_t>(s) * a.HKV] : 1.f;
#pragma unroll
      for (int cc = 0; cc < MAX_COLS; ++cc) {
        const int col = tid + NT * cc;
        if (col < D) {
          const float vv = to_f32(vrow[col]) * vs;
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) acc[g][cc] = fmaf(sc[g * (TS + 1) + j], vv, acc[g][cc]);
        }
      }
    }
  }
  __syncthreads();
  QT* out = static_cast<QT*>(a.out) + (static_cast<size_t>(b) * a.H + kvh * G) * D;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G) {
      const float l = fmaxf(lsum[g], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < MAX_COLS; ++cc) {
        const int col = tid + NT * cc;
        if (col < D) out[g * D + col] = from_f32<QT>(acc[g][cc] / l);
      }
    }
}

template <typename QT, typename KT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.HKV;
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * a.D + G * (TS + 1) + 3 * G) +
                      sizeof(int) * TS;
  decode_attention_kernel<QT, KT><<<dim3(a.HKV, a.B), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(const Args& a, int kv_dtype, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(a, stream);
    case 1:
      return launch<QT, __nv_bfloat16>(a, stream);
    case 2:
      return launch<QT, int8_t>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). q_dtype: 0 = float32,
// 1 = bfloat16 (out has q's dtype); kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8, which needs k_scale and v_scale (B, S, HKV) f32. Every tensor is
// contiguous in the layout of the header. window <= 0 means no window.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* slot_pos, void* out, int q_dtype,
                            int kv_dtype, int B, int S, int H, int HKV, int D, int pos,
                            int window, int n_sink, float scale, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || HKV < 1 || HKV > 65535 || H < HKV || H % HKV != 0 ||
      H / HKV > MAX_G || D < 32 || D > MAX_D || D % 32 != 0 ||
      (kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(slot_pos), out, B, S, H, HKV, D, pos, window, n_sink,
               scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return static_cast<int>(launch_kv<float>(a, kv_dtype, st));
    case 1:
      return static_cast<int>(launch_kv<__nv_bfloat16>(a, kv_dtype, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
