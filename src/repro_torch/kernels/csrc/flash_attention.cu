// Causal / sliding-window GQA flash attention for prefill, written by hand
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_pallas), the attention of Model.forward:
//   q (B, Lq, H, D); k, v (B, Lk, HKV, D), f32 or bf16 (all three alike);
//   query row i sits at absolute position i + Lk - Lq (the ends aligned) and
//   sees key j when j <= i + Lk - Lq (causal) and, with a window (> 0),
//   j > i + Lk - Lq - window. Query head h reads KV head h / G, G = H / HKV,
//   so no expanded K/V is stored. Products and sums in f32; the output
//   (B, Lq, H, D) is in q's dtype; a row that sees nothing is 0. Unlike the
//   TPU kernel, which asserts Lq % block == 0, ragged tails are masked. The
//   plain version is kernels/ref.py::flash_attention_ref.
//
// Bound on an H100 SXM at the serve path's shape (B = the misses of a batch,
// about 40; Lq = Lk = 64, H = 32, HKV = 4, D = 128, bf16, causal): the bytes,
// q and o 2 * 40 * 64 * 32 * 128 * 2 B = 42 MB and k and v 5 MB, about 14 us
// at 3.35 TB/s; the operations, 4 * D FLOP per visible (query, key, head),
// 40 * 32 * 2,080 * 512 = 1.4 GFLOP, take 1.4 us at the bf16 tensor-core
// rate. So it is bound by bytes.
//
// Design. The TPU kernel's grid walks the KV blocks of a query block in
// sequence, with the running max, sum and accumulator in VMEM scratch, and
// skips dead blocks with pl.when. Here one block of 256 threads handles one
// (query tile of 64 rows, head, batch row) and loops over the KV tiles of 64
// keys itself, from the window's first live tile (0 without a window) to
// the causal edge, so dead tiles are never loaded. The Q tile, one K or V
// tile and the 64 x 64 weights live in shared memory as f32 (83 KB at
// D = 128: two blocks an SM); scores never reach device memory. The 16 x 16
// threads each own a 4 x 4 patch of the scores (rows ty*4.., keys tx + 16 j)
// and a 4 x D/16 patch of the accumulator (rows ty*4.., columns tx + 16 j)
// with its rows' running max and sum in registers; a row's statistics are
// reduced over the 16 lanes that share it by shuffles. Plain f32 FMAs,
// no tensor cores: wgmma with TMA staging is later work. Shared-memory rows
// are padded to D + 1 floats so the 16 key rows of a score step fall in 16
// banks. D is 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using attn::from_f32;

constexpr int NT = 256;   // 16 x 16 threads
constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int PS = BK + 1;

// sum / max over the 16 lanes of a half warp (the threads of one ty)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Lq, Lk, H, HKV, causal, window;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + BQ * PS);
}

// rows [r0, r0 + 64) of a (B, L, heads, D) tensor at (b, head) into a
// (64, D + 1) f32 tile; rows at or past L are 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b, int head, int heads,
                                          int r0, int L) {
  attn::stage_rows<T, NT>(
      dst, D + 1, BQ, D,
      [=](int r) -> const T* {
        const int row = r0 + r;
        return row < L ? src + ((static_cast<size_t>(b) * L + row) * heads + head) * D : nullptr;
      },
      [](int) { return 1.f; });
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(Args a) {
  constexpr int QS = D + 1;
  constexpr int NC = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // (BQ, QS)
  float* kvs = qs + BQ * QS;     // (BK, QS): the K tile, then the V tile
  float* ps = kvs + BK * QS;     // (BQ, PS) weights

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.HKV);
  const int offset = a.Lk - a.Lq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_tile<T, D>(qs, q, b, h, a.H, q0, a.Lq);

  // live KV tiles: from the window's first (query row q0) to the causal
  // edge (the tile's last real row); negative bounds divide toward 0 and
  // clamp, so a tile that sees nothing loops over nothing
  const int q_lo = offset + q0;
  const int q_hi = offset + min(q0 + BQ, a.Lq) - 1;
  const int n_tiles = (a.Lk + BK - 1) / BK;
  const int t_end = a.causal ? min(n_tiles, (q_hi + BK) / BK) : n_tiles;
  const int t_begin = a.window > 0 ? max(0, (q_lo - a.window + 1) / BK) : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous V tile is consumed
    load_tile<T, D>(kvs, k, b, kvh, a.HKV, k0, a.Lk);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kvs[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty * 4 + i;   // absolute position of the row
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool vis = kp < a.Lk;
        if (a.causal) vis = vis && kp <= qp;
        if (a.window > 0) vis = vis && kp > qp - a.window;
        s[i][j] = vis ? s[i][j] * a.scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = half_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      // m_new is -inf only while the row has seen nothing: weights 0, no
      // rescale (the accumulator is still 0)
      const float c = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rsum += p;
      }
      rsum = half_sum(rsum);
      l[i] = l[i] * c + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= c;
    }
    __syncthreads();   // the K tile is consumed, the weights written
    load_tile<T, D>(kvs, v, b, kvh, a.HKV, k0, a.Lk);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vb[j] = kvs[kk * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;   // one opt-in per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = float32,
// 1 = bfloat16, for q, k, v and out alike; every tensor contiguous in the
// layout of the header. causal: 0 or 1; window <= 0 means no window.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int dtype,
                           int B, int Lq, int Lk, int H, int HKV, int D, int causal, int window,
                           float scale, void* stream) {
  if (B < 1 || B > 65535 || Lq < 1 || Lk < 1 || HKV < 1 || H < HKV || H > 65535 ||
      H % HKV != 0 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, Lq, Lk, H, HKV, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(a, D, st));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(a, D, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
