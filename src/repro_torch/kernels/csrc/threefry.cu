// Counter-based draws of the reference's jax.random streams, written by hand
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference draws its weights, its IVF centroids
// and its k-means seeds with jax.random (threefry2x32, XLA's own code), and
// the port must draw the same numbers on the card that it draws on the CPU
// and that JAX draws. The plain version is kernels/ref.py::threefry_fill_ref;
// the wrapper is kernels/threefry.py. Two layouts, as jax's
// jax_threefry_partitionable flag picks them: threefry_kernel (on) and
// threefry_pairs_kernel (off, below).
//
// Partitionable layout. Element i of a draw of n at counter offset o hashes
// the 64-bit counter
// c = o + i, split into words (c >> 32, c & 0xFFFFFFFF) as
// jax._src.prng.iota_2x32_shape splits a flat index, under the key (k0, k1),
// to (b0, b1); its 32 bits are b0 ^ b1. kind 0 writes the bits (int64,
// zero-extended); kind 1 the uniform max(lo, fma(f, hi - lo, lo)), f the float
// [1, 2) built from the bits' top 23 minus 1 (jax.random.uniform); kind 2
// scale * (sqrt(2) * erfinv(u)), u that uniform at lo = nextafter(-1, 0),
// hi = 1 (jax.random.normal, then the caller's scale), stored as f32 or as
// bf16 rounded to nearest even. Every element depends on (key, c) alone, so
// a matrix of a stacked parameter, or a rank's rows of it, is drawn by itself
// at its counter offset.
//
// Arithmetic. The hash is exact integer work. The float tail rounds each
// step as the plain version does, with no contraction: __fadd_rn/__fmul_rn
// (nvcc would otherwise fuse a * b + c into one FMA), IEEE sqrtf, and
// fmaf where XLA's CPU code fuses (the uniform's scale and shift, and the
// Horner steps of Giles' erfinv polynomial: with them the plain version's
// normals equal JAX's bit for bit on 98.7% of draws, 95.0% without). So
// bits equal the plain version's exactly, and uniforms too wherever the
// FMA's product is exact (span 1 or 2: every uniform the port draws); else
// they differ only where the plain version's f64 emulation of an FMA rounds
// twice. Normals differ only where log1pf and the CPU's log1p round apart.
//
// Bound on an H100 SXM: the integer work on the ALU pipe. As nvcc 12.9
// compiles the bf16 normal for sm_90a (cuobjdump -sass, the loop's common
// path), a draw issues 151 instructions. 71 run on the ALU (64 lanes an
// SM): the hash's 13 IADD3 (the counter's 64-bit add, the key and
// injection adds, three-input, merged with a round's add where they meet),
// 20 SHF rotates and 21 LOP3 xors, and 17 of the tail (compares, min/max,
// select, the mantissa's LEA.HI, the store address, log1pf's reduction,
// the bf16 pack). 56 run on the FMA pipe: 16 of the rounds' adds, which
// nvcc issues as IMAD.IADD, 7 more IMAD (IMAD only on the pipe's heavy
// half, 64 lanes) and 33 FP32 operations (128 lanes). The rest: 15 LDC of
// the erfinv coefficients, 7 branch and convergence, 1 I2FP, 1 STG. At
// 64 lanes x 132 SMs x 1.98 GHz the ALU's 71 take 4.25 ns per thousand
// draws (the issue slots, 151 at 4 warp instructions a clock an SM, 4.51),
// against 0.6 ns to write them as bf16 at 3.35 TB/s (1.2 as f32). Design:
// a grid-stride loop, one draw a thread a step, blocks of 256 threads, as
// many blocks as fill every SM (8 an SM); stores are coalesced, the key
// and the offset sit in registers, and nothing is read but the erfinv
// coefficients, from the constant cache.
//
// Original layout (jax/_src/prng.py:1092-1135, 1203-1222 in jax 0.9.0): a
// draw of n <= 2^32 - 1 elements (a block of a larger one; the host splits
// the blocks' keys and launches one a block) hashes the uint32 pairs
// (j, j + h), h = ceil(n / 2), where j + h < n, else (j, 0), the odd size's
// pad; element i < h takes word 0 of pair i, element i >= h word 1 of pair
// i - h, and the 32 bits are that word alone. One thread a pair: it hashes
// once and writes each of the pair's two elements that falls in the
// launch's window [first, first + count), so a whole draw costs one hash
// per two draws. A window needs the pairs [first, min(end, h)) and
// [max(first, h) - h, end - h); where they meet they are one range, else
// the threads run over the first and then the second. Element values are
// the partitionable kernel's (the same store code) from their bits.
// Bound on an H100 SXM: the ALU pipe again. As nvcc compiles the bf16
// normal for sm_90a, a pair issues 238 instructions, 94 of them on the ALU:
// 47 a draw against the layout above's 71, so one hash shared by two draws
// cuts the bound by a third (0.57 ms for a (6144, 32768) matrix drawn
// whole, against 0.85). A window that is not the whole draw hashes a pair
// for each draw where its two ranges do not meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2,048 threads: all an SM holds

// Giles' single-precision erfinv (XLA's ErfInv32), highest degree first.
__constant__ float kErfinvSmall[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                                      -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                                      -0.00417768164f, 0.246640727f, 1.50140941f};
__constant__ float kErfinvLarge[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                                      -0.00367342844f, 0.00573950773f, -0.0076224613f,
                                      0.00943887047f, 1.00167406f, 2.83297682f};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax._src.prng._threefry2x32_lowering: the
// hash of the counter words (x0, x1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define ROUND(r) \
  x0 += x1;      \
  x1 = rotl(x1, r) ^ x0;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef ROUND
}

// The partitionable layout's 32 bits of the 64-bit counter c.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint64_t c) {
  uint32_t x0 = static_cast<uint32_t>(c >> 32), x1 = static_cast<uint32_t>(c);
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform_of(uint32_t bits, float lo, float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, fmaf(f, span, lo));
}

__device__ __forceinline__ float erfinv_of(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool small = w < 5.0f;
  const float* c = small ? kErfinvSmall : kErfinvLarge;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, w, c[i]);
  const float r = __fmul_rn(p, x);
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.402823466e38f) : r;
}

// One element of kind KIND from its 32 bits.
template <int KIND, typename T>
__device__ __forceinline__ void store(T* out, uint32_t bits, float lo, float span, float scale) {
  if constexpr (KIND == 0) {
    *out = static_cast<T>(bits);
  } else if constexpr (KIND == 1) {
    *out = uniform_of(bits, lo, span);
  } else {
    const float u = uniform_of(bits, lo, span);
    const float x = __fmul_rn(__fmul_rn(1.41421353816986084f, erfinv_of(u)), scale);
    if constexpr (sizeof(T) == 2) {
      *out = __float2bfloat16_rn(x);
    } else {
      *out = x;
    }
  }
}

template <int KIND, typename T>
__global__ void __launch_bounds__(THREADS)
    threefry_kernel(uint32_t k0, uint32_t k1, uint64_t offset, int64_t n, float lo, float span,
                    float scale, T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += stride) {
    store<KIND>(out + i, threefry_bits(k0, k1, offset + static_cast<uint64_t>(i)), lo, span,
                scale);
  }
}

// The original layout: thread t takes pair p (the first range's t-th, then
// the second's) of a draw of size elements with h = half, and writes its
// elements in [first, end) to out[element - first].
template <int KIND, typename T>
__global__ void __launch_bounds__(THREADS)
    threefry_pairs_kernel(uint32_t k0, uint32_t k1, uint32_t size, uint32_t half,
                          uint32_t first, uint32_t end, uint32_t range0, uint32_t len0,
                          uint32_t range1, int64_t pairs, float lo, float span, float scale,
                          T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; t < pairs;
       t += stride) {
    const uint32_t p = t < len0 ? range0 + static_cast<uint32_t>(t)
                                : range1 + static_cast<uint32_t>(t - len0);
    const uint32_t q = p + half;   // p < half <= 2^31: no wrap
    uint32_t y0 = p, y1 = q < size ? q : 0u;
    threefry2x32(k0, k1, y0, y1);
    if (p >= first && p < end) store<KIND>(out + (p - first), y0, lo, span, scale);
    if (q >= first && q < end) store<KIND>(out + (q - first), y1, lo, span, scale);
  }
}

// Blocks of THREADS for n work items, as many as fill every SM, at most.
cudaError_t grid_for(int64_t n, unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (n + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  *blocks = static_cast<unsigned>(want < cap ? want : cap);
  return cudaSuccess;
}

template <int KIND, typename T>
cudaError_t launch(uint32_t k0, uint32_t k1, uint64_t offset, int64_t n, float lo, float span,
                   float scale, void* out, cudaStream_t st) {
  unsigned blocks = 0;
  const cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  threefry_kernel<KIND, T><<<blocks, THREADS, 0, st>>>(k0, k1, offset, n, lo, span, scale,
                                                       static_cast<T*>(out));
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t launch_pairs(uint32_t k0, uint32_t k1, uint32_t size, uint32_t first, int64_t n,
                         float lo, float span, float scale, void* out, cudaStream_t st) {
  const uint32_t half = size / 2 + size % 2;
  const uint32_t end = first + static_cast<uint32_t>(n);
  // pairs of the window's lower elements [a0, b0), of its upper ones [a1, b1)
  const uint32_t a0 = first < half ? first : half, b0 = end < half ? end : half;
  const uint32_t a1 = (first > half ? first : half) - half;
  const uint32_t b1 = end > half ? end - half : 0u;
  uint32_t range0 = a0, len0 = b0 - a0, range1 = a1;
  int64_t pairs = static_cast<int64_t>(b0 - a0) + (b1 - a1);
  if (a0 == b0) {
    range0 = a1, len0 = b1 - a1;
  } else if (a1 < b1 && a1 <= b0 && a0 <= b1) {   // they meet: one range
    range0 = a0 < a1 ? a0 : a1;
    len0 = (b0 > b1 ? b0 : b1) - range0;
    pairs = len0;
  }
  unsigned blocks = 0;
  const cudaError_t err = grid_for(pairs, &blocks);
  if (err != cudaSuccess) return err;
  threefry_pairs_kernel<KIND, T><<<blocks, THREADS, 0, st>>>(
      k0, k1, size, half, first, end, range0, len0, range1, pairs, lo, span, scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). kind: 0 = bits into
// int64 (out_dtype 2), 1 = uniform into float32 (out_dtype 0), 2 = scale *
// normal into float32 (out_dtype 0) or bfloat16 (out_dtype 1). out holds n
// contiguous elements; counters run from offset to offset + n - 1 (no
// wrap past 2^64). lo and hi bound the uniform (kind 1 and 2).
int threefry_launch(uint32_t k0, uint32_t k1, uint64_t offset, int64_t n, int kind,
                    int out_dtype, float lo, float hi, float scale, void* out, void* stream) {
  if (n < 1 || out == nullptr || offset + static_cast<uint64_t>(n - 1) < offset)
    return static_cast<int>(cudaErrorInvalidValue);
  const float span = hi - lo;   // in f32, as jax.random.uniform rounds maxval - minval
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0 && out_dtype == 2)
    return static_cast<int>(launch<0, int64_t>(k0, k1, offset, n, lo, span, scale, out, st));
  if (kind == 1 && out_dtype == 0)
    return static_cast<int>(launch<1, float>(k0, k1, offset, n, lo, span, scale, out, st));
  if (kind == 2 && out_dtype == 0)
    return static_cast<int>(launch<2, float>(k0, k1, offset, n, lo, span, scale, out, st));
  if (kind == 2 && out_dtype == 1)
    return static_cast<int>(launch<2, __nv_bfloat16>(k0, k1, offset, n, lo, span, scale, out,
                                                     st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The original layout's elements first .. first + n - 1 of a draw (or a
// block) of size <= 2^32 - 1 elements under the key (k0, k1); otherwise as
// threefry_launch.
int threefry_launch_original(uint32_t k0, uint32_t k1, uint32_t size, uint32_t first,
                             int64_t n, int kind, int out_dtype, float lo, float hi,
                             float scale, void* out, void* stream) {
  if (n < 1 || out == nullptr || static_cast<uint64_t>(first) + static_cast<uint64_t>(n) > size)
    return static_cast<int>(cudaErrorInvalidValue);
  const float span = hi - lo;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0 && out_dtype == 2)
    return static_cast<int>(launch_pairs<0, int64_t>(k0, k1, size, first, n, lo, span, scale,
                                                     out, st));
  if (kind == 1 && out_dtype == 0)
    return static_cast<int>(launch_pairs<1, float>(k0, k1, size, first, n, lo, span, scale,
                                                   out, st));
  if (kind == 2 && out_dtype == 0)
    return static_cast<int>(launch_pairs<2, float>(k0, k1, size, first, n, lo, span, scale,
                                                   out, st));
  if (kind == 2 && out_dtype == 1)
    return static_cast<int>(launch_pairs<2, __nv_bfloat16>(k0, k1, size, first, n, lo, span,
                                                           scale, out, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
