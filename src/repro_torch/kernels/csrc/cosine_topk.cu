// Masked cosine top-k over the cache slab, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py::_cosine_topk_kernel
// (entry point cosine_topk_pallas): scores = queries (B, d) x keys (N, d)^T
// under a shared (N,) validity mask, then the k <= 8 best slots of each row,
// ordered by (score desc, slot id asc), with (-inf, -1) where fewer than k
// slots are visible. Keys are f32, bf16 or int8; int8 keys are loaded as one
// byte each and scaled by 1/127 in registers.
//
// Bound on an H100 SXM at the main path's shapes (B=128, d=384, N=16384, f32
// keys): 2*B*d*N = 1.61 GFLOP at the 67 TFLOP/s f32 CUDA-core peak is 24 us,
// while reading the 25.4 MB slab at 3.35 TB/s is 7.6 us, so it is bound by
// operations. The products run in plain f32 FMA, not TF32 and not tensor
// cores: at the paper's configuration the closest score lies 1.85e-5 from the
// 0.8 threshold, and TF32's ~1e-3 error would flip hit decisions.
//
// Design. The TPU kernel carries a running top-k across a sequential grid;
// CUDA blocks run in no order, so this is two passes.
//   Pass 1, grid (N-chunks, query tiles of 64 rows). A block streams its
//     chunk in tiles of 128 keys x 32 dims through shared memory, converting
//     the keys to f32 as they are loaded. Each thread accumulates a 4 x 8 tile
//     of scores with FMAs over d in a fixed order (per 32-dim tile, then
//     across tiles), so two equal key rows get bitwise-equal scores and ties
//     resolve by slot id alone. Each 64 x 128
//     score tile is masked by `valid` and offered to one warp-held top-k list
//     per query row. The block writes its lists to partial (B, chunks, k).
//   Pass 2 merges each row's chunks x k candidates, one warp per row.
// The split gives B=128, N=16384 a grid of 128 chunks x 2 tiles = 256 blocks,
// about two per SM, all resident at once. Left for later work: 12 shared-
// memory loads per 32 FMAs, loads not overlapped with compute, the query tile
// reloaded for every key tile, and the merge not fused into pass 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                        // query rows per block
constexpr int BN = 128;                       // keys per tile
constexpr int DK = 32;                        // dims per tile
constexpr int NT = 256;                       // threads per block, 16 x 16
constexpr int TQ = BQ / 16;                   // query rows per thread
constexpr int TN = BN / 16;                   // keys per thread
constexpr int ROWS_PER_WARP = BQ / (NT / 32); // top-k lists per warp
constexpr int MAX_K = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v) * (1.0f / 127.0f); }

// (as, ai) ranks before (bs, bi): the higher score, then the lower slot id.
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

template <typename KT>
__global__ void __launch_bounds__(NT)
cosine_topk_partial(const float* __restrict__ q, const KT* __restrict__ keys,
                    const uint8_t* __restrict__ valid, int B, int N, int d, int k,
                    int keys_per_chunk, float* __restrict__ part_s,
                    int* __restrict__ part_i) {
  // The two input tiles of the d loop and the score tile after it share one
  // buffer: qs [DK][BQ + 1] and ks [DK][BN + 1], then sc [BQ][BN + 1]. The +1
  // keeps the transposed stores free of bank conflicts.
  __shared__ float smem[BQ * (BN + 1)];
  float* qs = smem;
  float* ks = smem + DK * (BQ + 1);
  float* sc = smem;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  const int n_begin = chunk * keys_per_chunk;
  const int n_end = min(N, n_begin + keys_per_chunk);

  float ls[ROWS_PER_WARP];
  int li[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    ls[r] = -INFINITY;
    li[r] = -1;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    float acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int c0 = 0; c0 < d; c0 += DK) {
#pragma unroll
      for (int p = 0; p < BQ * DK / NT; ++p) {
        const int e = tid + p * NT, r = e / DK, c = e % DK;
        const int gr = q0 + r, gc = c0 + c;
        qs[c * (BQ + 1) + r] = (gr < B && gc < d) ? q[(size_t)gr * d + gc] : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < BN * DK / NT; ++p) {
        const int e = tid + p * NT, r = e / DK, c = e % DK;
        const int gn = n0 + r, gc = c0 + c;
        ks[c * (BN + 1) + r] = (gn < n_end && gc < d) ? to_f32(keys[(size_t)gn * d + gc]) : 0.0f;
      }
      __syncthreads();
      // the sum runs in two levels, within a 32-dim tile and then across
      // tiles: one sequential chain over d rounds with a bias that reaches
      // ~1e-5 at d=1536 on int8 keys, the two levels stay near 2e-7
      float part[TQ][TN];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
#pragma unroll 8
      for (int c = 0; c < DK; ++c) {
        float a[TQ], b[TN];
#pragma unroll
        for (int i = 0; i < TQ; ++i) a[i] = qs[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ks[c * (BN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + 16 * j, gn = n0 + col;
        sc[(ty + 16 * i) * (BN + 1) + col] = (gn < n_end && valid[gn]) ? acc[i][j] : -INFINITY;
      }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = warp * ROWS_PER_WARP + r;
#pragma unroll 1
      for (int m = 0; m < BN / 32; ++m) {
        const int col = m * 32 + lane;
        const float s = sc[row * (BN + 1) + col];
        warp_offer(s, n0 + col, s > -INFINITY, k, lane, ls[r], li[r]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int gr = q0 + warp * ROWS_PER_WARP + r;
    if (gr < B && lane < k) {
      const size_t o = ((size_t)gr * chunks + chunk) * k + lane;
      part_s[o] = ls[r];
      part_i[o] = li[r];
    }
  }
}

__global__ void __launch_bounds__(NT)
cosine_topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
                  int B, int chunks, int k, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  float ls = -INFINITY;
  int li = -1;
  const int m = chunks * k;
  const float* ps = part_s + (size_t)row * m;
  const int* pi = part_i + (size_t)row * m;
  for (int base = 0; base < m; base += 32) {
    const int e = base + lane;
    const float s = e < m ? ps[e] : -INFINITY;
    const int id = e < m ? pi[e] : -1;
    warp_offer(s, id, id >= 0, k, lane, ls, li);
  }
  if (lane < k) {
    out_s[(size_t)row * k + lane] = ls;
    out_i[(size_t)row * k + lane] = li;
  }
}

template <typename KT>
cudaError_t launch(const void* q, const void* keys, const void* valid, int B, int N, int d,
                   int k, int keys_per_chunk, int chunks, void* part_s, void* part_i,
                   void* out_s, void* out_i, cudaStream_t stream) {
  const dim3 grid(chunks, (B + BQ - 1) / BQ);
  cosine_topk_partial<KT><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(keys),
      static_cast<const uint8_t*>(valid), B, N, d, k, keys_per_chunk,
      static_cast<float*>(part_s), static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cosine_topk_merge<<<(B + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i), B, chunks, k,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// key_dtype: 0 = float32, 1 = bfloat16, 2 = int8. part_s/part_i hold
// B * chunks * k entries; chunks * keys_per_chunk must cover N. Returns the
// cudaError_t of the launches (0 on success).
int cosine_topk_launch(const void* q, const void* keys, int key_dtype, const void* valid,
                       int B, int N, int d, int k, int keys_per_chunk, int chunks,
                       void* part_s, void* part_i, void* out_s, void* out_i, void* stream) {
  if (B < 1 || N < 1 || d < 1 || k < 1 || k > MAX_K || keys_per_chunk < 1 || chunks < 1 ||
      (long long)chunks * keys_per_chunk < N ||
      (long long)(chunks - 1) * keys_per_chunk >= N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_dtype) {
    case 0:
      return launch<float>(q, keys, valid, B, N, d, k, keys_per_chunk, chunks, part_s, part_i,
                           out_s, out_i, s);
    case 1:
      return launch<__nv_bfloat16>(q, keys, valid, B, N, d, k, keys_per_chunk, chunks, part_s,
                                   part_i, out_s, out_i, s);
    case 2:
      return launch<int8_t>(q, keys, valid, B, N, d, k, keys_per_chunk, chunks, part_s, part_i,
                            out_s, out_i, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cosine_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
