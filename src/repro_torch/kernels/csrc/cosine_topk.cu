// Masked cosine top-k over the cache slab, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py::_cosine_topk_kernel
// in three of its visibility forms, one C entry point each:
//   cosine_topk_launch           shared (N,) validity mask (cosine_topk_pallas)
//   cosine_topk_interval_launch  shared mask and one slot interval per row,
//                                [starts[b], starts[b] + sizes[b]), the
//                                tenancy path (cosine_topk_interval_pallas)
//   cosine_topk_masked_launch    dense (B, N) bool mask, aliveness folded in
//                                by the caller (cosine_topk_masked_pallas)
// scores = queries (B, d) x keys (N, d)^T, then the k <= 8 best visible slots
// of each row, ordered by (score desc, slot id asc), with (-inf, -1) where
// fewer than k slots are visible. Keys are f32, bf16 or int8; int8 keys are
// loaded as one byte each and scaled by 1/127 in registers. The mask source
// is a template parameter of pass 1; it decides which scores are offered to
// the top-k lists, so a slot outside a row's interval (or dense mask) never
// enters that row's list, whatever its score or slot id.
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
//
// Interval form. A block loads the 64 intervals of its query rows into
// shared memory once and skips every 128-key tile that lies outside all of
// them (the skip is uniform over the block, so it leaves the barriers
// intact); rows past B get an empty interval. Counting only the visible work,
// the tenancy path (B=128, N=65536, four 16384-slot regions) needs 1.61 GFLOP
// (24 us at 67 TFLOP/s) and reads the 100.7 MB f32 slab (30 us at 3.35 TB/s),
// so its bound is set by bytes: the slab no longer fits the 50 MB L2. But a
// 64-row tile there mixes tenants, so the skip rarely fires and the kernel
// scores all N, four times the visible operations. Dense form: one byte of
// the (B, N) mask per score, read where the score tile is stored.
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

// where a score's visibility comes from (template parameter of pass 1)
enum MaskSource { SHARED_MASK = 0, INTERVAL_MASK = 1, DENSE_MASK = 2 };

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

// valid: (N,) bytes (SHARED_MASK, INTERVAL_MASK); starts/sizes: (B,) int32
// (INTERVAL_MASK); mask: (B, N) bytes (DENSE_MASK). Unused pointers may be
// null.
template <typename KT, int MS>
__global__ void __launch_bounds__(NT)
cosine_topk_partial(const float* __restrict__ q, const KT* __restrict__ keys,
                    const uint8_t* __restrict__ valid, const int* __restrict__ starts,
                    const int* __restrict__ sizes, const uint8_t* __restrict__ mask,
                    int B, int N, int d, int k, int keys_per_chunk,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
  // The two input tiles of the d loop and the score tile after it share one
  // buffer: qs [DK][BQ + 1] and ks [DK][BN + 1], then sc [BQ][BN + 1]. The +1
  // keeps the transposed stores free of bank conflicts.
  __shared__ float smem[BQ * (BN + 1)];
  // INTERVAL_MASK: row r of the block sees [row_lo[r], row_hi[r])
  __shared__ int row_lo[BQ], row_hi[BQ];
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

  // keys [blk_lo, blk_hi) hold every slot some row of the block may see
  int blk_lo = n_begin, blk_hi = n_end;
  if (MS == INTERVAL_MASK) {
    if (tid < BQ) {
      const int gr = q0 + tid;
      const int lo = gr < B ? starts[gr] : 0;
      const int sz = gr < B ? sizes[gr] : 0;
      row_lo[tid] = lo;
      row_hi[tid] = sz > 0 ? lo + sz : lo;
    }
    __syncthreads();
    int lo = N, hi = 0;
    for (int r = 0; r < BQ; ++r) {
      if (row_hi[r] > row_lo[r]) {
        lo = min(lo, row_lo[r]);
        hi = max(hi, row_hi[r]);
      }
    }
    blk_lo = max(blk_lo, lo);
    blk_hi = min(blk_hi, hi);
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    if (n0 + BN <= blk_lo || n0 >= blk_hi) continue;  // uniform over the block
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
    for (int i = 0; i < TQ; ++i) {
      const int r = ty + 16 * i, gr = q0 + r;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + 16 * j, gn = n0 + col;
        bool vis = gn < n_end;
        if (MS == SHARED_MASK) {
          vis = vis && valid[gn];
        } else if (MS == INTERVAL_MASK) {
          vis = vis && valid[gn] && gn >= row_lo[r] && gn < row_hi[r];
        } else {
          vis = vis && gr < B && mask[(size_t)gr * N + gn];
        }
        sc[r * (BN + 1) + col] = vis ? acc[i][j] : -INFINITY;
      }
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

struct Args {
  const void* q;
  const void* keys;
  const void* valid;
  const void* starts;
  const void* sizes;
  const void* mask;
  int B, N, d, k, keys_per_chunk, chunks;
  void* part_s;
  void* part_i;
  void* out_s;
  void* out_i;
  cudaStream_t stream;
};

template <typename KT, int MS>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.chunks, (a.B + BQ - 1) / BQ);
  cosine_topk_partial<KT, MS><<<grid, NT, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KT*>(a.keys),
      static_cast<const uint8_t*>(a.valid), static_cast<const int*>(a.starts),
      static_cast<const int*>(a.sizes), static_cast<const uint8_t*>(a.mask), a.B, a.N,
      a.d, a.k, a.keys_per_chunk, static_cast<float*>(a.part_s),
      static_cast<int*>(a.part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cosine_topk_merge<<<(a.B + NT / 32 - 1) / (NT / 32), NT, 0, a.stream>>>(
      static_cast<const float*>(a.part_s), static_cast<const int*>(a.part_i), a.B,
      a.chunks, a.k, static_cast<float*>(a.out_s), static_cast<int*>(a.out_i));
  return cudaGetLastError();
}

// key_dtype: 0 = float32, 1 = bfloat16, 2 = int8
template <int MS>
int dispatch(int key_dtype, const Args& a) {
  if (a.B < 1 || a.N < 1 || a.d < 1 || a.k < 1 || a.k > MAX_K || a.keys_per_chunk < 1 ||
      a.chunks < 1 || (long long)a.chunks * a.keys_per_chunk < a.N ||
      (long long)(a.chunks - 1) * a.keys_per_chunk >= a.N)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (key_dtype) {
    case 0:
      return launch<float, MS>(a);
    case 1:
      return launch<__nv_bfloat16, MS>(a);
    case 2:
      return launch<int8_t, MS>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry point returns the cudaError_t of its launches (0 on success).
// key_dtype: 0 = float32, 1 = bfloat16, 2 = int8. part_s/part_i hold
// B * chunks * k entries; chunks * keys_per_chunk must cover N.

// shared (N,) mask
int cosine_topk_launch(const void* q, const void* keys, int key_dtype, const void* valid,
                       int B, int N, int d, int k, int keys_per_chunk, int chunks,
                       void* part_s, void* part_i, void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, valid, nullptr, nullptr, nullptr, B, N, d, k, keys_per_chunk,
               chunks, part_s, part_i, out_s, out_i, static_cast<cudaStream_t>(stream)};
  return dispatch<SHARED_MASK>(key_dtype, a);
}

// shared (N,) mask and per-row (B,) int32 intervals; the caller guarantees
// 0 <= starts, 0 <= sizes and starts + sizes <= N
int cosine_topk_interval_launch(const void* q, const void* keys, int key_dtype,
                                const void* valid, const void* starts, const void* sizes,
                                int B, int N, int d, int k, int keys_per_chunk, int chunks,
                                void* part_s, void* part_i, void* out_s, void* out_i,
                                void* stream) {
  const Args a{q, keys, valid, starts, sizes, nullptr, B, N, d, k, keys_per_chunk,
               chunks, part_s, part_i, out_s, out_i, static_cast<cudaStream_t>(stream)};
  return dispatch<INTERVAL_MASK>(key_dtype, a);
}

// dense (B, N) bool mask, row-major
int cosine_topk_masked_launch(const void* q, const void* keys, int key_dtype,
                              const void* mask, int B, int N, int d, int k,
                              int keys_per_chunk, int chunks, void* part_s, void* part_i,
                              void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, nullptr, nullptr, nullptr, mask, B, N, d, k, keys_per_chunk,
               chunks, part_s, part_i, out_s, out_i, static_cast<cudaStream_t>(stream)};
  return dispatch<DENSE_MASK>(key_dtype, a);
}

const char* cosine_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
