// IVF candidate top-k over the cache slab, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ivf_topk.py::_ivf_topk_kernel
// (ivf_topk_pallas), the candidate stage of IVFIndex.search. Per query row b:
// read the row's M candidate slot ids cand[b, :], load the slab row of every
// visible id, score it against the query, and keep the k <= 32 best,
// ordered by (score desc, candidate position asc); return their slot ids,
// with (-inf, -1) where fewer than k ids are visible. The (B, M, d) tensor of
// gathered rows never exists: each row goes from device memory to registers.
//
// Visibility: an id is visible when 0 <= id < N. IVFIndex.candidates folds
// every other rule (bucket validity, aliveness, tenancy, per-row duplicates)
// into -1 before the call, and never gives an id >= N; the kernel treats one
// as invisible rather than read past the slab, and the plain version
// (kernels/ref.py::ivf_topk_ref) does the same.
//
// Scores: f32 FMAs. A lane loads 16 bytes of the row at a time (4 f32, 8
// bf16 or 16 int8 keys; int8 scaled by 1/127 in registers, bf16 through the
// intrinsics) and sums each 16-byte group in order, then its groups in
// order; the warp's 32 lane sums are added by a butterfly. The order depends
// on neither the slot nor the position, so equal key rows get bitwise-equal
// scores and ties resolve by candidate position alone, as the TPU kernel's
// lax.top_k over positions does. Rows whose d * sizeof(key) is not a
// multiple of 16 are read one element per lane instead.
//
// Bound on an H100 SXM at the serve shape (B=128, M=16 probes x 1,024 =
// 16,384, d=384, about 780 visible ids a row, f32 keys): the visible work is
// 2*384*(128*780) = 77 MFLOP, about 1 us at 67 TFLOP/s, while the bytes are
// the 8.4 MB id matrix plus at most the ~6,300 live slab rows (9.7 MB f32),
// about 5.4 us at 3.35 TB/s. So it is bound by bytes, and the ids dominate.
//
// Design. The TPU kernel runs a sequential grid over M with a running top-k
// in VMEM and one DMA per candidate row; CUDA blocks run in no order, so
// this is two passes.
//   Pass 1, grid (M-chunks of 2,048 positions, B). A block copies its query
//     row to shared memory; each of its 8 warps reads 256 ids as 8 groups
//     of 32 (one 128-byte load each, all in flight at once) and ballots
//     the visible lanes. The block compacts the visible (position, id)
//     pairs into shared memory in position order, and the warps take them
//     round robin: IVFIndex.candidates lays each probed bucket out as a
//     prefix of members (44 on average at the serve shape) and a tail of
//     -1, so a split by position would leave one warp of four with all of
//     a bucket's rows. A warp loads and scores one row at a time, the whole
//     warp on it, 32 rows to a round, and offers each round to its top-k
//     list, keyed by position. Each warp writes its list to partial
//     (B, chunks * 8, k).
//   Pass 2 merges each row's chunks * 8 * k entries, one warp per row, and
//     maps the k positions to slot ids.
// Left for later work: cp.async/TMA staging of the rows (a warp waits for
// one row at a time), and a compact list of visible ids in place of the
// padded (B, M) matrix, 95% of which is -1 at the serve shape.
#include <cuda_runtime.h>

#include "warp_topk.cuh"

namespace {

using namespace warp_topk;

constexpr int NT = 256;                          // threads per block
constexpr int WARPS = NT / 32;
constexpr int GROUPS = 8;                        // id groups of 32 per warp
constexpr int POS_PER_BLOCK = WARPS * GROUPS * 32;  // 2,048
constexpr int MAX_D = 4096;  // the query row (16 KB) beside the compacted ids

// 16 bytes of keys -> f32 values, as to_f32 converts one key
template <typename KT>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // byte b of the word, sign-extended
        const int v = static_cast<int>(w[i] << (24 - 8 * b)) >> 24;
        f[4 * i + b] = static_cast<float>(v) * (1.0f / 127.0f);
      }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane adds the same two values at every level, so all
  // lanes end with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// q . row over d, the whole warp on one row; every lane gets the result
template <typename KT, bool VEC>
__device__ __forceinline__ float row_dot(const float* qs, const KT* __restrict__ row, int d,
                                         int lane) {
  float acc = 0.0f;
  if constexpr (VEC) {
    constexpr int E = Vec<KT>::N;
    const uint4* r = reinterpret_cast<const uint4*>(row);
    const int groups = d / E;
#pragma unroll 4
    for (int v = lane; v < groups; v += 32) {
      float kf[E];
      Vec<KT>::unpack(__ldg(r + v), kf);
      const float4* q4 = reinterpret_cast<const float4*>(qs + v * E);
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < E / 4; ++j) {
        const float4 qq = q4[j];
        part = fmaf(qq.x, kf[4 * j], part);
        part = fmaf(qq.y, kf[4 * j + 1], part);
        part = fmaf(qq.z, kf[4 * j + 2], part);
        part = fmaf(qq.w, kf[4 * j + 3], part);
      }
      acc += part;
    }
  } else {
    for (int e = lane; e < d; e += 32) acc = fmaf(qs[e], to_f32(row[e]), acc);
  }
  return warp_sum(acc);
}

template <typename KT, bool VEC>
__global__ void __launch_bounds__(NT)
ivf_topk_partial(const float* __restrict__ q, const KT* __restrict__ keys,
                 const int* __restrict__ cand, int N, int M, int d, int k,
                 float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float qs[];  // the block's query row, d floats
  // the chunk's visible candidates, compacted in position order
  __shared__ int vis_pos[POS_PER_BLOCK], vis_id[POS_PER_BLOCK];
  __shared__ int warp_count[WARPS];
  const int row = blockIdx.y, chunk = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < d; e += NT) qs[e] = q[(size_t)row * d + e];

  // 1. each warp reads 8 groups of 32 ids, all loads in flight at once, and
  //    counts its visible ones
  const int* ids = cand + (size_t)row * M;
  const int p0 = chunk * POS_PER_BLOCK + warp * GROUPS * 32 + lane;
  int id[GROUPS];
  unsigned vis[GROUPS];
  int count = 0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int p = p0 + 32 * g;
    id[g] = p < M ? __ldg(ids + p) : -1;
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    vis[g] = __ballot_sync(FULL, id[g] >= 0 && id[g] < N);
    count += __popc(vis[g]);
  }
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();

  // 2. compact: a visible candidate's rank is the count of visible ones
  //    before it in the chunk
  int offset = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    offset += w < warp ? warp_count[w] : 0;
    total += warp_count[w];
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    if (vis[g] >> lane & 1u) {
      const int r = offset + __popc(vis[g] & below);
      vis_pos[r] = p0 + 32 * g;
      vis_id[r] = id[g];
    }
    offset += __popc(vis[g]);
  }
  __syncthreads();

  // 3. the 8 warps share the visible candidates round robin, so a bucket's
  //    members (a prefix of its 1,024 positions) keep every warp busy; a
  //    warp scores its entries one row at a time, 32 to a round, then
  //    offers the round to its top-k list, keyed by position
  float ls = -INFINITY;
  int li = -1;
  const int mine = (total - warp + WARPS - 1) / WARPS;
  for (int base = 0; base < mine; base += 32) {
    const int n = min(32, mine - base);
    float s = -INFINITY;
    int pos = -1;
    for (int j = 0; j < n; ++j) {
      const int e = warp + WARPS * (base + j);
      const float v = row_dot<KT, VEC>(qs, keys + (size_t)vis_id[e] * d, d, lane);
      if (lane == j) {
        s = v;
        pos = vis_pos[e];
      }
    }
    warp_offer(s, pos, lane < n, k, lane, ls, li);
  }

  if (lane < k) {
    const size_t o = (((size_t)row * gridDim.x + chunk) * WARPS + warp) * k + lane;
    part_s[o] = ls;
    part_i[o] = li;
  }
}

__global__ void __launch_bounds__(NT)
ivf_topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
               const int* __restrict__ cand, int B, int M, int entries, int k,
               float* __restrict__ out_s, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  float ls = -INFINITY;
  int li = -1;
  const float* ps = part_s + (size_t)row * entries;
  const int* pi = part_i + (size_t)row * entries;
  for (int base = 0; base < entries; base += 32) {
    const int e = base + lane;
    const float s = e < entries ? ps[e] : -INFINITY;
    const int pos = e < entries ? pi[e] : -1;
    warp_offer(s, pos, pos >= 0, k, lane, ls, li);
  }
  if (lane < k) {
    out_s[(size_t)row * k + lane] = ls;
    out_i[(size_t)row * k + lane] = li >= 0 ? cand[(size_t)row * M + li] : -1;
  }
}

struct Args {
  const void* q;
  const void* keys;
  const void* cand;
  int B, N, M, d, k, chunks;
  void* part_s;
  void* part_i;
  void* out_s;
  void* out_i;
  cudaStream_t stream;
};

template <typename KT, bool VEC>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.chunks, a.B);
  ivf_topk_partial<KT, VEC><<<grid, NT, a.d * sizeof(float), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KT*>(a.keys),
      static_cast<const int*>(a.cand), a.N, a.M, a.d, a.k, static_cast<float*>(a.part_s),
      static_cast<int*>(a.part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ivf_topk_merge<<<(a.B + WARPS - 1) / WARPS, NT, 0, a.stream>>>(
      static_cast<const float*>(a.part_s), static_cast<const int*>(a.part_i),
      static_cast<const int*>(a.cand), a.B, a.M, a.chunks * WARPS * a.k, a.k,
      static_cast<float*>(a.out_s), static_cast<int*>(a.out_i));
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_rows(const Args& a) {
  // 16-byte loads need every row to start on a 16-byte boundary
  const bool vec = (a.d * sizeof(KT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.keys) % 16 == 0;
  return vec ? launch<KT, true>(a) : launch<KT, false>(a);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of its launches (0 on success). key_dtype: 0 =
// float32, 1 = bfloat16, 2 = int8. cand is (B, M) int32, row-major; part_s
// and part_i hold B * chunks * 8 * k entries, chunks = ceil(M / 2048).
int ivf_topk_launch(const void* q, const void* keys, int key_dtype, const void* cand, int B,
                    int N, int M, int d, int k, int chunks, void* part_s, void* part_i,
                    void* out_s, void* out_i, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || d < 1 || d > MAX_D || k < 1 || k > MAX_K ||
      chunks != (M + POS_PER_BLOCK - 1) / POS_PER_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, keys, cand, B, N, M, d, k, chunks, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  switch (key_dtype) {
    case 0:
      return static_cast<int>(launch_rows<float>(a));
    case 1:
      return static_cast<int>(launch_rows<__nv_bfloat16>(a));
    case 2:
      return static_cast<int>(launch_rows<int8_t>(a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
