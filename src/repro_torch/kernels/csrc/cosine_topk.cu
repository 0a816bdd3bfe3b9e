// Masked cosine top-k over the cache slab, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py::_cosine_topk_kernel
// in its six forms, one C entry point each: three visibility forms
//   cosine_topk_launch           shared (N,) validity mask (cosine_topk_pallas)
//   cosine_topk_interval_launch  shared mask and one slot interval per row,
//                                [starts[b], starts[b] + sizes[b]), the
//                                tenancy path (cosine_topk_interval_pallas)
//   cosine_topk_masked_launch    dense (B, N) bool mask, aliveness folded in
//                                by the caller (cosine_topk_masked_pallas)
// and the same three over an int8 slab with a per-row (N,) f32 scale
//   quant_cosine_topk_launch           (quant_cosine_topk_pallas)
//   quant_cosine_topk_interval_launch  (quant_cosine_topk_interval_pallas)
//   quant_cosine_topk_masked_launch    (quant_cosine_topk_masked_pallas)
// scores = queries (B, d) x keys (N, d)^T, then the k <= 32 best visible
// slots of each row, ordered by (score desc, slot id asc), with (-inf, -1) where
// fewer than k slots are visible. Keys are f32, bf16 or int8, loaded as they
// are stored (int8 one byte each). Two template parameters of pass 1 decide
// the rest. The scale source turns a key into f32 as it is stored in shared
// memory: by its type (int8 times 1/127, the slab's uniform quantization) or
// as float(kq) * scales[n], the product the Pallas kernel and the plain
// version form before their GEMM, so the FMAs see the plain version's operands
// bit for bit; each tile reads its 128 scales once. The mask source decides
// which scores are offered to the top-k lists, so a slot outside a row's
// interval (or dense mask) never enters that row's list, whatever its score
// or slot id.
//
// Bound on an H100 SXM at the main path's shapes (B=128, d=384, N=16384, f32
// keys): 2*B*d*N = 1.61 GFLOP at the 67 TFLOP/s f32 CUDA-core peak is 24 us,
// while reading the 25.4 MB slab at 3.35 TB/s is 7.6 us, so it is bound by
// operations. The products run in plain f32 FMA, not TF32 and not tensor
// cores: at the paper's configuration the closest score lies 1.85e-5 from the
// 0.8 threshold, and TF32's ~1e-3 error would flip hit decisions. A per-row-
// scale int8 slab moves 6.6 MB instead of 25.4 MB (keys, scales, mask) but
// does the same 1.61 GFLOP, so it has the same 24 us bound; scaling after the
// dot, or int8 tensor-core products, would round differently from the plain
// version and are later work.
//
// Design. The TPU kernel carries a running top-k across a sequential grid;
// CUDA blocks run in no order, so this is two passes.
//   Pass 1, grid (N-chunks, query tiles). A block streams its chunk in
//     tiles of 128 keys x 32 dims through shared memory, converting the keys
//     to f32 as they are loaded. Each thread accumulates a patch of scores
//     with FMAs over d in a fixed order (per 32-dim tile, then across
//     tiles), so two equal key rows get bitwise-equal scores and ties
//     resolve by slot id alone. Each score tile is masked by `valid` and
//     offered to one warp-held top-k list per query row; a list keeps one
//     entry per lane (warp_topk.cuh), so the IVF probe's k=16 runs the same
//     code, in the same registers, as the main path's k=4. The block writes
//     its lists to partial (B, chunks, k), or straight to the output when
//     there is one chunk.
//   Pass 2 merges each row's chunks x k candidates, one warp per row; it is
//     not launched when there is one chunk.
// The query-tile height is a template parameter of pass 1, chosen by the
// wrapper's split (kernels/cosine_topk.py); the interval form also takes
// wide tiles of 32 and 16 rows (below):
//   wide, 64 rows: 256 threads in 16 x 16, a 4 x 8 patch each, 8 rows a
//     warp in the top-k. The split gives B=128, N=16384 a grid of 128
//     chunks x 2 tiles = 256 blocks, about two per SM, all resident at once.
//   narrow, 4 rows: 128 threads, one warp per query row, each lane 4 keys
//     (lane + 32 j) of its row, the next 32-dim slice of queries and keys
//     loaded into registers while this one is multiplied. Taken where 64-row
//     tiles, even at one chunk per 128-key tile, would leave SMs idle: the
//     IVF probe (B=128 queries over N=128 centroids) gets 32 blocks and one
//     launch, where 64-row tiles would give it 2 blocks and a merge of one
//     chunk. The summation order, hence every score bit, is the wide form's.
// Left for later work, in the wide form: 12 shared-memory loads per 32 FMAs,
// loads not overlapped with compute, the query tile reloaded for every key
// tile, and the merge not fused into pass 1.
//
// Interval form. The wrapper sorts the rows by interval on the card
// (kernels/cosine_topk.py::interval_order, one stable sort, no sync) and
// passes the permutation: a block reads its query rows, and their
// intervals, through it, and writes each row's lists to the row's own
// place, so grouping costs no gather or scatter launch. A tile of rows that
// see one interval then has that interval as its union; the tile height
// (64, 32 or 16 rows, split() picks the tallest that the rows per interval
// fill) keeps it so, and chunk c of the grid takes the c-th run of whole
// 128-key tiles of the union, so every block has work and none scores a key
// outside it. Rows past B, and rows with an empty interval (sorted last),
// see nothing. Each score is the same sum in the same order whatever the
// tile height, and a row's top-k is ordered by (score, slot), so the
// outputs are bit for bit those of the rows in any order. Counting only the
// visible work, the tenancy path (B=128, N=65536, four 16384-slot regions)
// needs 1.61 GFLOP (24 us at 67 TFLOP/s) and reads the 100.7 MB f32 slab
// (30 us at 3.35 TB/s), so its bound is set by bytes: the slab does not fit
// the 50 MB L2. Before the grouping, a 64-row tile of round-robin tenants
// spanned all four regions and scored all N for every row, four times the
// visible work (PERF.md, PR 17). Dense form: one byte of the (B, N) mask per
// score, read where the score tile is stored; grouping rows does not help
// it (ROADMAP R4b).
#include <cuda_runtime.h>

#include "warp_topk.cuh"

namespace {

using namespace warp_topk;

constexpr int BN = 128;                       // keys per tile
constexpr int DK = 32;                        // dims per tile
constexpr int NT = 256;                       // threads of a merge block
constexpr int BQ_WIDE = 64, BQ_NARROW = 4;    // query rows per pass-1 block
// the interval form's shorter wide tiles: a tile of rows grouped by interval
// should cover about one interval
constexpr int BQ_32 = 32, BQ_16 = 16;

// The thread layout of a pass-1 block of BQ query rows: TY x TX threads,
// each TQ rows (ty + TY i) x TN keys (tx + TX j) of a score tile.
template <int BQ>
struct Tile {
  static constexpr int NT = BQ >= 16 ? 256 : 32 * BQ;   // narrow: a warp a row
  static constexpr int TY = BQ >= 16 ? 16 : BQ;
  static constexpr int TX = NT / TY;
  static constexpr int TQ = BQ / TY;                     // query rows per thread
  static constexpr int TN = BN / TX;                     // keys per thread
  static constexpr int ROWS_PER_WARP = BQ / (NT / 32);   // top-k lists per warp
  static constexpr int SMEM = BQ * (BN + 1) > DK * (BQ + 1) + DK * (BN + 1)
                                  ? BQ * (BN + 1)
                                  : DK * (BQ + 1) + DK * (BN + 1);
  static_assert(NT >= BN, "one thread per key of a tile loads its scale");
  static_assert(BQ * DK % NT == 0 && BN * DK % NT == 0, "whole rounds of loads");
};

// where a score's visibility comes from (template parameter of pass 1)
enum MaskSource { SHARED_MASK = 0, INTERVAL_MASK = 1, DENSE_MASK = 2 };
// how a key becomes f32: by its type (to_f32: int8 times 1/127), or int8
// times its row's f32 scale (template parameter of pass 1)
enum ScaleSource { TYPE_SCALE = 0, ROW_SCALE = 1 };

// scales: (N,) f32 (ROW_SCALE); valid: (N,) bytes (SHARED_MASK,
// INTERVAL_MASK); starts/sizes: (B,) int32 and order: a (B,) int32
// permutation of the rows (INTERVAL_MASK); mask: (B, N) bytes (DENSE_MASK).
// Unused pointers may be null.
template <typename KT, int MS, int SS, int BQ>
__global__ void __launch_bounds__(Tile<BQ>::NT)
cosine_topk_partial(const float* __restrict__ q, const KT* __restrict__ keys,
                    const float* __restrict__ scales,
                    const uint8_t* __restrict__ valid, const int* __restrict__ starts,
                    const int* __restrict__ sizes, const int* __restrict__ order,
                    const uint8_t* __restrict__ mask, int B, int N, int d, int k,
                    int keys_per_chunk, float* __restrict__ part_s, int* __restrict__ part_i) {
  using L = Tile<BQ>;
  constexpr int NT = L::NT, TX = L::TX, TY = L::TY, TQ = L::TQ, TN = L::TN;
  constexpr int ROWS_PER_WARP = L::ROWS_PER_WARP;
  // The two input tiles of the d loop and the score tile after it share one
  // buffer: qs [DK][BQ + 1] and ks [DK][BN + 1], then sc [BQ][BN + 1]. The +1
  // keeps the transposed stores free of bank conflicts.
  __shared__ float smem[L::SMEM];
  // INTERVAL_MASK: row r of the block is query row row_id[r] (-1 past B),
  // which sees [row_lo[r], row_hi[r])
  __shared__ int row_id[BQ], row_lo[BQ], row_hi[BQ];
  // ROW_SCALE: the scales of the tile's 128 keys
  __shared__ float row_scale[BN];
  float* qs = smem;
  float* ks = smem + DK * (BQ + 1);
  float* sc = smem;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int q0 = blockIdx.y * BQ;
  int n_begin = chunk * keys_per_chunk;
  int n_end = min(N, n_begin + keys_per_chunk);
  // the query row of block row r, and whether it is one: the interval form
  // reads its rows through the permutation `order`, so that a tile holds
  // rows of about one interval, and writes each row's lists to the row's
  // own place
  auto qrow = [=](int r) -> int {
    if constexpr (MS == INTERVAL_MASK) {
      return row_id[r];
    } else {
      return q0 + r;
    }
  };
  auto is_row = [=](int gr) -> bool {
    if constexpr (MS == INTERVAL_MASK) {
      return gr >= 0;
    } else {
      return gr < B;
    }
  };

  float ls[ROWS_PER_WARP];
  int li[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    ls[r] = -INFINITY;
    li[r] = -1;
  }

  if constexpr (MS == INTERVAL_MASK) {
    if (tid < BQ) {
      const int row = q0 + tid < B ? order[q0 + tid] : -1;
      const int lo = row >= 0 ? starts[row] : 0;
      const int sz = row >= 0 ? sizes[row] : 0;
      row_id[tid] = row;
      row_lo[tid] = lo;
      row_hi[tid] = sz > 0 ? lo + sz : lo;
    }
    __syncthreads();
    // keys [lo, hi) hold every slot some row of the block may see; chunk c
    // of the grid takes the c-th of `chunks` runs of whole 128-key tiles of
    // it (keys_per_chunk is not read), so every block of a tile of rows
    // that see one interval has work, and none scores outside the union
    int lo = N, hi = 0;
    for (int r = 0; r < BQ; ++r) {
      if (row_hi[r] > row_lo[r]) {
        lo = min(lo, row_lo[r]);
        hi = max(hi, row_hi[r]);
      }
    }
    const int span = hi > lo ? ((hi - lo + BN - 1) / BN + chunks - 1) / chunks * BN : 0;
    n_begin = lo + chunk * span;
    n_end = min(hi, n_begin + span);
  }

  const int blk_lo = n_begin, blk_hi = n_end;
  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    // never true; without it nvcc schedules the shared and dense forms'
    // loop another way, 2-6% slower on an H100, and with it the interval
    // form's 5-30% slower (PERF.md, PR 17)
    if constexpr (MS != INTERVAL_MASK) {
      if (n0 + BN <= blk_lo || n0 >= blk_hi) continue;
    }
    if constexpr (SS == ROW_SCALE) {
      // the previous tile's last reads of row_scale precede its final barrier
      if (tid < BN) row_scale[tid] = n0 + tid < n_end ? scales[n0 + tid] : 0.0f;
      __syncthreads();
    }
    float acc[TQ][TN];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    // Narrow tiles hold the next 32-dim slice of queries and keys in
    // registers, in flight while this one is multiplied: such a block is one
    // of a few dozen, with no other block on its SM to hide the loads'
    // latency. Wide tiles load and store each slice in one step.
    constexpr bool PREFETCH = BQ == BQ_NARROW;
    constexpr int QL = PREFETCH ? BQ * DK / NT : 1, KL = PREFETCH ? BN * DK / NT : 1;
    float q_next[QL];
    KT k_next[KL];
    auto fetch = [&](int c0) {
#pragma unroll
      for (int p = 0; p < QL; ++p) {
        const int e = tid + p * NT, gr = qrow(e / DK), gc = c0 + e % DK;
        q_next[p] = (is_row(gr) && gc < d) ? q[(size_t)gr * d + gc] : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < KL; ++p) {
        const int e = tid + p * NT, gn = n0 + e / DK, gc = c0 + e % DK;
        if (gn < n_end && gc < d) k_next[p] = keys[(size_t)gn * d + gc];
      }
    };
    if constexpr (PREFETCH) fetch(0);

    for (int c0 = 0; c0 < d; c0 += DK) {
      if constexpr (PREFETCH) {
#pragma unroll
        for (int p = 0; p < QL; ++p) {
          const int e = tid + p * NT;
          qs[(e % DK) * (BQ + 1) + e / DK] = q_next[p];
        }
#pragma unroll
        for (int p = 0; p < KL; ++p) {
          const int e = tid + p * NT, r = e / DK, c = e % DK;
          float v = 0.0f;
          if (n0 + r < n_end && c0 + c < d) {
            if constexpr (SS == ROW_SCALE) {
              // a rounded product, never contracted into the FMAs below
              v = __fmul_rn(static_cast<float>(k_next[p]), row_scale[r]);
            } else {
              v = to_f32(k_next[p]);
            }
          }
          ks[c * (BN + 1) + r] = v;
        }
        __syncthreads();
        if (c0 + DK < d) fetch(c0 + DK);
      } else {
#pragma unroll
        for (int p = 0; p < BQ * DK / NT; ++p) {
          const int e = tid + p * NT, r = e / DK, c = e % DK;
          const int gr = qrow(r), gc = c0 + c;
          qs[c * (BQ + 1) + r] = (is_row(gr) && gc < d) ? q[(size_t)gr * d + gc] : 0.0f;
        }
#pragma unroll
        for (int p = 0; p < BN * DK / NT; ++p) {
          const int e = tid + p * NT, r = e / DK, c = e % DK;
          const int gn = n0 + r, gc = c0 + c;
          float v = 0.0f;
          if (gn < n_end && gc < d) {
            if constexpr (SS == ROW_SCALE) {
              // a rounded product, never contracted into the FMAs below
              v = __fmul_rn(static_cast<float>(keys[(size_t)gn * d + gc]), row_scale[r]);
            } else {
              v = to_f32(keys[(size_t)gn * d + gc]);
            }
          }
          ks[c * (BN + 1) + r] = v;
        }
        __syncthreads();
      }
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
        for (int i = 0; i < TQ; ++i) a[i] = qs[c * (BQ + 1) + ty + TY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ks[c * (BN + 1) + tx + TX * j];
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
      const int r = ty + TY * i, gr = q0 + r;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + TX * j, gn = n0 + col;
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
    const int gr = qrow(warp * ROWS_PER_WARP + r);
    if (is_row(gr) && lane < k) {
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
  const void* scales;
  const void* valid;
  const void* starts;
  const void* sizes;
  const void* order;
  const void* mask;
  int B, N, d, k, keys_per_chunk, chunks, block_q;
  void* part_s;
  void* part_i;
  void* out_s;
  void* out_i;
  cudaStream_t stream;
};

template <typename KT, int MS, int SS, int BQ>
cudaError_t launch_tiles(const Args& a) {
  // one chunk: pass 1's lists are the result, (B, 1, k) is (B, k)
  const bool single = a.chunks == 1;
  const dim3 grid(a.chunks, (a.B + BQ - 1) / BQ);
  cosine_topk_partial<KT, MS, SS, BQ><<<grid, Tile<BQ>::NT, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KT*>(a.keys),
      static_cast<const float*>(a.scales), static_cast<const uint8_t*>(a.valid),
      static_cast<const int*>(a.starts), static_cast<const int*>(a.sizes),
      static_cast<const int*>(a.order), static_cast<const uint8_t*>(a.mask), a.B, a.N, a.d,
      a.k, a.keys_per_chunk,
      static_cast<float*>(single ? a.out_s : a.part_s),
      static_cast<int*>(single ? a.out_i : a.part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || single) return err;
  cosine_topk_merge<<<(a.B + NT / 32 - 1) / (NT / 32), NT, 0, a.stream>>>(
      static_cast<const float*>(a.part_s), static_cast<const int*>(a.part_i), a.B,
      a.chunks, a.k, static_cast<float*>(a.out_s), static_cast<int*>(a.out_i));
  return cudaGetLastError();
}

template <typename KT, int MS, int SS>
cudaError_t launch(const Args& a) {
  if constexpr (MS == INTERVAL_MASK) {
    if (a.block_q == BQ_32) return launch_tiles<KT, MS, SS, BQ_32>(a);
    if (a.block_q == BQ_16) return launch_tiles<KT, MS, SS, BQ_16>(a);
  }
  return a.block_q == BQ_NARROW ? launch_tiles<KT, MS, SS, BQ_NARROW>(a)
                                : launch_tiles<KT, MS, SS, BQ_WIDE>(a);
}

// the interval form chunks each tile's union of intervals itself, so its
// keys_per_chunk need not cover N
template <int MS>
bool bad_split(const Args& a) {
  const bool interval = MS == INTERVAL_MASK;
  const bool tile_ok = a.block_q == BQ_WIDE || a.block_q == BQ_NARROW ||
                       (interval && (a.block_q == BQ_32 || a.block_q == BQ_16));
  return a.B < 1 || a.N < 1 || a.d < 1 || a.k < 1 || a.k > MAX_K || a.chunks < 1 ||
         (!interval && (a.keys_per_chunk < 1 || (long long)a.chunks * a.keys_per_chunk < a.N ||
                        (long long)(a.chunks - 1) * a.keys_per_chunk >= a.N)) ||
         (interval && a.order == nullptr) || !tile_ok ||
         (a.chunks > 1 && (a.part_s == nullptr || a.part_i == nullptr));
}

// key_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (scaled by 1/127)
template <int MS>
int dispatch(int key_dtype, const Args& a) {
  if (bad_split<MS>(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (key_dtype) {
    case 0:
      return launch<float, MS, TYPE_SCALE>(a);
    case 1:
      return launch<__nv_bfloat16, MS, TYPE_SCALE>(a);
    case 2:
      return launch<int8_t, MS, TYPE_SCALE>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int8 keys with per-row (N,) f32 scales
template <int MS>
int dispatch_quant(const Args& a) {
  if (bad_split<MS>(a) || a.scales == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int8_t, MS, ROW_SCALE>(a);
}

}  // namespace

extern "C" {

// Each entry point returns the cudaError_t of its launches (0 on success).
// key_dtype: 0 = float32, 1 = bfloat16, 2 = int8. part_s/part_i hold
// B * chunks * k entries, or may be null when chunks == 1; chunks *
// keys_per_chunk must cover N (not read by the interval forms); block_q is
// the query-tile height of pass 1, 64 or 4, and for the interval forms also
// 32 or 16.

// shared (N,) mask
int cosine_topk_launch(const void* q, const void* keys, int key_dtype, const void* valid,
                       int B, int N, int d, int k, int keys_per_chunk, int chunks,
                       int block_q, void* part_s, void* part_i, void* out_s, void* out_i,
                       void* stream) {
  const Args a{q, keys, nullptr, valid, nullptr, nullptr, nullptr, nullptr, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch<SHARED_MASK>(key_dtype, a);
}

// shared (N,) mask and per-row (B,) int32 intervals; the caller guarantees
// 0 <= starts, 0 <= sizes and starts + sizes <= N. order is a (B,) int32
// permutation of the rows, the order in which tiles take them (outputs stay
// in row order); rows of one interval side by side make the kernel fast.
int cosine_topk_interval_launch(const void* q, const void* keys, int key_dtype,
                                const void* valid, const void* starts, const void* sizes,
                                const void* order, int B, int N, int d, int k,
                                int keys_per_chunk, int chunks, int block_q, void* part_s,
                                void* part_i, void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, nullptr, valid, starts, sizes, order, nullptr, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch<INTERVAL_MASK>(key_dtype, a);
}

// dense (B, N) bool mask, row-major
int cosine_topk_masked_launch(const void* q, const void* keys, int key_dtype,
                              const void* mask, int B, int N, int d, int k,
                              int keys_per_chunk, int chunks, int block_q, void* part_s,
                              void* part_i, void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, nullptr, nullptr, nullptr, nullptr, nullptr, mask, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch<DENSE_MASK>(key_dtype, a);
}

// The per-row-scale forms: keys (N, d) int8, scales (N,) f32; otherwise as
// the three above.
int quant_cosine_topk_launch(const void* q, const void* keys, const void* scales,
                             const void* valid, int B, int N, int d, int k,
                             int keys_per_chunk, int chunks, int block_q, void* part_s,
                             void* part_i, void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, scales, valid, nullptr, nullptr, nullptr, nullptr, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch_quant<SHARED_MASK>(a);
}

int quant_cosine_topk_interval_launch(const void* q, const void* keys, const void* scales,
                                      const void* valid, const void* starts,
                                      const void* sizes, const void* order, int B, int N,
                                      int d, int k, int keys_per_chunk, int chunks, int block_q,
                                      void* part_s, void* part_i, void* out_s, void* out_i,
                                      void* stream) {
  const Args a{q, keys, scales, valid, starts, sizes, order, nullptr, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch_quant<INTERVAL_MASK>(a);
}

int quant_cosine_topk_masked_launch(const void* q, const void* keys, const void* scales,
                                    const void* mask, int B, int N, int d, int k,
                                    int keys_per_chunk, int chunks, int block_q, void* part_s,
                                    void* part_i, void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, scales, nullptr, nullptr, nullptr, nullptr, mask, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch_quant<DENSE_MASK>(a);
}

const char* cosine_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
