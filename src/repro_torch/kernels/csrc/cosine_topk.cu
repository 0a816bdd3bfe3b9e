// Masked cosine top-k over the cache slab, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py::_cosine_topk_kernel
// in its six forms, one C entry point each: three visibility forms
//   cosine_topk_launch           shared (N,) validity mask (cosine_topk_pallas)
//   cosine_topk_interval_launch  shared mask and one slot interval per row,
//                                [starts[b], starts[b] + sizes[b]), the
//                                tenancy path (cosine_topk_interval_pallas)
//   cosine_topk_masked_launch    dense (B, N) bool mask, aliveness folded in
//                                by the caller (cosine_topk_masked_pallas),
//                                after its pass 0,
//                                cosine_topk_tile_summary_launch
// and the same three over an int8 slab with a per-row (N,) f32 scale
//   quant_cosine_topk_launch           (quant_cosine_topk_pallas)
//   quant_cosine_topk_interval_launch  (quant_cosine_topk_interval_pallas)
//   quant_cosine_topk_masked_launch    (quant_cosine_topk_masked_pallas)
// scores = queries (B, d) x keys (N, d)^T, then the k <= 32 best visible
// slots of each row, ordered by (score desc, slot id asc), with (-inf, -1) where
// fewer than k slots are visible. Keys are f32, bf16 or int8, loaded as they
// are stored (int8 one byte each). The mask source (a template parameter)
// decides which scores are offered to the top-k lists, so a slot outside a
// row's interval (or dense mask) never enters that row's list, whatever its
// score or slot id. The scale source turns a key into the plain version's
// f32 operand: by its type (int8 times 1/127, the slab's uniform
// quantization) or as float(kq) * scales[n], the product the Pallas kernel
// and the plain version form before their GEMM.
//
// Two pass-1 loops. The shared-mask forms (the serve path: rows 1 and 2 of
// PERF.md §6) run on tensor cores (cosine_topk_tc, 128-row tiles); the
// interval and dense forms, and the shared forms where 128-row tiles do not
// pay (the IVF probe, a few queries), run f32 FMAs on CUDA cores
// (cosine_topk_partial, 64-, 32-, 16- and 4-row tiles). Each loop is its own
// kernel, so a change to one does not move the other's code.
//
// Bound on an H100 SXM at the main path's shapes (B=128, d=384, N=16384, f32
// keys): the tensor-core form does 3 TF32 products per f32 product (3 x 1.61
// GFLOP at the 494.7 TFLOP/s dense TF32 peak: 9.8 us); int8 keys take 2
// (6.5 us); reading the 25.4 MB f32 slab at 3.35 TB/s takes 7.6 us, the
// 6.6 MB int8 one 2.0 us. So it is bound by operations. On f32 FMAs (67
// TFLOP/s) the same 1.61 GFLOP take 24 us. TF32 alone errs by ~5e-5 on a
// score at d=384 (tests/test_torch_tf32.py), past the 1.85e-5 by which the
// paper configuration's closest score clears the 0.8 threshold; 3xTF32
// stays within ~2e-7 of the f32 products.
//
// Design. The TPU kernel carries a running top-k across a sequential grid;
// CUDA blocks run in no order, so this is two passes.
//   Pass 1, grid (N-chunks, query tiles): each block scores its chunk of
//     whole 128-key tiles against its query tile and keeps, per query row,
//     the k best; it writes them to partial (B, chunks, k), or straight to
//     the output when there is one chunk.
//   Pass 2 merges each row's chunks x k candidates, one warp per row; it is
//     not launched when there is one chunk.
// Tensor-core form (block_q = 128, tc:: below). A block takes 128 query rows
// (the serve path's whole batch, so every key is read once from device
// memory) and 128-key tiles in 32-dim slices, STAGES - 1 slices of queries
// and keys in flight by 16-byte cp.async while one is multiplied, across
// tile boundaries; the main shape is 128 blocks of one tile each, one block
// an SM (~210 KB of shared memory, 230-250 registers, no spills). Each warp
// computes a 64 x 32 patch with mma.sync.m16n8k8 TF32: per 8 dims, a_lo
// b_hi + a_hi b_lo + a_hi b_hi, where hi is x rounded to TF32 by integer
// operations and lo = x - hi (the tensor cores drop its low 13 bits);
// queries and f32 keys reach the registers by ldmatrix and are split there.
// bf16 keys are exact in TF32, and int8 keys enter as they are stored,
// their scale multiplying the sum (a rounding ~1e-7 from the plain
// version's): two products. As in the FMA form, a fresh sum per 32-dim
// slice is added to the tile's f32 sum, and two equal key rows get
// bitwise-equal scores, so ties resolve by slot id alone. The tile's scores,
// masked, go to shared memory; for k <= 4 two threads a row take half its
// keys each into a sorted 4-entry list by a branch-free compare-exchange
// (ids rise, so a tie never ranks first), skipping groups of four below the
// list's last entry; pass 2 is then one warp a row over lane-held 4-entry
// lists merged by a shuffle butterfly. For larger k a warp a row keeps a
// list of one entry per lane (warp_topk.cuh) across the tiles, and pass 2
// is the FMA form's.
// FMA form (cosine_topk_partial): each thread accumulates a patch of scores
// with FMAs over d in the same two-level order; each score tile is masked
// and offered to one warp-held list per query row, so the IVF probe's k=16
// runs the same code as the main path's k=4. Its tile heights:
//   wide, 64, 32 or 16 rows (interval and dense forms): 256 threads in
//     16 x 16, a 4, 2 or 1 x 8 patch each, 8, 4 or 2 rows a warp in the
//     top-k.
//   narrow, 4 rows: 128 threads, one warp per query row, each lane 4 keys
//     (lane + 32 j) of its row, the next 32-dim slice of queries and keys
//     loaded into registers while this one is multiplied. Taken where wider
//     tiles would leave SMs idle: the IVF probe (B=128 queries over N=128
//     centroids) gets 32 blocks and one launch, and by the shared forms
//     where B < 32 or B x N < 2^18 (kernels/cosine_topk.py::split).
// A query row's scores thus depend on its batch: on tensor cores in a batch
// of 128, on FMAs alone, within ~1e-6 (ROADMAP, Queue C).
// Left for later work: mma.sync reaches about half of the TF32 peak, and the
// products, with the hi/lo splits, bound the tensor-core form; wgmma, with
// the split overlapped with the products, is the next step. The FMA form's
// wide tiles still load 12 words from shared memory per 32 FMAs.
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
// visible work (PERF.md §6).
//
// Dense form. A (B, N) mask has no interval per row, but each row can be
// summarized by the set of 128-key tiles in which it sees a slot. Pass 0
// (cosine_topk_tile_summary, one block a row, 16-byte loads: the mask is
// read once) writes that set as a bitmap and a sort key (first tile, last
// tile, count of tiles) and cosine_topk_rank_rows the rows' stable
// order by key; the wrapper (kernels/cosine_topk.py::masked_plan) reads back the
// number of distinct keys and the largest set, from which split() picks the
// tile height (64, 32 or 16, as for intervals) and the chunks. Pass 1 reads
// its rows through the sorted order, ORs their bitmaps into the tile's
// union, and chunk c takes the c-th run of the union's tiles into a list in
// shared memory (at most DENSE_LIST), so no block scores a key tile that
// none of its rows sees, and every block has work. Inside a tile one byte
// of the mask per score, read where the score tile is stored, decides
// visibility. The sums are the interval form's, so a dense search and an
// interval search of one visibility agree bit for bit, in any row order.
// At the timing shape (four regions, rows round robin) the dense form
// scored every pair, four times the visible work, before rows were grouped
// (PERF.md §6).
#include <cuda_runtime.h>

#include <climits>

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
// the dense form: the most 128-key tiles one block scores (its list of them
// sits in shared memory); the wrapper takes chunks >= ceil(tiles / this)
constexpr int DENSE_LIST = 1024;

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

// Exclusive prefix sum of v over the block's NT threads in thread order, and
// the block's total. Every thread calls it; tmp holds NT / 32 ints.
template <int NT>
__device__ __forceinline__ int block_scan(int v, int& total, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int t = tmp[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();   // tmp is written again by the next call
  return before + x - v;
}

// scales: (N,) f32 (ROW_SCALE); valid: (N,) bytes (SHARED_MASK,
// INTERVAL_MASK); starts/sizes: (B,) int32 (INTERVAL_MASK); order: a (B,)
// int32 permutation of the rows (INTERVAL_MASK, DENSE_MASK); mask: (B, N)
// bytes and tile_bits: (B, W) words, bit t of a row set where the row sees a
// slot of 128-key tile t (DENSE_MASK, from cosine_topk_tile_summary). Unused
// pointers may be null.
template <typename KT, int MS, int SS, int BQ>
__global__ void __launch_bounds__(Tile<BQ>::NT)
cosine_topk_partial(const float* __restrict__ q, const KT* __restrict__ keys,
                    const float* __restrict__ scales,
                    const uint8_t* __restrict__ valid, const int* __restrict__ starts,
                    const int* __restrict__ sizes, const int* __restrict__ order,
                    const uint8_t* __restrict__ mask, const unsigned* __restrict__ tile_bits,
                    int B, int N, int d, int k, int keys_per_chunk, float* __restrict__ part_s,
                    int* __restrict__ part_i) {
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
  // DENSE_MASK: the 128-key tiles this block scores, in slot order; NT
  // words of the union of its rows' bitmaps at a time
  __shared__ int tile_list[MS == DENSE_MASK ? DENSE_LIST : 1];
  __shared__ int scan_tmp[MS == DENSE_MASK ? NT / 32 : 1];
  __shared__ unsigned union_words[MS == DENSE_MASK ? NT : 1];
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
  // the query row of block row r, and whether it is one: the interval and
  // dense forms read their rows through the permutation `order`, so that a
  // tile holds rows that see about the same slots, and write each row's
  // lists to the row's own place
  auto qrow = [=](int r) -> int {
    if constexpr (MS != SHARED_MASK) {
      return row_id[r];
    } else {
      return q0 + r;
    }
  };
  auto is_row = [=](int gr) -> bool {
    if constexpr (MS != SHARED_MASK) {
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

  if constexpr (MS == DENSE_MASK) {
    if (tid < BQ) row_id[tid] = q0 + tid < B ? order[q0 + tid] : -1;
    __syncthreads();
    // the tiles some row of the block sees: words [w0, w0 + NT) of the
    // union of its rows' bitmaps into union_words. A word's tpw threads (a
    // power of two, within one warp) OR every tpw-th row's word, then
    // combine by shuffles: no two threads write one word.
    const int W = ((N + BN - 1) / BN + 31) / 32;
    auto union_round = [&](int w0) {
      const int words = min(NT, W - w0);
      int tpw = 32;
      while (tpw > 1 && tpw * words > NT) tpw >>= 1;
      const int w = tid / tpw, j = tid % tpw;
      union_words[tid] = 0;
      unsigned u = 0;
      if (w < words) {
#pragma unroll 4
        for (int r = j; r < BQ; r += tpw) {
          const int row = row_id[r];
          if (row >= 0) u |= tile_bits[(size_t)row * W + w0 + w];
        }
      }
      for (int o = tpw / 2; o > 0; o >>= 1) u |= __shfl_xor_sync(FULL, u, o);
      __syncthreads();
      if (j == 0 && w < words) union_words[w] = u;
      __syncthreads();
    };
    int mine = 0, seen = 0;
    for (int w0 = 0; w0 < W; w0 += NT) {
      if (w0 > 0) __syncthreads();   // union_words read before it is cleared
      union_round(w0);
      mine += __popc(union_words[tid]);
    }
    block_scan<NT>(mine, seen, scan_tmp);
    // chunk c of the grid takes the c-th of `chunks` runs of the union's
    // tiles, in slot order: at most DENSE_LIST, as the wrapper's chunks
    // ensure (bad_split), so every block of a tile of rows that see alike
    // has work, and none scores a tile that no row of it sees
    const int per = (seen + chunks - 1) / chunks;
    const int lo = min(seen, chunk * per), hi = min(seen, lo + per);
    seen = 0;   // the union's tiles before this round's words
    for (int w0 = 0; w0 < W && seen < hi; w0 += NT) {
      // one round: union_words still holds it
      if (W > NT) union_round(w0);
      unsigned u = union_words[tid];
      int round;
      int rank = seen + block_scan<NT>(__popc(u), round, scan_tmp);
      for (; u != 0; u &= u - 1, ++rank)
        if (rank >= lo && rank < hi) tile_list[rank - lo] = (w0 + tid) * 32 + __ffs(u) - 1;
      seen += round;
    }
    __syncthreads();
    // positions v0 = 0, BN, ... of the loop below are the listed tiles
    n_begin = 0;
    n_end = (hi - lo) * BN;
  }

  // keys past key_end are not read: the chunk's end, or N where the
  // positions of the loop are listed tiles
  const int key_end = MS == DENSE_MASK ? N : n_end;
  // the query row of each of this thread's loads of a slice (wide tiles),
  // in registers: read through row_id at every load they cost the grouped
  // forms 7-15% on an H100, and the interval form's 32-row tiles 154-164
  // registers a thread, one block an SM (masked_variants.py, PERF.md §6)
  int q_rows[BQ * DK / NT];
#pragma unroll
  for (int p = 0; p < BQ * DK / NT; ++p) q_rows[p] = qrow((tid + p * NT) / DK);
  const int blk_lo = n_begin, blk_hi = n_end;
  for (int v0 = n_begin; v0 < n_end; v0 += BN) {
    int n0 = v0;
    if constexpr (MS == DENSE_MASK) n0 = tile_list[v0 / BN] * BN;
    // never true; without it nvcc schedules the shared form's narrow loop
    // (the IVF probe) another way, 2-6% slower on an H100, and with it the
    // interval form's 5-30% slower (PERF.md §6)
    if constexpr (MS == SHARED_MASK) {
      if (n0 + BN <= blk_lo || n0 >= blk_hi) continue;
    }
    if constexpr (SS == ROW_SCALE) {
      // the previous tile's last reads of row_scale precede its final barrier
      if (tid < BN) row_scale[tid] = n0 + tid < key_end ? scales[n0 + tid] : 0.0f;
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
        if (gn < key_end && gc < d) k_next[p] = keys[(size_t)gn * d + gc];
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
          if (n0 + r < key_end && c0 + c < d) {
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
          const int gr = q_rows[p], gc = c0 + c;
          qs[c * (BQ + 1) + r] = (is_row(gr) && gc < d) ? q[(size_t)gr * d + gc] : 0.0f;
        }
#pragma unroll
        for (int p = 0; p < BN * DK / NT; ++p) {
          const int e = tid + p * NT, r = e / DK, c = e % DK;
          const int gn = n0 + r, gc = c0 + c;
          float v = 0.0f;
          if (gn < key_end && gc < d) {
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
      const int r = ty + TY * i, gr = qrow(r);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + TX * j, gn = n0 + col;
        bool vis = gn < key_end;
        if (MS == SHARED_MASK) {
          vis = vis && valid[gn];
        } else if (MS == INTERVAL_MASK) {
          vis = vis && valid[gn] && gn >= row_lo[r] && gn < row_hi[r];
        } else {
          vis = vis && is_row(gr) && mask[(size_t)gr * N + gn];
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

// Pass 0 of the dense form: the (B, N) mask summarized per row, one block a
// row. Thread t reads bytes [16 t, 16 t + 16) of each 4,096-byte run of the
// row (32 tiles, one bitmap word), SUMMARY_WORDS runs in flight; a warp's
// ballot gives its 4 tiles' flags. Writes
//   tile_bits (B, W): bit t % 32 of word t / 32 set where the row sees a slot
//     of 128-key tile t (bytes past N count as not visible);
//   tiles (B,): the number of such tiles;
//   sort_key (B,): (first tile << 39) | (last tile << 15) | min(tiles,
//     2^15 - 1), or INT64_MAX for a row that sees nothing. Rows with equal
//     bitmaps get equal keys, so a stable sort of the keys
//     (cosine_topk_rank_rows) puts them side by side, ordered by where
//     they see, the empty rows last.
// The plain version is repro_torch/kernels/ref.py::tile_summary_ref.
constexpr int SUMMARY_NT = 256;   // 8 warps x 4 tiles: one bitmap word a run
constexpr int SUMMARY_WORDS = 8;  // runs in flight per step

__global__ void __launch_bounds__(SUMMARY_NT)
cosine_topk_tile_summary(const uint8_t* __restrict__ mask, int N, int W, bool vec,
                         unsigned* __restrict__ tile_bits, long long* __restrict__ sort_key,
                         int* __restrict__ tiles) {
  __shared__ unsigned flags[SUMMARY_WORDS][SUMMARY_NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const uint8_t* m = mask + row * N;
  // thread j < SUMMARY_WORDS assembles word w0 + j of each step and keeps
  // the first and last tile and the count of its words
  int first = INT_MAX, last = -1, count = 0;
  for (int w0 = 0; w0 < W; w0 += SUMMARY_WORDS) {
    bool seen[SUMMARY_WORDS];
#pragma unroll
    for (int j = 0; j < SUMMARY_WORDS; ++j) {
      const long long at = (long long)(w0 + j) * (32 * BN) + 16 * tid;
      seen[j] = false;
      if (at + 16 <= N && vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(m + at));
        seen[j] = (v.x | v.y | v.z | v.w) != 0;
      } else if (at < N) {
        for (int e = 0; e < 16 && at + e < N; ++e) seen[j] = seen[j] || m[at + e] != 0;
      }
    }
#pragma unroll
    for (int j = 0; j < SUMMARY_WORDS; ++j) {
      const unsigned ballot = __ballot_sync(FULL, seen[j]);
      // lanes 8i..8i+7 read tile i of the warp's four
      unsigned nib = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) nib |= ((ballot >> (8 * i)) & 0xffu) != 0 ? 1u << i : 0u;
      if (lane == 0) flags[j][warp] = nib;
    }
    __syncthreads();
    const int w = w0 + tid;
    if (tid < SUMMARY_WORDS && w < W) {
      unsigned word = 0;
#pragma unroll
      for (int i = 0; i < SUMMARY_NT / 32; ++i) word |= flags[tid][i] << (4 * i);
      tile_bits[row * W + w] = word;
      if (word != 0) {
        first = min(first, w * 32 + __ffs(word) - 1);
        last = max(last, w * 32 + 31 - __clz(word));
        count += __popc(word);
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      first = min(first, __shfl_xor_sync(FULL, first, o));
      last = max(last, __shfl_xor_sync(FULL, last, o));
      count += __shfl_xor_sync(FULL, count, o);
    }
    if (lane == 0) {
      tiles[row] = count;
      sort_key[row] = count == 0 ? LLONG_MAX
                                 : ((long long)first << 39) | ((long long)last << 15) |
                                       min(count, (1 << 15) - 1);
    }
  }
}

// The rows in the stable order of pass 0's sort keys: row i goes to place
// #{j : (key[j], j) < (key[i], i)}, counted by thread i over the keys staged
// in shared memory. O(B^2) comparisons, a few microseconds at B=128 where a
// library sort takes several launches; the plain version is a stable sort.
constexpr int RANK_NT = 256;
__global__ void __launch_bounds__(RANK_NT)
cosine_topk_rank_rows(const long long* __restrict__ sort_key, int B, int* __restrict__ order) {
  __shared__ long long staged[RANK_NT];
  const int i = blockIdx.x * RANK_NT + threadIdx.x;
  const long long mine = i < B ? sort_key[i] : LLONG_MAX;
  int rank = 0;
  for (int j0 = 0; j0 < B; j0 += RANK_NT) {
    const int j = j0 + threadIdx.x;
    staged[threadIdx.x] = j < B ? sort_key[j] : LLONG_MAX;
    __syncthreads();
    const int m = min(RANK_NT, B - j0);
    for (int t = 0; t < m; ++t) {
      const long long other = staged[t];
      rank += other < mine || (other == mine && j0 + t < i);
    }
    __syncthreads();
  }
  if (i < B) order[rank] = i;
}

// ---------------------------------------------------------------------------
// The tensor-core form of the shared-mask pass 1 (block_q == tc::BQ).
namespace tc {
constexpr int BQ = 128;     // query rows a block: the serve path's whole batch
constexpr int BN = 128;     // keys a tile
constexpr int STAGES = 3;   // 32-dim slices of queries and keys in flight
constexpr int NT = 256;     // 8 warps: 2 along the query rows x 4 along the keys
constexpr int WARPS_N = 4;
constexpr int WM = BQ / (NT / 32 / WARPS_N);   // 64 query rows a warp
constexpr int WN = BN / WARPS_N;               // 32 keys a warp
constexpr int MT = WM / 16, NT8 = WN / 8;      // m16n8k8 tiles a warp: 4 x 4
constexpr int SMALL_K = 4;  // k up to this: two threads a row keep its lists
constexpr int RPW = BQ / (NT / 32);            // rows a warp keeps for larger k
// Staged rows are padded by 16 bytes, so that the 8 rows of an ldmatrix, or
// the 8 x 4 lanes of a fragment load, hit distinct banks (f32 rows 36 words
// apart, bf16 20, int8 12).
constexpr int Q_PITCH = DK * 4 + 16;           // bytes a staged query row
// floats a score-tile row: 16-byte rows, so that a warp's 32 rows read
// as float4 hit every bank once
constexpr int SC_PITCH = BN + 4;
template <typename KT>
__host__ __device__ constexpr int k_pitch() { return DK * static_cast<int>(sizeof(KT)) + 16; }
template <typename KT>
__host__ __device__ constexpr int stage_bytes() { return BQ * Q_PITCH + BN * k_pitch<KT>(); }
// the stages, the score tile and the lists (MAX_K entries a row)
template <typename KT>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<KT>() + BQ * SC_PITCH * 4 + BQ * MAX_K * 8;
}
static_assert(NT == 2 * BQ, "two threads a row keep the small-k lists");
static_assert(smem_bytes<float>() <= 227 * 1024, "one block an SM");
}  // namespace tc

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 (10 mantissa bits, ties away from zero, as
// cvt.rna.tf32.f32) by integer operations, which issue faster than cvt (3.6
// us of 45 at the main shape, cosine_variants.py)
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  r = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return r;
}
// x = hi + lo to about 21 bits: hi its TF32 rounding, lo the rest (exact in
// f32), whose low 13 bits the tensor cores drop: |lo| <= 2^-11 |x|, so the
// dropped part is under 2^-21 |x| (rounding lo too cost 1.9 us of 42.7,
// cosine_variants.py)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}
// four 8 x 4 tiles of 32-bit words (an m8n8 b16 ldmatrix each): lane l
// gives the row address of tile l / 8, row l % 8; each lane gets word
// (l % 4) of row l / 4 of every tile
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16 x 8, row major) * b (8 x 8, column major), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A bf16 or int8 key as it is stored, in f32: exact in TF32, so its lo is 0
__device__ __forceinline__ float stored_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float stored_f32(int8_t v) { return static_cast<float>(v); }

// Inserts (s, id) into a sorted list of SMALL_K entries held by one thread:
// the entries it ranks before shift down one place, the last drops out; no
// branch. RISING: every id in the list is below id, so a tie never ranks
// first and a score comparison decides.
template <bool RISING>
__device__ __forceinline__ void insert_small(float (&ls)[tc::SMALL_K], int (&li)[tc::SMALL_K],
                                             float s, int id) {
  bool before[tc::SMALL_K];
#pragma unroll
  for (int e = 0; e < tc::SMALL_K; ++e)
    before[e] = RISING ? s > ls[e] : ranks_before(s, id, ls[e], li[e]);
#pragma unroll
  for (int e = tc::SMALL_K - 1; e >= 0; --e) {
    const bool shift = e > 0 && before[e - 1];
    ls[e] = before[e] ? (shift ? ls[e - 1] : s) : ls[e];
    li[e] = before[e] ? (shift ? li[e - 1] : id) : li[e];
  }
}

// Pass 1 of the shared-mask form on tensor cores. A block takes 128 query
// rows and a chunk of whole 128-key tiles; every (tile, 32-dim slice) is one
// step of a pipeline that keeps STAGES - 1 slices of queries and keys in
// flight by cp.async (vec) while one is multiplied, across tile boundaries.
// Each warp computes a 64 x 32 patch of the tile's scores with 3xTF32:
// per k-step of 8, a_lo b_hi + a_hi b_lo + a_hi b_hi (bf16 and int8 keys
// are exact in TF32: two products), into a fresh sum per 32-dim slice added
// to the tile's f32 sum, the plain FMA form's two levels. After a tile's
// last slice its masked scores go to shared memory and into the lists,
// which stay in shared memory across the chunk's tiles: for k <= SMALL_K
// two threads a row scan half the tile's keys each (a warp reads 32 rows of
// one column, no bank conflict), for larger k a warp a row offers 32 keys
// at a time.
// Without vec (rows not 16-byte aligned: d * sizeof(KT) % 16 != 0), each
// thread stages elements by plain loads; the sums are the same.
template <typename KT, int SS>
__global__ void __launch_bounds__(tc::NT, 1)
cosine_topk_tc(const float* __restrict__ q, const KT* __restrict__ keys,
               const float* __restrict__ scales, const uint8_t* __restrict__ valid, int B,
               int N, int d, int k, int keys_per_chunk, bool vec, float* __restrict__ part_s,
               int* __restrict__ part_i) {
  constexpr int BQ = tc::BQ, BN = tc::BN, STAGES = tc::STAGES, NT = tc::NT;
  constexpr int WARPS_N = tc::WARPS_N, WM = tc::WM, WN = tc::WN, MT = tc::MT, NT8 = tc::NT8;
  constexpr int SMALL_K = tc::SMALL_K, RPW = tc::RPW;
  constexpr int Q_PITCH = tc::Q_PITCH, SC_PITCH = tc::SC_PITCH;
  constexpr int KP = tc::k_pitch<KT>();
  constexpr int SB = tc::stage_bytes<KT>();
  // int8 keys enter the products as they are stored (exact in TF32, so two
  // products, not three) and their scale, 1/127 or the row's, multiplies
  // the sum: a rounding that differs from the plain version's by ~1e-7
  constexpr bool POST_SCALE = sizeof(KT) == 1;
  constexpr bool EXACT = sizeof(KT) < 4;   // bf16 or int8: lo is 0
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem + STAGES * SB);
  float* lst_s = sc + BQ * SC_PITCH;
  int* lst_i = reinterpret_cast<int*>(lst_s + BQ * MAX_K);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, thread in group
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int n_begin = chunk * keys_per_chunk;
  const int n_end = min(N, n_begin + keys_per_chunk);
  const int slices = (d + DK - 1) / DK;
  const int steps = (n_end - n_begin + BN - 1) / BN * slices;

  for (int e = tid; e < BQ * MAX_K; e += NT) {
    lst_s[e] = -INFINITY;
    lst_i[e] = -1;
  }

  // queries [BQ][DK] f32 and keys [BN][DK] as stored, rows and dims past the
  // operands zero
  auto stage = [&](int step) {
    const int n0 = n_begin + step / slices * BN, c0 = step % slices * DK;
    unsigned char* qs = smem + step % STAGES * SB;
    unsigned char* ks = qs + BQ * Q_PITCH;
    if (vec) {
      constexpr int QV = 4, QC = DK / QV;   // floats a copy, copies a row
#pragma unroll
      for (int p = 0; p < BQ * QC / NT; ++p) {
        const int e = tid + p * NT, r = e / QC, c = e % QC * QV;
        const bool ok = q0 + r < B && c0 + c < d;
        cp_async16(qs + r * Q_PITCH + c * 4, ok ? q + (size_t)(q0 + r) * d + c0 + c : q, ok);
      }
      constexpr int KV = 16 / sizeof(KT), KC = DK / KV;
#pragma unroll
      for (int p = 0; p < BN * KC / NT; ++p) {
        const int e = tid + p * NT, r = e / KC, c = e % KC * KV;
        const bool ok = n0 + r < n_end && c0 + c < d;
        cp_async16(ks + r * KP + c * sizeof(KT), ok ? keys + (size_t)(n0 + r) * d + c0 + c : keys,
                   ok);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < BQ * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        reinterpret_cast<float*>(qs + r * Q_PITCH)[c] =
            q0 + r < B && c0 + c < d ? q[(size_t)(q0 + r) * d + c0 + c] : 0.0f;
      }
#pragma unroll 4
      for (int e = tid; e < BN * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        KT v{};
        if (n0 + r < n_end && c0 + c < d) v = keys[(size_t)(n0 + r) * d + c0 + c];
        reinterpret_cast<KT*>(ks + r * KP)[c] = v;
      }
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s);
    cp_async_commit();
  }

  float acc[MT][NT8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int tile = s / slices, slice = s % slices;
    // step s has landed, and every thread is done with step s - 1, whose
    // buffer the next copies overwrite
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) stage(s + STAGES - 1);
    cp_async_commit();

    // the last slice of a tile loads the visibility (and, POST_SCALE, the
    // scale) of this thread's 8 score columns, in flight during its products
    const int n0 = n_begin + tile * BN;
    bool vis[NT8][2];
    float post[NT8][2];
    if (slice == slices - 1) {
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + wn * WN + j * 8 + 2 * t + h;
          vis[j][h] = n < n_end && valid[n];
          if constexpr (POST_SCALE)
            post[j][h] = SS == ROW_SCALE ? (n < n_end ? scales[n] : 0.0f) : 1.0f / 127.0f;
        }
    }

    const unsigned char* qs = smem + s % STAGES * SB;
    const unsigned char* ks = qs + BQ * Q_PITCH;
    float part[MT][NT8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][j][c] = 0.0f;
    // this lane's ldmatrix rows: of the queries, and of f32 keys
    const int lm = lane >> 3, lr = lane & 7;
    const unsigned char* a_row = qs + (wm * WM + lr + 8 * (lm & 1)) * Q_PITCH + 16 * (lm >> 1);
    const unsigned char* b_row = ks + (wn * WN + lr + 8 * (lm >> 1)) * KP + 16 * (lm & 1);
#pragma unroll
    for (int kk = 0; kk < DK; kk += 8) {
      // fragments of the f32 words as staged, split into hi and lo here
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned raw[4];
        ldmatrix_x4(raw, a_row + i * 16 * Q_PITCH + kk * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(__uint_as_float(raw[c]), ah[i][c], al[i][c]);
      }
#pragma unroll
      for (int jj = 0; jj < NT8; jj += 2) {
        // b[0], b[1]: n-tile jj; b[2], b[3]: n-tile jj + 1
        unsigned bh[4], bl[4];
        if constexpr (sizeof(KT) == 4) {
          unsigned raw[4];
          ldmatrix_x4(raw, b_row + jj * 8 * KP + kk * 4);
#pragma unroll
          for (int c = 0; c < 4; ++c) split_tf32(__uint_as_float(raw[c]), bh[c], bl[c]);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const KT* kr = reinterpret_cast<const KT*>(ks + (wn * WN + (jj + h) * 8 + g) * KP);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              bh[2 * h + c] = __float_as_uint(stored_f32(kr[kk + t + 4 * c]));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_tf32(part[i][jj + h], al[i], bh[2 * h], bh[2 * h + 1]);
            if constexpr (!EXACT) mma_tf32(part[i][jj + h], ah[i], bl[2 * h], bl[2 * h + 1]);
            mma_tf32(part[i][jj + h], ah[i], bh[2 * h], bh[2 * h + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];

    if (slice < slices - 1) continue;
    // the tile's scores, masked, to shared memory; then into the lists
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wm * WM + i * 16 + g;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int c = wn * WN + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s0 = acc[i][j][h], s8 = acc[i][j][2 + h];
          if constexpr (POST_SCALE) {
            s0 = __fmul_rn(s0, post[j][h]);
            s8 = __fmul_rn(s8, post[j][h]);
          }
          sc[r * SC_PITCH + c + h] = vis[j][h] ? s0 : -INFINITY;
          sc[(r + 8) * SC_PITCH + c + h] = vis[j][h] ? s8 : -INFINITY;
        }
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) acc[i][j][c4] = 0.0f;
      }
    }
    __syncthreads();
    if (k <= SMALL_K) {
      // thread tid: row tid % BQ, keys [half * BN/2, (half + 1) * BN/2) of
      // each tile, so its ids rise; a list of SMALL_K entries, of which the
      // first k are the row's
      const int r = tid % BQ, half = tid / BQ;
      if (q0 + r < B) {
        float* ps = lst_s + r * MAX_K + half * SMALL_K;
        int* pi = lst_i + r * MAX_K + half * SMALL_K;
        float ls[SMALL_K];
        int li[SMALL_K];
#pragma unroll
        for (int e = 0; e < SMALL_K; ++e) {
          ls[e] = ps[e];
          li[e] = pi[e];
        }
        const float4* row = reinterpret_cast<const float4*>(sc + r * SC_PITCH + half * (BN / 2));
        const int id0 = n0 + half * (BN / 2);
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
          const float4 v = row[c];
          // once a chunk's first tiles have filled the list, most groups of
          // four stop here
          if (fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) > ls[SMALL_K - 1]) {
            insert_small<true>(ls, li, v.x, id0 + 4 * c);
            insert_small<true>(ls, li, v.y, id0 + 4 * c + 1);
            insert_small<true>(ls, li, v.z, id0 + 4 * c + 2);
            insert_small<true>(ls, li, v.w, id0 + 4 * c + 3);
          }
        }
#pragma unroll
        for (int e = 0; e < SMALL_K; ++e) {
          ps[e] = ls[e];
          pi[e] = li[e];
        }
      }
    } else {
      // rows past B are the block's last ones, so the break is warp-uniform
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp * RPW + rr;
        if (q0 + r >= B) break;
        float ls = lst_s[r * MAX_K + lane];
        int li = lst_i[r * MAX_K + lane];
#pragma unroll 1
        for (int m = 0; m < BN / 32; ++m) {
          const int col = m * 32 + lane;
          const float v = sc[r * SC_PITCH + col];
          warp_offer(v, n0 + col, v > -INFINITY, k, lane, ls, li);
        }
        lst_s[r * MAX_K + lane] = ls;
        lst_i[r * MAX_K + lane] = li;
      }
    }
    // the next tile's scores are stored after at least one more barrier
  }

  __syncthreads();
  const size_t chunks = gridDim.x;
  if (k <= SMALL_K) {
    // a row's two half lists merged by its first thread
    const int r = tid;
    if (r < BQ && q0 + r < B) {
      float ls[SMALL_K];
      int li[SMALL_K];
#pragma unroll
      for (int e = 0; e < SMALL_K; ++e) {
        ls[e] = lst_s[r * MAX_K + e];
        li[e] = lst_i[r * MAX_K + e];
      }
#pragma unroll
      for (int e = 0; e < SMALL_K; ++e)
        insert_small<false>(ls, li, lst_s[r * MAX_K + SMALL_K + e],
                            lst_i[r * MAX_K + SMALL_K + e]);
      const size_t o = ((size_t)(q0 + r) * chunks + chunk) * k;
#pragma unroll
      for (int e = 0; e < SMALL_K; ++e) {
        if (e < k) {
          part_s[o + e] = ls[e];
          part_i[o + e] = li[e];
        }
      }
    }
  } else {
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      if (q0 + r < B && lane < k) {
        const size_t o = ((size_t)(q0 + r) * chunks + chunk) * k + lane;
        part_s[o] = lst_s[r * MAX_K + lane];
        part_i[o] = lst_i[r * MAX_K + lane];
      }
    }
  }
}

// Pass 2 of the tensor-core form for k <= SMALL_K: one warp a row. Lane l
// loads chunks l, l + 32, ... (their ids rise from chunk to chunk, and
// within a chunk equal scores come in id order) into its own list, then the
// 32 lists merge by a butterfly of shuffles, every lane ending with the
// row's list.
__global__ void __launch_bounds__(NT)
cosine_topk_merge_small(const float* __restrict__ part_s, const int* __restrict__ part_i, int B,
                        int chunks, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int SMALL_K = tc::SMALL_K;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  float ls[SMALL_K];
  int li[SMALL_K];
#pragma unroll
  for (int e = 0; e < SMALL_K; ++e) {
    ls[e] = -INFINITY;
    li[e] = -1;
  }
  const float* ps = part_s + (size_t)row * chunks * k;
  const int* pi = part_i + (size_t)row * chunks * k;
#pragma unroll 4
  for (int c = lane; c < chunks; c += 32) {
#pragma unroll
    for (int e = 0; e < SMALL_K; ++e)
      if (e < k) insert_small<true>(ls, li, ps[c * k + e], pi[c * k + e]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float os[SMALL_K];
    int oi[SMALL_K];
#pragma unroll
    for (int e = 0; e < SMALL_K; ++e) {
      os[e] = __shfl_xor_sync(FULL, ls[e], off);
      oi[e] = __shfl_xor_sync(FULL, li[e], off);
    }
#pragma unroll
    for (int e = 0; e < SMALL_K; ++e) insert_small<false>(ls, li, os[e], oi[e]);
  }
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < SMALL_K; ++e) {
      if (e < k) {
        out_s[(size_t)row * k + e] = ls[e];
        out_i[(size_t)row * k + e] = li[e];
      }
    }
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
  const void* tile_bits;
  int B, N, d, k, keys_per_chunk, chunks, block_q;
  void* part_s;
  void* part_i;
  void* out_s;
  void* out_i;
  cudaStream_t stream;
};

// pass 2 after a pass 1 of more than one chunk (its cudaGetLastError)
cudaError_t launch_merge(const Args& a, cudaError_t pass1) {
  if (pass1 != cudaSuccess || a.chunks == 1) return pass1;
  cosine_topk_merge<<<(a.B + NT / 32 - 1) / (NT / 32), NT, 0, a.stream>>>(
      static_cast<const float*>(a.part_s), static_cast<const int*>(a.part_i), a.B,
      a.chunks, a.k, static_cast<float*>(a.out_s), static_cast<int*>(a.out_i));
  return cudaGetLastError();
}

// one chunk: pass 1's lists are the result, (B, 1, k) is (B, k)
float* pass1_scores(const Args& a) { return static_cast<float*>(a.chunks == 1 ? a.out_s : a.part_s); }
int* pass1_ids(const Args& a) { return static_cast<int*>(a.chunks == 1 ? a.out_i : a.part_i); }

template <typename KT, int MS, int SS, int BQ>
cudaError_t launch_tiles(const Args& a) {
  const dim3 grid(a.chunks, (a.B + BQ - 1) / BQ);
  cosine_topk_partial<KT, MS, SS, BQ><<<grid, Tile<BQ>::NT, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KT*>(a.keys),
      static_cast<const float*>(a.scales), static_cast<const uint8_t*>(a.valid),
      static_cast<const int*>(a.starts), static_cast<const int*>(a.sizes),
      static_cast<const int*>(a.order), static_cast<const uint8_t*>(a.mask),
      static_cast<const unsigned*>(a.tile_bits), a.B, a.N, a.d, a.k, a.keys_per_chunk,
      pass1_scores(a), pass1_ids(a));
  return launch_merge(a, cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename KT, int SS>
cudaError_t launch_tc(const Args& a) {
  constexpr int smem = tc::smem_bytes<KT>();
  static bool configured = false;   // one opt-in per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cosine_topk_tc<KT, SS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // 16-byte copies where every staged row starts on 16 bytes
  const bool vec = a.d * 4 % 16 == 0 && a.d * sizeof(KT) % 16 == 0 && aligned16(a.q) &&
                   aligned16(a.keys);
  const dim3 grid(a.chunks, (a.B + tc::BQ - 1) / tc::BQ);
  cosine_topk_tc<KT, SS><<<grid, tc::NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KT*>(a.keys),
      static_cast<const float*>(a.scales), static_cast<const uint8_t*>(a.valid), a.B, a.N, a.d,
      a.k, a.keys_per_chunk, vec, pass1_scores(a), pass1_ids(a));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.chunks == 1 || a.k > tc::SMALL_K) return launch_merge(a, err);
  cosine_topk_merge_small<<<(a.B + NT / 32 - 1) / (NT / 32), NT, 0, a.stream>>>(
      static_cast<const float*>(a.part_s), static_cast<const int*>(a.part_i), a.B, a.chunks,
      a.k, static_cast<float*>(a.out_s), static_cast<int*>(a.out_i));
  return cudaGetLastError();
}

template <typename KT, int MS, int SS>
cudaError_t launch(const Args& a) {
  if constexpr (MS == SHARED_MASK) {
    return a.block_q == tc::BQ ? launch_tc<KT, SS>(a)
                               : launch_tiles<KT, MS, SS, BQ_NARROW>(a);
  } else {
    if (a.block_q == BQ_32) return launch_tiles<KT, MS, SS, BQ_32>(a);
    if (a.block_q == BQ_16) return launch_tiles<KT, MS, SS, BQ_16>(a);
    return a.block_q == BQ_NARROW ? launch_tiles<KT, MS, SS, BQ_NARROW>(a)
                                  : launch_tiles<KT, MS, SS, BQ_WIDE>(a);
  }
}

// the interval and dense forms chunk each tile's union themselves, so their
// keys_per_chunk need not cover N; the dense form's chunks must keep a
// block's tiles within DENSE_LIST. The shared form takes 128-row tiles on
// tensor cores or 4-row ones, the others 64-, 32-, 16- or 4-row ones.
template <int MS>
bool bad_split(const Args& a) {
  const bool grouped = MS != SHARED_MASK;
  const bool tile_ok =
      a.block_q == BQ_NARROW || (MS == SHARED_MASK ? a.block_q == tc::BQ : a.block_q == BQ_WIDE) ||
      (grouped && (a.block_q == BQ_32 || a.block_q == BQ_16));
  const long long tiles = ((long long)a.N + BN - 1) / BN;
  return a.B < 1 || a.N < 1 || a.d < 1 || a.k < 1 || a.k > MAX_K || a.chunks < 1 ||
         (!grouped && (a.keys_per_chunk < 1 || (long long)a.chunks * a.keys_per_chunk < a.N ||
                       (long long)(a.chunks - 1) * a.keys_per_chunk >= a.N)) ||
         (grouped && a.order == nullptr) ||
         (MS == DENSE_MASK &&
          (a.tile_bits == nullptr || (long long)a.chunks * DENSE_LIST < tiles)) ||
         !tile_ok || (a.chunks > 1 && (a.part_s == nullptr || a.part_i == nullptr));
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
// keys_per_chunk must cover N (not read by the interval and dense forms);
// block_q is the query-tile height of pass 1: for the shared-mask forms 128
// (tensor cores) or 4, for the others 64, 32, 16 or 4.

// shared (N,) mask
int cosine_topk_launch(const void* q, const void* keys, int key_dtype, const void* valid,
                       int B, int N, int d, int k, int keys_per_chunk, int chunks,
                       int block_q, void* part_s, void* part_i, void* out_s, void* out_i,
                       void* stream) {
  const Args a{q, keys, nullptr, valid, nullptr, nullptr, nullptr, nullptr, nullptr, B, N, d,
               k, keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
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
  const Args a{q, keys, nullptr, valid, starts, sizes, order, nullptr, nullptr, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch<INTERVAL_MASK>(key_dtype, a);
}

// Pass 0 of the dense form: mask (B, N) bool, row-major -> tile_bits (B, W)
// int32 words, W = ceil(ceil(N / 128) / 32), sort_key (B,) int64, tiles (B,)
// int32 (cosine_topk_tile_summary), then order (B,) int32, the rows in the
// stable order of their keys (cosine_topk_rank_rows).
int cosine_topk_tile_summary_launch(const void* mask, int B, int N, void* tile_bits,
                                    void* sort_key, void* tiles, void* order, void* stream) {
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int W = ((N + BN - 1) / BN + 31) / 32;
  const bool vec = N % 16 == 0 && aligned16(mask);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cosine_topk_tile_summary<<<B, SUMMARY_NT, 0, st>>>(
      static_cast<const uint8_t*>(mask), N, W, vec, static_cast<unsigned*>(tile_bits),
      static_cast<long long*>(sort_key), static_cast<int*>(tiles));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cosine_topk_rank_rows<<<(B + RANK_NT - 1) / RANK_NT, RANK_NT, 0, st>>>(
      static_cast<const long long*>(sort_key), B, static_cast<int*>(order));
  return static_cast<int>(cudaGetLastError());
}

// dense (B, N) bool mask, row-major; order is a (B,) int32 permutation of
// the rows (the stable sort of pass 0's sort_key) and tile_bits pass 0's
// bitmaps: a block scores only the 128-key tiles that some row of its tile
// sees; chunks >= ceil(ceil(N / 128) / 1024).
int cosine_topk_masked_launch(const void* q, const void* keys, int key_dtype,
                              const void* mask, const void* order, const void* tile_bits,
                              int B, int N, int d, int k, int keys_per_chunk, int chunks,
                              int block_q, void* part_s, void* part_i, void* out_s,
                              void* out_i, void* stream) {
  const Args a{q, keys, nullptr, nullptr, nullptr, nullptr, order, mask, tile_bits, B, N, d,
               k, keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch<DENSE_MASK>(key_dtype, a);
}

// The per-row-scale forms: keys (N, d) int8, scales (N,) f32; otherwise as
// the three above.
int quant_cosine_topk_launch(const void* q, const void* keys, const void* scales,
                             const void* valid, int B, int N, int d, int k,
                             int keys_per_chunk, int chunks, int block_q, void* part_s,
                             void* part_i, void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, scales, valid, nullptr, nullptr, nullptr, nullptr, nullptr, B, N, d,
               k, keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch_quant<SHARED_MASK>(a);
}

int quant_cosine_topk_interval_launch(const void* q, const void* keys, const void* scales,
                                      const void* valid, const void* starts,
                                      const void* sizes, const void* order, int B, int N,
                                      int d, int k, int keys_per_chunk, int chunks, int block_q,
                                      void* part_s, void* part_i, void* out_s, void* out_i,
                                      void* stream) {
  const Args a{q, keys, scales, valid, starts, sizes, order, nullptr, nullptr, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch_quant<INTERVAL_MASK>(a);
}

int quant_cosine_topk_masked_launch(const void* q, const void* keys, const void* scales,
                                    const void* mask, const void* order,
                                    const void* tile_bits, int B, int N, int d, int k,
                                    int keys_per_chunk, int chunks, int block_q, void* part_s,
                                    void* part_i, void* out_s, void* out_i, void* stream) {
  const Args a{q, keys, scales, nullptr, nullptr, nullptr, order, mask, tile_bits, B, N, d, k,
               keys_per_chunk, chunks, block_q, part_s, part_i, out_s, out_i,
               static_cast<cudaStream_t>(stream)};
  return dispatch_quant<DENSE_MASK>(a);
}

const char* cosine_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
