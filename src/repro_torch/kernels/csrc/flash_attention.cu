// Causal / sliding-window GQA flash attention for prefill, written by hand
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_pallas), the attention of Model.forward:
//   q (B, Lq, H, D); k, v (B, Lk, HKV, D), f32 or bf16 (all three alike);
//   query row i sits at absolute position i + Lk - Lq (the ends aligned) and
//   sees key j when j <= i + Lk - Lq (causal) and, with a window (> 0),
//   j > i + Lk - Lq - window or, with attention sinks (hymba's meta tokens),
//   j < n_sink. Query head h reads KV head h / G, G = H / HKV,
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
// Two kernels, one per dtype, behind one entry point. Both walk the KV tiles
// of 64 keys of a (query tile of 64 rows, head, batch row) inside one block:
// the sink tiles [0, ceil(n_sink / 64)) first, then from the window's first
// live tile (0 without a window) to the causal edge, each tile once, so dead
// tiles are never loaded, with the running max, sum and accumulator
// in registers where the TPU kernel keeps them in VMEM scratch across its
// sequential grid; scores never reach device memory.
//
// bf16 (flash_attention_bf16_kernel): tensor cores, mma.sync.m16n8k16 in
// FlashAttention-2's register layout. Four warps, 16 query rows each. Q, K
// and V stay bf16 and arrive in shared memory by 16-byte cp.async copies
// (rows padded by 16 bytes so ldmatrix reads are free of bank conflicts).
// S sums bf16 products in f32, the rounding points of the Pallas kernel
// (bf16 operands, f32 preferred_element_type). The online softmax runs in
// f32 registers on S's accumulator fragments, with a row's visible keys
// as one interval and exponentials by ex2.approx (__expf: ~2^-21 relative,
// far inside the 2^-16 of P's split below). P V also runs on the tensor
// cores, with P split into a bf16 high part and the bf16 rounding of the
// rest (two MMAs into one f32 accumulator): P keeps about 16 bits, so P V
// stays within ~2^-16 of the f32 product the Pallas kernel and the plain
// version form, where P rounded to bf16 alone would move outputs at which
// sum p * v cancels by more than one bf16 ulp. A warp skips the 8-key
// score tiles and 16-key P V steps that lie wholly past its rows' causal
// edge. One block per (query tile, head, batch row), three an SM: 168
// registers a thread hold the 64 accumulator and 32 score floats without
// spills (at four an SM, 128 registers spilled and the kernel ran slower).
// The output goes out through shared memory in 16-byte rows.
// mma.sync and not wgmma: at this shape the kernel is bound by bytes, 1.4
// GFLOP (2.6 with P split) take a few us even at mma.sync's share of the
// peak, and a 64-row wgmma tile per warpgroup would tie four warps to each
// other's causal edges; TMA is not used either, since a tile is 64 rows of
// 128 to 256 bytes each, spread over (B, L, heads) strides, which 128
// threads issue in 8 copies each.
//
// f32 (flash_attention_kernel, as first written but for the sinks): CUDA
// cores. One block of 256 threads; the Q tile, one K or V tile and the
// 64 x 64 weights live in shared memory as f32 (83 KB at D = 128: two
// blocks an SM). The 16 x 16 threads each own a 4 x 4 patch of the scores
// (rows ty*4.., keys tx + 16 j) and a 4 x D/16 patch of the accumulator
// (rows ty*4.., columns tx + 16 j) with its rows' running max and sum in
// registers; a row's statistics are reduced over the 16 lanes that share it
// by shuffles. Plain f32 FMAs: TF32 tensor cores would round the operands
// to 10 bits, past what the f32 models' card-vs-CPU checks allow.
// Shared-memory rows are padded to D + 1 floats so the 16 key rows of a
// score step fall in 16 banks. D is 64 or 128.
//
// Both kernels write each row's log-sum-exp of its visible scaled scores,
// m + log(l) (-inf for a row that sees nothing), to a (B, H, Lq) f32
// tensor when given one (the training form); the serve path passes none
// and runs as before.
//
// Backward (row 9b; the TPU package has no backward kernel: it
// differentiates its jnp blockwise attention with XLA). Bound on an H100 at
// qwen2-vl-2b's training step (B = 8, L = 128, H = 12, HKV = 2, D = 128,
// bf16, causal): q, out, dout, dq 3.1 MB each, k, v, dk, dv 0.5 MB each and
// lse 49 KB, 14.7 MB, take 0.0044 ms at 3.35 TB/s; the five products
// (S, dP, dV, dK, dQ: 10 D FLOP a visible (query, key, head), 1.0 GFLOP)
// take 0.0010 ms at the bf16 rate. So it is bound by bytes.
//
// The work. dK/dV: one block a (key tile of 64 x slice, KV head, batch
// row). A key tile's work is the (query head, query tile) items of its
// group's G heads and the query tiles that see one of its keys; K and V
// stay in shared memory while the block walks its slice of the items,
// recomputing per item P^T = exp(S^T * scale - lse) and dP^T = V dO^T,
// forming dS^T = P^T * (dP^T - Di), and adding P^T dO to dV and dS^T Q to
// dK in registers. dQ: one block a (query tile, head, batch row), walking
// the forward's live KV tiles (sinks, then the window's): dQ += dS K.
// The slices: one block a (key tile, KV head, batch row) gives 2 x 2 x 8 =
// 32 blocks at qwen2-vl's shape, a quarter of the 132 SMs, each walking 12
// items in turn. The wrapper's plan (flash_attention.py::bwd_plan) takes the
// fewest slices that give at least one block an SM, capped at G times the
// query tiles: 5 there (160 blocks), 1 wherever the grid is already that
// large (musicgen-large: 384 blocks). With more than one slice, each writes
// f32 partial dK and dV: 2 x 5 x 1.05 MB = 10.5 MB there, written once and
// read once, in the L2's 50 MB.
//
// Launches on one stream: flash_bwd_dot_kernel (Di = rowsum(dO * O));
// the dK/dV blocks and the dQ blocks (bf16: both kinds in one launch,
// flash_bwd_bf16_kernel, so that the dQ blocks fill the SMs beside the
// longer dK/dV blocks; f32: flash_bwd_dkdv_kernel, then after the sum
// flash_bwd_dq_kernel); flash_bwd_reduce_kernel, with more than one slice,
// sums the partials, scales dK and rounds.
// No atomics: every element of dQ, of a partial and of dK and dV is written
// by one thread, and the partials are summed in the fixed order of the
// slices, so a gradient is the same bits from run to run. A row that sees
// no key has P = 0 (visibility is tested before the exponential) and adds
// nothing.
//
// bf16 (bwd_dkdv_bf16, bwd_dq_bf16): every product on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 sums), with the forward's pieces: Q, K,
// V and dO stay bf16 in rows padded to D + 8, arriving by 16-byte cp.async,
// the next item's (dK/dV) or KV tile's (dQ) into a second buffer while one
// is computed. Four warps of 16 rows (keys for dK/dV, queries for dQ); P
// and dS are computed in f32 on the accumulator fragments and become the A
// fragments of the next products straight from registers, each split into
// a bf16 high part and the bf16 rounding of the rest (two MMAs into one f32
// sum, as the forward's P V), so they keep about 16 bits. The dK/dV warps
// walk a query tile 16 rows at a time: S^T and dP^T then take 16 registers
// beside the 128 of the dK and dV accumulators (D = 128: 252 registers, no
// spills), and a warp skips the 16-row steps past its keys' causal edge, as
// a dQ warp skips 8-key tiles. 104-106 KB of shared memory a block at D =
// 128, two blocks an SM. mma.sync and not wgmma, as in the forward: the
// kernel is bound by bytes, and 16-row warps skip their own dead steps.
//
// f32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): plain f32 FMAs on CUDA
// cores, operands staged to f32 shared memory as in the f32 forward (TF32
// would round the operands to 10 bits); 166 KB (dK/dV) and 149 KB (dQ) at
// D = 128, one block an SM. It takes the same slices.
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
  float* lse;   // (B, H, Lq) row log-sum-exp for the backward, or null
  int B, Lq, Lk, H, HKV, causal, window, n_sink;
  float scale;
};

// The live KV tiles of the query tile at row q0: the sink tiles [0,
// sink_end), then [t_begin, t_end), from the window's first (query row q0)
// to the causal edge (the tile's last real row). Negative bounds divide
// toward 0 and clamp, so a tile that sees nothing loops over nothing; the
// sink tiles stop where the window's begin, so no tile is walked twice.
struct Tiles {
  int sink_end, t_begin, t_end;
  __device__ int first() const { return sink_end > 0 ? 0 : t_begin; }
  __device__ int next(int t) const { return t + 1 == sink_end ? t_begin : t + 1; }
};

template <typename A>
__device__ __forceinline__ Tiles live_tiles(const A& a, int q0) {
  const int q_lo = a.Lk - a.Lq + q0;
  const int q_hi = a.Lk - a.Lq + min(q0 + BQ, a.Lq) - 1;
  const int n_tiles = (a.Lk + BK - 1) / BK;
  Tiles r;
  r.t_end = a.causal ? min(n_tiles, (q_hi + BK) / BK) : n_tiles;
  r.t_begin = a.window > 0 ? max(0, (q_lo - a.window + 1) / BK) : 0;
  r.sink_end = min(min((a.n_sink + BK - 1) / BK, r.t_begin), r.t_end);
  return r;
}

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

  const int q_lo = offset + q0;
  const Tiles tiles = live_tiles(a, q0);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int t = tiles.first(); t < tiles.t_end; t = tiles.next(t)) {
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
        if (a.window > 0) vis = vis && (kp > qp - a.window || kp < a.n_sink);
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
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<size_t>(b) * a.H + h) * a.Lq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------
constexpr int TC_NT = 128;         // 4 warps x 16 query rows
constexpr int TC_NS = BK / 8;      // 8-key score tiles per KV tile
constexpr int TC_MIN_BLOCKS = 3;   // an SM's blocks: 168 registers a thread
static_assert(BQ == BK, "Q, K and V tiles share one shape");

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * BQ * (D + 8);
}

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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row major) * b (16 x 8, column major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) = hi + lo: hi their bf16 rounding, lo the bf16 rounding of the
// rest (exact in f32), the lower column in the lower half of each
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows [r0, r0 + 64) of a (B, L, heads, D) bf16 tensor at (b, head) into a
// (64, D + 8) tile by cp.async; rows at or past L are zero-filled
template <int D>
__device__ __forceinline__ void tc_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             int b, int head, int heads, int r0, int L) {
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  static_assert(BQ * CPR % TC_NT == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < BQ * CPR / TC_NT; ++i) {
    const int c = threadIdx.x + i * TC_NT;
    const int r = c / CPR, col = (c % CPR) * 8, row = r0 + r;
    const bool ok = row < L;
    const __nv_bfloat16* from =
        ok ? src + ((static_cast<size_t>(b) * L + row) * heads + head) * D + col : src;
    cp_async16(dst + r * (D + 8) + col, from, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT, TC_MIN_BLOCKS) flash_attention_bf16_kernel(Args a) {
  constexpr int RS = D + 8;     // shared-memory row stride, elements
  constexpr int NDT = D / 8;    // 8-column output tiles of a warp's rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // (BQ, RS)
  __nv_bfloat16* ks = qs + BQ * RS;                                 // (BK, RS)
  __nv_bfloat16* vs = ks + BK * RS;                                 // (BK, RS)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;   // fragment row group, thread in group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.HKV);
  const int offset = a.Lk - a.Lq;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  // live KV tiles, as in the f32 kernel
  const int q_lo = offset + q0;
  const Tiles tiles = live_tiles(a, q0);
  const int t_first = tiles.first();

  // cp.async groups, in order: {Q, K(t_first)}, {V(t_first)}, then one
  // {K(next), V(next)} after each tile but the last
  tc_load_tile<D>(qs, q, b, h, a.H, q0, a.Lq);
  if (t_first < tiles.t_end) tc_load_tile<D>(ks, k, b, kvh, a.HKV, t_first * BK, a.Lk);
  cp_async_commit();
  if (t_first < tiles.t_end) tc_load_tile<D>(vs, v, b, kvh, a.HKV, t_first * BK, a.Lk);
  cp_async_commit();

  // this thread's two rows in the fragments: warp * 16 + g and + 8
  const int qp0 = q_lo + warp * 16 + g, qp1 = qp0 + 8;
  const int warp_qp_hi = q_lo + warp * 16 + 15;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = t_first; t < tiles.t_end; t = tiles.next(t)) {
    const int k0 = t * BK;
    const bool first = t == t_first;
    if (first) {
      cp_async_wait<1>();   // Q and K(t) have landed, V(t) may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // 8-key score tiles with a key this warp's rows may see (a uniform
    // bound per warp: the sequence end, the causal edge of its last row)
    int n_live = min(TC_NS, (a.Lk - k0 + 7) / 8);
    if (a.causal) n_live = warp_qp_hi < k0 ? 0 : min(n_live, (warp_qp_hi - k0) / 8 + 1);

    float s[TC_NS][4];
#pragma unroll
    for (int j = 0; j < TC_NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (n_live <= 0) break;
      unsigned qa[4];
      ldmatrix_x4(qa, qs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < TC_NS / 2; ++jp) {
        if (2 * jp >= n_live) continue;
        unsigned kb[4];
        ldmatrix_x4(kb, ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
      }
    }

    // online softmax on the fragments: entries 0, 1 are row qp0, 2, 3 row
    // qp1, at keys k0 + 8 j + 2 tig + (e & 1); a row's 64 scores lie in the
    // 4 threads of a quad
    float c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r ? qp1 : qp0;
      // key k0 + 2 tig + kr is visible when kr <= hi and kr >= lo (the
      // window) or kr <= sk (a sink)
      const int hi = min(a.Lk - 1, a.causal ? qp : a.Lk) - k0 - 2 * tig;
      const int lo = a.window > 0 ? qp - a.window + 1 - k0 - 2 * tig : -BK;
      const int sk = a.n_sink - 1 - k0 - 2 * tig;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC_NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kr = 8 * j + e;
          const bool vis = j < n_live && kr <= hi && (kr >= lo || kr <= sk);
          float& x = s[j][2 * r + e];
          x = vis ? x * a.scale : -INFINITY;
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[r], tmax);
      // m_new is -inf only while the row has seen nothing: weights 0, no
      // rescale (the accumulator is still 0)
      c[r] = m_new == -INFINITY ? 1.f : __expf(m[r] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TC_NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = x == -INFINITY ? 0.f : __expf(x - m_new);
          rsum += x;
        }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[r] = l[r] * c[r] + rsum;
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      o[j][0] *= c[0];
      o[j][1] *= c[0];
      o[j][2] *= c[1];
      o[j][3] *= c[1];
    }

    if (first) {
      cp_async_wait<0>();   // V(t) has landed
      __syncthreads();
    }
    // O += P V over 16-key steps; the accumulator fragments of S are the A
    // fragments of P (tiles 2 kk and 2 kk + 1 side by side)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (2 * kk >= n_live) continue;
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    const int tn = tiles.next(t);
    if (tn < tiles.t_end) {
      __syncthreads();   // every warp is done with K(t) and V(t)
      tc_load_tile<D>(ks, k, b, kvh, a.HKV, tn * BK, a.Lk);
      tc_load_tile<D>(vs, v, b, kvh, a.HKV, tn * BK, a.Lk);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  if (a.lse != nullptr && tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < a.Lq)
        a.lse[(static_cast<size_t>(b) * a.H + h) * a.Lq + row] =
            l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    }
  }

  // normalized rows into the Q tile (every warp is past its last read of
  // it), then out in 16-byte rows; a reciprocal and multiplies, since 64
  // divisions a thread made the kernel 25% slower on an H100
  __syncthreads();
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < NDT; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(qs + (warp * 16 + g) * RS + col) =
        __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(qs + (warp * 16 + g + 8) * RS + col) =
        __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncthreads();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < BQ * CPR; c += TC_NT) {
    const int r = c / CPR, col = (c % CPR) * 8, row = q0 + r;
    if (row >= a.Lq) continue;
    *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * a.Lq + row) * a.H + h) * D +
                              col) = *reinterpret_cast<const uint4*>(qs + r * RS + col);
  }
}

// the dynamic shared-memory opt-in of a kernel, once per instantiation
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  const cudaError_t err = opt_in(flash_attention_kernel<T, D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool configured = false;
  const cudaError_t err = opt_in(flash_attention_bf16_kernel<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  flash_attention_bf16_kernel<D><<<grid, TC_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// dtype 0: f32 on CUDA cores; 1: bf16 on tensor cores
cudaError_t launch_d(const Args& a, int dtype, int D, cudaStream_t stream) {
  if (dtype == 0 && D == 64) return launch<float, 64>(a, stream);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, stream);
  if (dtype == 1 && D == 64) return launch_bf16<64>(a, stream);
  if (dtype == 1 && D == 128) return launch_bf16<128>(a, stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------
// backward (row 9b): dQ, dK, dV; f32 on CUDA cores, bf16 on tensor cores
// ---------------------------------------------------------------------
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;   // (B, H, Lq) from the forward
  float* di;          // (B, H, Lq) scratch: rowsum(dO * O)
  float* part;        // (2, splits, B, Lk, HKV, D) f32 partial dK, dV; null when splits == 1
  void* dq;
  void* dk;
  void* dv;
  int B, Lq, Lk, H, HKV, causal, window, n_sink, splits;
  float scale;
};

// key position kp is visible to query position qp (the forward's rule)
__device__ __forceinline__ bool sees(const BwdArgs& a, int qp, int kp) {
  return kp < a.Lk && (!a.causal || kp <= qp) &&
         (a.window <= 0 || kp > qp - a.window || kp < a.n_sink);
}

// Di[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: D / kVec<T> threads
// a row (16 for bf16 at D = 128), 16 bytes of each a thread
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dot_kernel(BwdArgs a) {
  constexpr int V = attn::kVec<T>, TPR = D / V;
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row's threads in one warp");
  const int sub = threadIdx.x % TPR;
  const long long r = static_cast<long long>(blockIdx.x) * (NT / TPR) + threadIdx.x / TPR;
  const bool ok = r < static_cast<long long>(a.B) * a.Lq * a.H;
  float acc = 0.f;
  if (ok) {
    const uint4 ov = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.out) + r * D + sub * V);
    const uint4 gv = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.dout) + r * D + sub * V);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(attn::to_f32(ge[e]), attn::to_f32(oe[e]), acc);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (ok && sub == 0) {
    const int h = static_cast<int>(r % a.H);
    const long long bi = r / a.H;   // b * Lq + i
    const int i = static_cast<int>(bi % a.Lq), b = static_cast<int>(bi / a.Lq);
    a.di[(static_cast<size_t>(b) * a.H + h) * a.Lq + i] = acc;
  }
}

// The work of the key tile at k0 is its (query head, query tile) items: the
// group's G heads times the query tiles [qt_begin, qt_begin + nqt) with a
// row that may see a key of the tile (from the first row at or past the
// tile's first key, causal, to the last row whose window reaches the tile's
// last key, unless the tile holds sinks). Item i is head kvh * G + i / nqt,
// query tile qt_begin + i % nqt. Slice s of the launch's `splits` takes the
// contiguous items [lo, hi).
struct Items {
  int qt_begin, nqt, lo, hi;
};

__device__ __forceinline__ Items slice_items(const BwdArgs& a, int k0, int s) {
  const int nq = (a.Lq + BQ - 1) / BQ, offset = a.Lk - a.Lq;
  Items it;
  it.qt_begin = a.causal ? max(0, k0 - offset) / BQ : 0;
  int qt_end = nq;
  if (a.window > 0 && k0 >= a.n_sink) {
    const int hi_row = k0 + BK - 1 + a.window - 1 - offset;
    qt_end = hi_row < 0 ? 0 : min(nq, hi_row / BQ + 1);
  }
  it.nqt = max(0, qt_end - it.qt_begin);
  const long long n = static_cast<long long>(a.H / a.HKV) * it.nqt;
  it.lo = static_cast<int>(n * s / a.splits);
  it.hi = static_cast<int>(n * (s + 1) / a.splits);
  return it;
}

// offset of (slice s, b, key row, kvh) in one half of the partials
__device__ __forceinline__ size_t part_at(const BwdArgs& a, int s, int b, int row, int kvh,
                                          int D) {
  return ((((static_cast<size_t>(s) * a.B + b) * a.Lk + row) * a.HKV) + kvh) * D;
}

template <int D>
constexpr size_t bwd_dkdv_smem_bytes() {
  return sizeof(float) * (4 * BQ * (D + 1) + 2 * BK * PS + 2 * BQ);
}

// f32: dK and dV of one key tile of one KV head, one block a (key tile x
// slice, KV head, batch row), over its slice's items (all of them when
// splits == 1), so that GQA's sum over the group stays in the block's
// registers. The 16 x 16 threads own keys ty * 4 + i and, for S^T and
// dP^T, query rows tx + 16 j; for dK and dV columns tx + 16 j, as the f32
// forward.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int QS = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // (BK, QS)
  float* vs = ks + BK * QS;       // (BK, QS)
  float* qs = vs + BK * QS;       // (BQ, QS)
  float* dos = qs + BQ * QS;      // (BQ, QS)
  float* pts = dos + BQ * QS;     // (BK, PS) P^T
  float* dss = pts + BK * PS;     // (BK, PS) dS^T
  float* lse_s = dss + BK * PS;   // (BQ,)
  float* di_s = lse_s + BQ;       // (BQ,)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int s = blockIdx.x % a.splits;
  const int k0 = blockIdx.x / a.splits * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.HKV, offset = a.Lk - a.Lq;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const Items it = slice_items(a, k0, s);

  load_tile<T, D>(ks, static_cast<const T*>(a.k), b, kvh, a.HKV, k0, a.Lk);
  load_tile<T, D>(vs, static_cast<const T*>(a.v), b, kvh, a.HKV, k0, a.Lk);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int item = it.lo; item < it.hi; ++item) {
    const int h = kvh * G + item / it.nqt;
    const int q0 = (it.qt_begin + item % it.nqt) * BQ;
    __syncthreads();   // the previous tile's reads are done
    load_tile<T, D>(qs, q, b, h, a.H, q0, a.Lq);
    load_tile<T, D>(dos, dout, b, h, a.H, q0, a.Lq);
    if (tid < BQ) {
      const int row = q0 + tid;
      const size_t at = (static_cast<size_t>(b) * a.H + h) * a.Lq + row;
      lse_s[tid] = row < a.Lq ? a.lse[at] : 0.f;
      di_s[tid] = row < a.Lq ? a.di[at] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qb[4], ob[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = ks[(ty * 4 + i) * QS + d];
        va[i] = vs[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = qs[(tx + 16 * j) * QS + d];
        ob[j] = dos[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], ob[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j, row = q0 + qr;
        const bool vis = row < a.Lq && sees(a, offset + row, kp);
        const float p = vis ? expf(st[i][j] * a.scale - lse_s[qr]) : 0.f;
        pts[(ty * 4 + i) * PS + qr] = p;
        dss[(ty * 4 + i) * PS + qr] = p * (dpt[i][j] - di_s[qr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pa[4], sa[4], ob[NC], qb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pts[(ty * 4 + i) * PS + qq];
        sa[i] = dss[(ty * 4 + i) * PS + qq];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        ob[j] = dos[qq * QS + tx + 16 * j];
        qb[j] = qs[qq * QS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
        }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
  const size_t dv_part = part_at(a, a.splits, 0, 0, 0, D);   // dV's half of the partials
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= a.Lk) continue;
    if (a.splits == 1) {
      const size_t at = ((static_cast<size_t>(b) * a.Lk + row) * a.HKV + kvh) * D;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        dk_out[at + tx + 16 * j] = from_f32<T>(dk[i][j] * a.scale);
        dv_out[at + tx + 16 * j] = from_f32<T>(dv[i][j]);
      }
    } else {
      float* pk = a.part + part_at(a, s, b, row, kvh, D);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        pk[tx + 16 * j] = dk[i][j];
        pk[dv_part + tx + 16 * j] = dv[i][j];
      }
    }
  }
}

template <int D>
constexpr size_t bwd_dq_smem_bytes() {
  return sizeof(float) * (4 * BQ * (D + 1) + BQ * PS);
}

// f32: dQ of one query tile of one head, one block a (query tile, head,
// batch row), walking the forward's live KV tiles (sinks, then the
// window's); the threads own query rows ty * 4 + i and keys (for dS) or
// columns (for dQ) tx + 16 j.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int QS = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // (BQ, QS)
  float* dos = qs + BQ * QS;      // (BQ, QS)
  float* ks = dos + BQ * QS;      // (BK, QS)
  float* vs = ks + BK * QS;       // (BK, QS)
  float* dss = vs + BK * QS;      // (BQ, PS) dS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.HKV), offset = a.Lk - a.Lq;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_tile<T, D>(qs, static_cast<const T*>(a.q), b, h, a.H, q0, a.Lq);
  load_tile<T, D>(dos, static_cast<const T*>(a.dout), b, h, a.H, q0, a.Lq);
  float lse_r[4], di_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const size_t at = (static_cast<size_t>(b) * a.H + h) * a.Lq + row;
    lse_r[i] = row < a.Lq ? a.lse[at] : 0.f;
    di_r[i] = row < a.Lq ? a.di[at] : 0.f;
  }
  const Tiles tiles = live_tiles(a, q0);

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dq[i][j] = 0.f;

  for (int t = tiles.first(); t < tiles.t_end; t = tiles.next(t)) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's reads are done
    load_tile<T, D>(ks, k, b, kvh, a.HKV, k0, a.Lk);
    load_tile<T, D>(vs, v, b, kvh, a.HKV, k0, a.Lk);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty * 4 + i) * QS + d];
        oa[i] = dos[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * QS + d];
        vb[j] = vs[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = tx + 16 * j;
        const bool vis = row < a.Lq && sees(a, offset + row, k0 + kr);
        const float p = vis ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        dss[(ty * 4 + i) * PS + kr] = p * (dp[i][j] - di_r[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sa[4], kb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dss[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) kb[j] = ks[kk * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
    }
  }

  T* dq_out = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Lq) continue;
    const size_t at = ((static_cast<size_t>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) dq_out[at + tx + 16 * j] = from_f32<T>(dq[i][j] * a.scale);
  }
}

// ---- bf16 on the tensor cores ----------------------------------------
constexpr int BWD_TC_MIN_BLOCKS = 2;   // two blocks an SM: 106 KB of shared memory each at D = 128
static_assert(TC_NT == 2 * BQ, "one lse or Di copy a thread");

// 4 bytes from global to shared memory, or 4 zero bytes when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

// a dK/dV block's K, V, two buffers of (Q, dO) tiles and two of (lse, Di)
// rows; a dQ block takes the six tiles (Q, dO, two buffers of K and V)
template <int D>
constexpr size_t bwd_tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * 6 * BQ * (D + 8) + sizeof(float) * 4 * BQ;
}

// Whether a warp's 16 keys from position kw0 may see a query of the 16
// rows from row0 (a uniform test: the per-element one still applies).
__device__ __forceinline__ bool any_visible(const BwdArgs& a, int kw0, int row0) {
  if (row0 >= a.Lq || kw0 >= a.Lk) return false;
  const int offset = a.Lk - a.Lq;
  const int qp_lo = offset + row0, qp_hi = offset + min(row0 + 15, a.Lq - 1);
  const int kw_hi = min(kw0 + 15, a.Lk - 1);
  if (a.causal && qp_hi < kw0) return false;
  if (a.window > 0 && kw_hi <= qp_lo - a.window && kw0 >= a.n_sink) return false;
  return true;
}

// The 16-row bf16 tile of a warp at src (row stride D + 8) out to a (B, L,
// heads, D) tensor at rows r0.. (b, head) in 16-byte stores; rows at or
// past L are not written.
template <int D>
__device__ __forceinline__ void tc_store_rows(__nv_bfloat16* out, const __nv_bfloat16* src,
                                              int b, int head, int heads, int r0, int L,
                                              int lane) {
  constexpr int CPR = D / 8;
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, col = (c % CPR) * 8, row = r0 + r;
    if (row >= L) continue;
    *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * L + row) * heads + head) * D +
                              col) = *reinterpret_cast<const uint4*>(src + r * (D + 8) + col);
  }
}

// bf16: dK and dV of one key tile of one KV head for the block bx = key
// tile x slice, as the f32 kernel. Four warps, each owning 16 key rows and
// their dK, dV accumulators (D / 8 fragments each). Per item and per 16
// rows of its query tile: S^T = K Q^T and dP^T = V dO^T on the MMA, P^T =
// exp(S^T * scale - lse) and dS^T = P^T * (dP^T - Di) on the accumulator
// fragments (visibility tested first: an invisible pair is 0), then dV +=
// P^T dO and dK += dS^T Q with P^T and dS^T as A fragments from registers,
// each split into a bf16 high part and the bf16 rounding of the rest. The
// next item's Q and dO arrive by cp.async into the other buffer while this
// one is computed.
template <int D>
__device__ __forceinline__ void bwd_dkdv_bf16(const BwdArgs& a, int bx, int kvh, int b) {
  constexpr int RS = D + 8;
  constexpr int NDT = D / 8;
  constexpr int TILE = BQ * (D + 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // (BK, RS)
  __nv_bfloat16* vs = ks + TILE;                                    // (BK, RS)
  __nv_bfloat16* qbuf = vs + TILE;   // [2] x (Q (BQ, RS), dO (BQ, RS))
  float* rowbuf = reinterpret_cast<float*>(qbuf + 4 * TILE);   // [2] x (lse (BQ), Di (BQ))

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int s = bx % a.splits, k0 = bx / a.splits * BK;
  const int G = a.H / a.HKV, offset = a.Lk - a.Lq;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);
  const Items it = slice_items(a, k0, s);

  auto load_item = [&](int item, int buf) {
    const int h = kvh * G + item / it.nqt;
    const int q0 = (it.qt_begin + item % it.nqt) * BQ;
    __nv_bfloat16* qs = qbuf + buf * 2 * TILE;
    tc_load_tile<D>(qs, q, b, h, a.H, q0, a.Lq);
    tc_load_tile<D>(qs + TILE, dout, b, h, a.H, q0, a.Lq);
    // lse (threads 0-63) and Di (64-127) of the tile's rows, 4 bytes each
    // (a (B, H, Lq) row need not start on 16 bytes)
    const int r = threadIdx.x & (BQ - 1), row = q0 + r;
    const float* src = threadIdx.x < BQ ? a.lse : a.di;
    const bool ok = row < a.Lq;
    cp_async4(rowbuf + buf * 2 * BQ + threadIdx.x,
              ok ? src + (static_cast<size_t>(b) * a.H + h) * a.Lq + row : src, ok);
  };

  // cp.async groups: {K, V, the first item}, then {item i + 1} issued at
  // the start of item i
  if (it.lo < it.hi) {
    tc_load_tile<D>(ks, static_cast<const __nv_bfloat16*>(a.k), b, kvh, a.HKV, k0, a.Lk);
    tc_load_tile<D>(vs, static_cast<const __nv_bfloat16*>(a.v), b, kvh, a.HKV, k0, a.Lk);
    load_item(it.lo, 0);
  }
  cp_async_commit();

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int kw0 = k0 + warp * 16;   // this warp's first key
  for (int item = it.lo; item < it.hi; ++item) {
    const int buf = (item - it.lo) & 1;
    cp_async_wait<0>();
    __syncthreads();   // item has landed; every warp is done with the other buffer
    if (item + 1 < it.hi) {
      load_item(item + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q0 = (it.qt_begin + item % it.nqt) * BQ;
    const __nv_bfloat16* qs = qbuf + buf * 2 * TILE;
    const __nv_bfloat16* dos = qs + TILE;
    const float* lse_s = rowbuf + buf * 2 * BQ;
    const float* di_s = lse_s + BQ;

    // 16-row steps of the query tile: S^T and dP^T of this warp's 16 keys
    // by 16 query rows take 16 registers beside the 128 of dK and dV
    const int at_a = (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll 1
    for (int r0 = 0; r0 < BQ; r0 += 16) {
      if (!any_visible(a, kw0, q0 + r0)) continue;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      const int at_b = (r0 + (lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ka[4], va[4], qb[4], ob[4];
        ldmatrix_x4(ka, ks + at_a + kk * 16);
        ldmatrix_x4(qb, qs + at_b + kk * 16);
        ldmatrix_x4(va, vs + at_a + kk * 16);
        ldmatrix_x4(ob, dos + at_b + kk * 16);
        mma_bf16(st[0], ka, qb[0], qb[1]);
        mma_bf16(st[1], ka, qb[2], qb[3]);
        mma_bf16(dpt[0], va, ob[0], ob[1]);
        mma_bf16(dpt[1], va, ob[2], ob[3]);
      }
      // P^T into st, dS^T into dpt: entries 0, 1 are key kw0 + g, 2, 3 key
      // kw0 + g + 8, at query rows r0 + 8 j + 2 tig + (e & 1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = r0 + 8 * j + 2 * tig + (e & 1), row = q0 + qr;
          const bool vis = row < a.Lq && sees(a, offset + row, kw0 + g + 8 * (e >> 1));
          const float p = vis ? __expf(st[j][e] * a.scale - lse_s[qr]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - di_s[qr]);
        }
      // dV += P^T dO and dK += dS^T Q over these 16 rows; the accumulator
      // fragments of the two 8-row tiles are the A fragments
      unsigned ph[4], pl[4], sh[4], sl[4];
      split_bf16(st[0][0], st[0][1], ph[0], pl[0]);
      split_bf16(st[0][2], st[0][3], ph[1], pl[1]);
      split_bf16(st[1][0], st[1][1], ph[2], pl[2]);
      split_bf16(st[1][2], st[1][3], ph[3], pl[3]);
      split_bf16(dpt[0][0], dpt[0][1], sh[0], sl[0]);
      split_bf16(dpt[0][2], dpt[0][3], sh[1], sl[1]);
      split_bf16(dpt[1][0], dpt[1][1], sh[2], sl[2]);
      split_bf16(dpt[1][2], dpt[1][3], sh[3], sl[3]);
      const int at_t = (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        unsigned ob[4], qb[4];
        ldmatrix_x4_trans(ob, dos + at_t + dt * 16);
        ldmatrix_x4_trans(qb, qs + at_t + dt * 16);
        mma_bf16(dv[2 * dt], ph, ob[0], ob[1]);
        mma_bf16(dv[2 * dt + 1], ph, ob[2], ob[3]);
        mma_bf16(dk[2 * dt], sh, qb[0], qb[1]);
        mma_bf16(dk[2 * dt + 1], sh, qb[2], qb[3]);
        mma_bf16(dv[2 * dt], pl, ob[0], ob[1]);
        mma_bf16(dv[2 * dt + 1], pl, ob[2], ob[3]);
        mma_bf16(dk[2 * dt], sl, qb[0], qb[1]);
        mma_bf16(dk[2 * dt + 1], sl, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int row0 = kw0 + g;   // this thread's key rows: row0 and row0 + 8
  if (a.splits == 1) {
    // dK * scale and dV as bf16 into this warp's own K and V rows (only
    // this warp read them), then out in 16-byte rows
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int at = (warp * 16 + g) * RS + 8 * j + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(ks + at) =
          __floats2bfloat162_rn(dk[j][0] * a.scale, dk[j][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(ks + at + 8 * RS) =
          __floats2bfloat162_rn(dk[j][2] * a.scale, dk[j][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(vs + at) = __floats2bfloat162_rn(dv[j][0], dv[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(vs + at + 8 * RS) =
          __floats2bfloat162_rn(dv[j][2], dv[j][3]);
    }
    __syncwarp();
    tc_store_rows<D>(static_cast<__nv_bfloat16*>(a.dk), ks + warp * 16 * RS, b, kvh, a.HKV, kw0,
                     a.Lk, lane);
    tc_store_rows<D>(static_cast<__nv_bfloat16*>(a.dv), vs + warp * 16 * RS, b, kvh, a.HKV, kw0,
                     a.Lk, lane);
  } else {
    // f32 partials, unscaled, 8 bytes a store (a quad writes 32 bytes of a row)
    const size_t dv_part = part_at(a, a.splits, 0, 0, 0, D);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.Lk) continue;
      float* pk = a.part + part_at(a, s, b, row, kvh, D) + 2 * tig;
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        *reinterpret_cast<float2*>(pk + 8 * j) = make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
        *reinterpret_cast<float2*>(pk + dv_part + 8 * j) =
            make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

// bf16: dQ of the query tile at row q0 of head h, batch row b, walking the forward's live KV tiles (sinks, then the
// window's), the next tile's K and V arriving by cp.async into the other
// buffer while this one is computed. Four warps of 16 query rows: S = Q K^T
// and dP = dO V^T on the MMA (the 8-key tiles wholly past a warp's causal
// edge skipped, as in the forward), dS = P * (dP - Di) on the fragments,
// dQ += dS K with dS split into two bf16 parts as A fragments.
template <int D>
__device__ __forceinline__ void bwd_dq_bf16(const BwdArgs& a, int q0, int h, int b) {
  constexpr int RS = D + 8;
  constexpr int NDT = D / 8;
  constexpr int TILE = BQ * (D + 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // (BQ, RS)
  __nv_bfloat16* dos = qs + TILE;                                   // (BQ, RS)
  __nv_bfloat16* kvbuf = dos + TILE;   // [2] x (K (BK, RS), V (BK, RS))

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int kvh = h / (a.H / a.HKV), offset = a.Lk - a.Lq;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const Tiles tiles = live_tiles(a, q0);
  const int t_first = tiles.first();

  // cp.async groups: {Q, dO, K and V of the first tile}, then {the next
  // tile's} issued at the start of each tile
  tc_load_tile<D>(qs, static_cast<const __nv_bfloat16*>(a.q), b, h, a.H, q0, a.Lq);
  tc_load_tile<D>(dos, static_cast<const __nv_bfloat16*>(a.dout), b, h, a.H, q0, a.Lq);
  if (t_first < tiles.t_end) {
    tc_load_tile<D>(kvbuf, k, b, kvh, a.HKV, t_first * BK, a.Lk);
    tc_load_tile<D>(kvbuf + TILE, v, b, kvh, a.HKV, t_first * BK, a.Lk);
  }
  cp_async_commit();

  // this thread's two rows in the fragments: warp * 16 + g and + 8
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const size_t at = (static_cast<size_t>(b) * a.H + h) * a.Lq + row;
    lse_r[r] = row < a.Lq ? a.lse[at] : 0.f;
    di_r[r] = row < a.Lq ? a.di[at] : 0.f;
  }
  const int warp_qp_hi = offset + q0 + warp * 16 + 15;
  float dq[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int buf = 0;
  for (int t = t_first; t < tiles.t_end; t = tiles.next(t), buf ^= 1) {
    const int k0 = t * BK;
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every warp is done with the other buffer
    const int tn = tiles.next(t);
    if (tn < tiles.t_end) {
      __nv_bfloat16* next = kvbuf + (buf ^ 1) * 2 * TILE;
      tc_load_tile<D>(next, k, b, kvh, a.HKV, tn * BK, a.Lk);
      tc_load_tile<D>(next + TILE, v, b, kvh, a.HKV, tn * BK, a.Lk);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = kvbuf + buf * 2 * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    // 8-key tiles with a key this warp's rows may see (the forward's bound)
    int n_live = min(TC_NS, (a.Lk - k0 + 7) / 8);
    if (a.causal) n_live = warp_qp_hi < k0 ? 0 : min(n_live, (warp_qp_hi - k0) / 8 + 1);
    if (n_live <= 0) continue;

    float s[TC_NS][4], dp[TC_NS][4];
#pragma unroll
    for (int j = 0; j < TC_NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4], oa[4];
      ldmatrix_x4(qa, qs + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(oa, dos + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < TC_NS / 2; ++jp) {
        if (2 * jp >= n_live) continue;
        const int at = (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                       ((lane >> 3) & 1) * 8;
        unsigned kb[4], vb[4];
        ldmatrix_x4(kb, ks + at);
        ldmatrix_x4(vb, vs + at);
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * jp], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * jp + 1], oa, vb[2], vb[3]);
      }
    }
    // dS into s: entries 0, 1 are row warp * 16 + g, 2, 3 that + 8, at keys
    // k0 + 8 j + 2 tig + (e & 1)
#pragma unroll
    for (int j = 0; j < TC_NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = q0 + warp * 16 + g + 8 * r;
        const bool vis =
            j < n_live && row < a.Lq && sees(a, offset + row, k0 + 8 * j + 2 * tig + (e & 1));
        const float p = vis ? __expf(s[j][e] * a.scale - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - di_r[r]);
      }
    // dQ += dS K over 16-key steps
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (2 * kk >= n_live) continue;
      unsigned sh[4], sl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], sh[0], sl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], sh[1], sl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], sh[2], sl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], sh[3], sl[3]);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        unsigned kb[4];
        ldmatrix_x4_trans(kb, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                  dt * 16 + (lane >> 4) * 8);
        mma_bf16(dq[2 * dt], sh, kb[0], kb[1]);
        mma_bf16(dq[2 * dt], sl, kb[0], kb[1]);
        mma_bf16(dq[2 * dt + 1], sh, kb[2], kb[3]);
        mma_bf16(dq[2 * dt + 1], sl, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // dQ * scale as bf16 into this warp's own Q rows (only this warp read
  // them), then out in 16-byte rows
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NDT; ++j) {
    const int at = (warp * 16 + g) * RS + 8 * j + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(qs + at) =
        __floats2bfloat162_rn(dq[j][0] * a.scale, dq[j][1] * a.scale);
    *reinterpret_cast<__nv_bfloat162*>(qs + at + 8 * RS) =
        __floats2bfloat162_rn(dq[j][2] * a.scale, dq[j][3] * a.scale);
  }
  __syncwarp();
  tc_store_rows<D>(static_cast<__nv_bfloat16*>(a.dq), qs + warp * 16 * RS, b, h, a.H,
                   q0 + warp * 16, a.Lq, lane);
}

// bf16: the dK/dV blocks ((key tile x slice, KV head, batch row), x
// fastest) first, then the dQ blocks ((query tile, head, batch row)), in
// one launch, so that the two kinds share the SMs (two blocks an SM) and
// the longer dK/dV blocks start first
template <int D>
__global__ void __launch_bounds__(TC_NT, BWD_TC_MIN_BLOCKS) flash_bwd_bf16_kernel(BwdArgs a) {
  const int nx = (a.Lk + BK - 1) / BK * a.splits;
  const long long n_dkdv = static_cast<long long>(nx) * a.HKV * a.B;
  const long long i = blockIdx.x;
  if (i < n_dkdv) {
    bwd_dkdv_bf16<D>(a, static_cast<int>(i % nx), static_cast<int>(i / nx % a.HKV),
                     static_cast<int>(i / nx / a.HKV));
  } else {
    const long long j = i - n_dkdv;
    const int nq = (a.Lq + BQ - 1) / BQ;
    bwd_dq_bf16<D>(a, static_cast<int>(j % nq) * BQ, static_cast<int>(j / nq % a.H),
                   static_cast<int>(j / nq / a.H));
  }
}

// dK = scale * sum_s partial dK[s] and dV = sum_s partial dV[s], the
// slices summed in the order 0 .. splits - 1, rounded once to T; four
// elements a thread
template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_reduce_kernel(BwdArgs a, long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * NT + threadIdx.x) * 4;
  if (i >= n) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(a.part + s * n + i);
    const float4 y = *reinterpret_cast<const float4*>(a.part + (a.splits + s) * n + i);
    sk.x += x.x, sk.y += x.y, sk.z += x.z, sk.w += x.w;
    sv.x += y.x, sv.y += y.y, sv.z += y.z, sv.w += y.w;
  }
  T* dk = static_cast<T*>(a.dk) + i;
  T* dv = static_cast<T*>(a.dv) + i;
  dk[0] = from_f32<T>(sk.x * a.scale), dk[1] = from_f32<T>(sk.y * a.scale);
  dk[2] = from_f32<T>(sk.z * a.scale), dk[3] = from_f32<T>(sk.w * a.scale);
  dv[0] = from_f32<T>(sv.x), dv[1] = from_f32<T>(sv.y);
  dv[2] = from_f32<T>(sv.z), dv[3] = from_f32<T>(sv.w);
}

// Di = rowsum(dO * O), the first launch of either dtype
template <typename T, int D>
cudaError_t launch_dot(const BwdArgs& a, cudaStream_t stream) {
  constexpr int RPB = NT / (D / attn::kVec<T>);   // rows a block
  const long long blocks = (static_cast<long long>(a.B) * a.Lq * a.H + RPB - 1) / RPB;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_dot_kernel<T, D><<<static_cast<unsigned>(blocks), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

// the sum of the slices' partials, after the dK/dV blocks (splits > 1)
template <typename T, int D>
cudaError_t launch_reduce(const BwdArgs& a, cudaStream_t stream) {
  if (a.splits == 1) return cudaSuccess;
  const long long n = static_cast<long long>(a.B) * a.Lk * a.HKV * D;
  const long long blocks = (n / 4 + NT - 1) / NT;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks), NT, 0, stream>>>(a, n);
  return cudaGetLastError();
}

// f32 on CUDA cores, on one stream: Di; dK/dV (its slices' partials when
// splits > 1); their sum; dQ. One block an SM (166 and 149 KB at D = 128).
template <int D>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  constexpr size_t dkdv_smem = bwd_dkdv_smem_bytes<D>(), dq_smem = bwd_dq_smem_bytes<D>();
  cudaError_t err = opt_in(flash_bwd_dkdv_kernel<float, D>, dkdv_smem, dkdv_ok);
  if (err == cudaSuccess) err = opt_in(flash_bwd_dq_kernel<float, D>, dq_smem, dq_ok);
  if (err == cudaSuccess) err = launch_dot<float, D>(a, stream);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<float, D>
      <<<dim3((a.Lk + BK - 1) / BK * a.splits, a.HKV, a.B), NT, dkdv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_reduce<float, D>(a, stream);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<float, D><<<dim3((a.Lq + BQ - 1) / BQ, a.H, a.B), NT, dq_smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16 on the tensor cores, on one stream: Di; the dK/dV and dQ blocks in
// one launch; the sum of the partials. Two blocks an SM (106 KB at D = 128).
template <int D>
cudaError_t launch_bwd_bf16(const BwdArgs& a, cudaStream_t stream) {
  static bool ok = false;
  constexpr size_t smem = bwd_tc_smem_bytes<D>();
  cudaError_t err = opt_in(flash_bwd_bf16_kernel<D>, smem, ok);
  if (err == cudaSuccess) err = launch_dot<__nv_bfloat16, D>(a, stream);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((a.Lk + BK - 1) / BK) * a.splits * a.HKV * a.B +
      static_cast<long long>((a.Lq + BQ - 1) / BQ) * a.H * a.B;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_bwd_bf16_kernel<D><<<static_cast<unsigned>(blocks), TC_NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<__nv_bfloat16, D>(a, stream);
}

cudaError_t launch_bwd_d(const BwdArgs& a, int dtype, int D, cudaStream_t stream) {
  if (dtype == 0 && D == 64) return launch_bwd_f32<64>(a, stream);
  if (dtype == 0 && D == 128) return launch_bwd_f32<128>(a, stream);
  if (dtype == 1 && D == 64) return launch_bwd_bf16<64>(a, stream);
  if (dtype == 1 && D == 128) return launch_bwd_bf16<128>(a, stream);
  return cudaErrorInvalidValue;
}

bool valid_shape(int B, int Lq, int Lk, int H, int HKV, int D, int n_sink) {
  return !(B < 1 || B > 65535 || Lq < 1 || Lk < 1 || HKV < 1 || H < HKV || H > 65535 ||
           H % HKV != 0 || (D != 64 && D != 128) || n_sink < 0);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = float32,
// 1 = bfloat16, for q, k, v and out alike; every tensor contiguous in the
// layout of the header. causal: 0 or 1; window <= 0 means no window; with a
// window, keys j < n_sink (>= 0) stay visible. lse is null (the serve path)
// or (B, H, Lq) f32 for each row's log-sum-exp of its visible scaled scores
// (-inf for a row that sees nothing): the training form, whose backward is
// flash_attention_bwd_split_launch.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, float* lse,
                           int dtype, int B, int Lq, int Lk, int H, int HKV, int D, int causal,
                           int window, int n_sink, float scale, void* stream) {
  if (!valid_shape(B, Lq, Lk, H, HKV, D, n_sink)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, lse, B, Lq, Lk, H, HKV, causal, window, n_sink, scale};
  return static_cast<int>(launch_d(a, dtype, D, static_cast<cudaStream_t>(stream)));
}

// dQ (B, Lq, H, D), dK and dV (B, Lk, HKV, D), in the operands' dtype,
// from q, k, v, the forward's out and lse, and dout (the layout of out);
// di is (B, H, Lq) f32 scratch. Same contract as the forward. Each key
// tile's dK/dV work is cut into `splits` (>= 1) slices, one block each;
// with splits > 1, part is (2, splits, B, Lk, HKV, D) f32 scratch for the
// slices' partial dK and dV, which a last launch sums; with splits == 1
// it may be null.
int flash_attention_bwd_split_launch(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, const float* lse,
                                     float* di, float* part, void* dq, void* dk, void* dv,
                                     int dtype, int B, int Lq, int Lk, int H, int HKV, int D,
                                     int causal, int window, int n_sink, int splits, float scale,
                                     void* stream) {
  if (!valid_shape(B, Lq, Lk, H, HKV, D, n_sink) || lse == nullptr || di == nullptr ||
      splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, out, dout, lse, di, part, dq, dk, dv,
                  B, Lq, Lk, H, HKV, causal, window, n_sink, splits, scale};
  return static_cast<int>(launch_bwd_d(a, dtype, D, static_cast<cudaStream_t>(stream)));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
