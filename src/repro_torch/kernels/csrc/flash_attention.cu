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

__device__ __forceinline__ Tiles live_tiles(const Args& a, int q0) {
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

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool configured = false;   // one opt-in per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
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

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = float32,
// 1 = bfloat16, for q, k, v and out alike; every tensor contiguous in the
// layout of the header. causal: 0 or 1; window <= 0 means no window; with a
// window, keys j < n_sink (>= 0) stay visible.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int dtype,
                           int B, int Lq, int Lk, int H, int HKV, int D, int causal, int window,
                           int n_sink, float scale, void* stream) {
  if (B < 1 || B > 65535 || Lq < 1 || Lk < 1 || HKV < 1 || H < HKV || H > 65535 ||
      H % HKV != 0 || (D != 64 && D != 128) || n_sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, Lq, Lk, H, HKV, causal, window, n_sink, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_d(a, dtype, D, st));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
