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
// Bound on an H100 SXM: the bytes of the visible K and V. At the serve
// path's shape (B = the misses of a batch, about 40; S = 96 slots, 65-88
// visible over the 23 decode steps; H = 32, HKV = 4, D = 128, bf16) that is
// about 40 * 77 * 4 * 128 * 2 B * 2 = 6.3 MB, 1.9 us at 3.35 TB/s, while
// the operations (4 * D FLOP per query head and visible slot) take 0.05 us
// at the bf16 rate; at yi-6b's 4,096-token context and B = 8 it is 67 MB,
// 20 us. The design before this one (one block per (b, kv-head), a warp per
// slot with G butterflies of shuffles, then one V element per thread and
// slot, each in turn) was neither: it waited on two serial latency chains
// with 156 blocks on 132 SMs, 31 times the bound (PERF.md, PR 17, step 1).
//
// Design (flash-decoding).
//   Grid (HKV, n_split, B): the S slots are cut into n_split near-equal
//     splits (split i holds [i S / n, (i + 1) S / n)); the wrapper's split()
//     (kernels/decode_attention.py) makes them 64 slots or more, as many as
//     that allows up to 128, so a long cache puts many blocks, hence many
//     loads, in flight on every SM, and a 96-slot cache is one block.
//   Loads: a block walks its split in tiles of up to 128 slots. It reads the
//     tile's slot_pos once into a visibility bitmask, then issues every
//     16-byte cp.async of the tile's K rows, then of its V rows, into shared
//     memory, and waits once for each (S runs while V lands); the copy of an
//     invisible slot (and of a row past the split) has source size 0: it
//     reads nothing and fills zeros, so a stale NaN never meets a weight of
//     0. With two or more tiles a split, the next tile's copies are in
//     flight while this one is used.
//   bf16 q and cache (the serve path, decode_tc_kernel): tensor cores,
//     mma.sync.m16n8k16, the G <= 16 query heads as the 16 rows of A. S =
//     Q K^T sums bf16 products in f32; P V takes P as a bf16 high part plus
//     the bf16 rounding of the rest, two MMAs into one f32 accumulator, as
//     flash_attention.cu does (P keeps ~16 bits). A warp takes 16-slot
//     groups for S and 16-column groups of D for P V.
//   Other dtypes (decode_core_kernel): CUDA cores, f32 products: one thread
//     per (slot, query head) over D from shared memory, then thread t owns
//     columns t and t + 128 of all G heads for P V. int8 is dequantized in
//     f32 after the load, as the TPU kernel does. No TF32 anywhere.
//   Softmax: one warp per query head, online across the split's tiles, the
//     scores and weights in shared memory.
//   Merge: with n_split > 1 each block writes its unnormalized (m, l, acc)
//     for the G heads to scratch, and a second kernel, launched from the
//     same entry point, weights the splits by exp(m_i - max m) and writes
//     the output, one block per (b, query head). (The last block of each (b,
//     kv-head) merging, found by a fence and an atomic counter, cost every
//     block the round trip while it held its SM: 10 of 51 us at S = 4096,
//     PERF.md, PR 17.) A split with nothing visible has m = -inf and weight
//     0; a row with nothing visible at all writes exact zeros. With n_split
//     == 1 the block writes the output itself. bf16 outputs round once,
//     from the f32 result.
//   Log-sum-exp: with a non-null lse (B, H) f32, whoever writes a row's
//     output also writes m + log(l) of its scaled scores (the merge kernel
//     from the splits' (m, l), weighted as for the output; -inf where no
//     slot is visible), which models/attention.py merges over the ranks a
//     sequence is split across (context-parallel decode). The serve path
//     passes null and does no extra work.
// What bounds it now (PERF.md, PR 17): at the serve path's 96 slots, one
// block's chain of dependent steps (slot_pos, copies, S, softmax, P V; about
// 9 us against 1.9 us of bytes, a third of it the MMA phases); at 4,096
// slots, about twice the bytes bound, of which the merge's second pass over
// the partials takes a sixth.
// Limits: G <= 16, D a multiple of 32 up to 256, q, k and v 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

using attn::from_f32;
using attn::kVec;
using attn::to_f32;

constexpr int NT = 128;        // threads per block: 4 warps
constexpr int NW = NT / 32;
constexpr int MAX_TILE = 128;  // cache slots per tile: one visibility bit a lane
constexpr int MAX_G = 16;      // query heads per KV head
constexpr int MAX_D = 256;     // head dim
constexpr int MAX_COLS = MAX_D / NT;
constexpr int ROW_PAD = 16;    // bytes after each staged row
constexpr int MAX_SMEM = 232448;
constexpr int MAX_SPLITS = 128;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_size 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
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

// (x, y) = hi + lo: hi their bf16 rounding, lo the bf16 rounding of the
// rest (exact in f32), the lower column in the lower half of each
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
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
  int n_split, tile, nbuf;
  float* part_acc;        // (B, HKV, n_split, G, D) when n_split > 1
  float* part_ml;         // (B, HKV, n_split, G, 2): running max, sum
  float* lse;             // (B, H) log-sum-exp of the scaled scores, or null
};

// a row's log-sum-exp from its running max and sum; -inf with nothing visible
__device__ __forceinline__ float lse_of(float m, float l) {
  return m == -INFINITY ? -INFINITY : m + logf(l);
}

__device__ __forceinline__ bool slot_visible(const Args& a, int s) {
  const int sp = a.slot_pos[s];
  bool v = sp >= 0 && sp <= a.pos;
  if (a.window > 0) v = v && (sp > a.pos - a.window || sp < a.n_sink);
  return v;
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared memory, in bytes from its start. Both kernels: the K and V tiles of
// each buffer ([nbuf][2][rows][D elements + ROW_PAD bytes]) and a 4-word
// visibility bitmask a buffer. The tensor-core kernel: Q as 16 bf16 rows and
// the scores, then weights, as (16, rows + 8) f32, rows = tile rounded up to
// 16. The CUDA-core kernel: Q (G, D) f32, scores (G, tile + 1), weights
// (tile, G rounded up to 4) and the int8 scales of each buffer.
struct Layout {
  bool tc;
  int rows, row_bytes, kv, visw, qs, sc, sc_stride, pw, ksc, vsc, total;
  __host__ __device__ Layout(bool tc_, int G, int D, int tile, int nbuf, int elem) {
    tc = tc_;
    rows = tc ? align16(tile) : tile;
    row_bytes = D * elem + ROW_PAD;
    kv = 0;
    visw = nbuf * 2 * rows * row_bytes;
    qs = align16(visw + 4 * NW * nbuf);
    if (tc) {
      sc_stride = rows + 8;   // float2 reads of 8 row groups: distinct banks
      sc = qs + 16 * row_bytes;
      pw = ksc = vsc = sc + 4 * 16 * sc_stride;
      total = pw;
    } else {
      sc_stride = tile + 1;
      sc = align16(qs + 4 * G * D);
      pw = align16(sc + 4 * G * sc_stride);
      ksc = align16(pw + 4 * tile * ((G + 3) & ~3));
      vsc = ksc + 4 * nbuf * tile;
      total = vsc + 4 * nbuf * tile;
    }
  }
};

// The staging common to both kernels: one block's split, walked in tiles.
template <typename KT>
struct Stager {
  const Args& a;
  const Layout& lay;
  unsigned char* smem;
  const KT* kbase;
  const KT* vbase;
  size_t row_stride, scale_base;
  int s_begin, s_end;

  __device__ Stager(const Args& a_, const Layout& l, unsigned char* sm, int b, int kvh, int split)
      : a(a_), lay(l), smem(sm) {
    row_stride = static_cast<size_t>(a.HKV) * a.D;   // between slots
    const size_t base = static_cast<size_t>(b) * a.S * row_stride + static_cast<size_t>(kvh) * a.D;
    kbase = static_cast<const KT*>(a.k) + base;
    vbase = static_cast<const KT*>(a.v) + base;
    scale_base = static_cast<size_t>(b) * a.S * a.HKV + kvh;
    s_begin = static_cast<int>(static_cast<long long>(split) * a.S / a.n_split);
    s_end = static_cast<int>(static_cast<long long>(split + 1) * a.S / a.n_split);
  }
  __device__ int n_tiles() const { return (s_end - s_begin + a.tile - 1) / a.tile; }
  __device__ int s0(int t) const { return s_begin + t * a.tile; }
  __device__ int slots(int t) const { return min(a.tile, s_end - s0(t)); }
  __device__ unsigned char* k_tile(int buf) const {
    return smem + lay.kv + static_cast<size_t>(buf) * 2 * lay.rows * lay.row_bytes;
  }
  __device__ unsigned char* v_tile(int buf) const {
    return k_tile(buf) + static_cast<size_t>(lay.rows) * lay.row_bytes;
  }
  __device__ unsigned* vis_words(int buf) const {
    return reinterpret_cast<unsigned*>(smem + lay.visw) + NW * buf;
  }
  __device__ bool visible(const unsigned* words, int j) const {
    return (words[j >> 5] >> (j & 31)) & 1u;
  }

  // the tile's visibility bits (warp w: slots 32 w + lane) and, for int8,
  // its scales; read by issue() after a barrier
  __device__ void flags(int t, int buf) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j = warp * 32 + lane, ns = slots(t), s = s0(t) + j;
    const bool v = j < ns && slot_visible(a, s);
    const unsigned word = __ballot_sync(0xffffffffu, v);
    if (lane == 0) vis_words(buf)[warp] = word;
    if (a.k_scale != nullptr && j < a.tile) {
      float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
      float* vsc = reinterpret_cast<float*>(smem + lay.vsc);
      const size_t o = scale_base + static_cast<size_t>(s) * a.HKV;
      ksc[buf * a.tile + j] = v ? a.k_scale[o] : 0.f;
      vsc[buf * a.tile + j] = v ? a.v_scale[o] : 0.f;
    }
  }

  // every 16-byte copy of the tile's K rows, one group, then of its V rows,
  // a second group; invisible slots, and rows past the split up to the next
  // 16 for the tensor cores, are zero-filled
  __device__ void issue(int t, int buf) const {
    const unsigned* words = vis_words(buf);
    const int cpr = a.D * static_cast<int>(sizeof(KT)) / 16;   // chunks a row
    const int ns = slots(t), first = s0(t);
    const int rows = lay.tc ? align16(ns) : ns;
    // chunk c = threadIdx.x + NT u of the tile is row j, 16 bytes ch: j and
    // ch advance by NT / cpr and NT % cpr a step, no division in the loop
    const int step_j = NT / cpr, step_ch = NT % cpr;
    for (int half = 0; half < 2; ++half) {
      const KT* base = half ? vbase : kbase;
      unsigned char* dst = half ? v_tile(buf) : k_tile(buf);
      int j = threadIdx.x / cpr, ch = threadIdx.x % cpr;
      while (j < rows) {
        const bool on = visible(words, j);
        const KT* row = base + static_cast<size_t>(on ? first + j : first) * row_stride;
        cp_async16(dst + j * lay.row_bytes + ch * 16,
                   reinterpret_cast<const unsigned char*>(row) + ch * 16, on ? 16 : 0);
        j += step_j;
        ch += step_ch;
        if (ch >= cpr) {
          ch -= cpr;
          ++j;
        }
      }
      cp_async_commit();
    }
  }
};

// Online softmax over a tile's scores sc[g * stride + j], j < ns, for the G
// heads, one warp a head; weights p = exp(x - m_new) go to
// w[j * w_row + g * w_col] for j < width (0 past ns), and corr[g] is the
// rescale of the accumulator.
__device__ __forceinline__ void softmax_tile(const float* sc, int stride, int ns, int width,
                                             int G, float* w, int w_row, int w_col,
                                             float* m_run, float* l_run, float* corr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < G; g += NW) {
    const float* row = sc + g * stride;
    float x[MAX_TILE / 32];
    float tmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < MAX_TILE / 32; ++u) {
      const int j = lane + 32 * u;
      x[u] = j < ns ? row[j] : -INFINITY;
      tmax = fmaxf(tmax, x[u]);
    }
    tmax = warp_max(tmax);
    const float m_old = m_run[g];
    const float m_new = fmaxf(m_old, tmax);
    // m_new is -inf only while nothing has been visible: weights 0, no
    // rescale (the accumulator is still 0)
    const float c = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_TILE / 32; ++u) {
      const int j = lane + 32 * u;
      const float p = x[u] == -INFINITY ? 0.f : expf(x[u] - m_new);
      if (j < width) w[j * w_row + g * w_col] = p;
      psum += p;
    }
    psum = warp_sum(psum);
    if (lane == 0) {
      l_run[g] = l_run[g] * c + psum;
      m_run[g] = m_new;
      corr[g] = c;
    }
  }
}

// The merge of the splits, a second kernel: one block per (query head of a
// group, kv-head, batch row). Its first warp weights split p by
// exp(m_p - max m) over the weighted sum of the l_p (ws); then the threads,
// in groups of D / 4 (one float4 of the head's columns each), sum the
// weighted partial accumulators of every n_sg-th split, and the groups'
// sums are added in order.
template <typename QT>
__global__ void __launch_bounds__(NT) decode_merge_kernel(Args a) {
  __shared__ float ws[MAX_SPLITS];
  __shared__ float4 red[NT];
  const int G = a.H / a.HKV, D = a.D, n = a.n_split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const size_t pair = static_cast<size_t>(b) * a.HKV + kvh;
  const float* ml = a.part_ml + pair * n * G * 2;
  const float* pa = a.part_acc + pair * n * G * D;
  if (warp == 0) {
    float m = -INFINITY;
    for (int p = lane; p < n; p += 32) m = fmaxf(m, ml[(p * G + g) * 2]);
    m = warp_max(m);
    float l = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float mp = ml[(p * G + g) * 2];
      // a split with nothing visible (mp = -inf) weighs 0, never NaN
      const float w = mp == -INFINITY ? 0.f : expf(mp - m);
      ws[p] = w;
      l = fmaf(w, ml[(p * G + g) * 2 + 1], l);
    }
    l = warp_sum(l);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int p = lane; p < n; p += 32) ws[p] *= inv;
    if (a.lse != nullptr && lane == 0)
      a.lse[static_cast<size_t>(b) * a.H + kvh * G + g] = lse_of(m, l);
  }
  __syncthreads();
  const int cols = D / 4, n_sg = NT / cols, sg = tid / cols, c4 = tid % cols;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sg < n_sg) {
#pragma unroll 8
    for (int p = sg; p < n; p += n_sg) {
      const float* row = pa + (static_cast<size_t>(p) * G + g) * D;
      const float4 x = reinterpret_cast<const float4*>(row)[c4];
      const float w = ws[p];
      o.x = fmaf(w, x.x, o.x);
      o.y = fmaf(w, x.y, o.y);
      o.z = fmaf(w, x.z, o.z);
      o.w = fmaf(w, x.w, o.w);
    }
  }
  red[tid] = o;
  __syncthreads();
  if (tid >= cols) return;
  for (int k = 1; k < n_sg; ++k) {
    const float4 x = red[tid + k * cols];
    o.x += x.x;
    o.y += x.y;
    o.z += x.z;
    o.w += x.w;
  }
  QT* out = static_cast<QT*>(a.out) + (static_cast<size_t>(b) * a.H + kvh * G + g) * D + 4 * c4;
  out[0] = from_f32<QT>(o.x);
  out[1] = from_f32<QT>(o.y);
  out[2] = from_f32<QT>(o.z);
  out[3] = from_f32<QT>(o.w);
}

__device__ __forceinline__ void write_ml(const Args& a, int b, int kvh, int split,
                                         const float* m_run, const float* l_run) {
  const int G = a.H / a.HKV;
  const size_t part = (static_cast<size_t>(b) * a.HKV + kvh) * a.n_split + split;
  if (static_cast<int>(threadIdx.x) < G) {
    a.part_ml[(part * G + threadIdx.x) * 2] = m_run[threadIdx.x];
    a.part_ml[(part * G + threadIdx.x) * 2 + 1] = l_run[threadIdx.x];
  }
}

// the single split's log-sum-exp of its G query heads, where asked for
__device__ __forceinline__ void write_lse(const Args& a, int b, int kvh, const float* m_run,
                                          const float* l_run) {
  const int G = a.H / a.HKV;
  if (a.lse != nullptr && static_cast<int>(threadIdx.x) < G)
    a.lse[static_cast<size_t>(b) * a.H + kvh * G + threadIdx.x] =
        lse_of(m_run[threadIdx.x], l_run[threadIdx.x]);
}

// ---- bf16 q and cache: tensor cores ------------------------------------
__global__ void __launch_bounds__(NT) decode_tc_kernel(Args a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_run[MAX_G], l_run[MAX_G], corr[MAX_G];
  const int G = a.H / a.HKV, D = a.D;
  const Layout lay(true, G, D, a.tile, a.nbuf, sizeof(T));
  const int RS = lay.row_bytes / 2;   // row stride in elements: D + 8
  const int SP = lay.sc_stride;
  T* qs = reinterpret_cast<T*>(smem + lay.qs);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  const int kvh = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;   // fragment row group, thread in group
  const Stager<T> st(a, lay, smem, b, kvh, split);
  const int n_tiles = st.n_tiles();

  if (n_tiles > 0) st.flags(0, 0);
  // Q as the 16 rows of A, rows past G zero
  const T* q = static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.H + kvh * G) * D;
  for (int c = tid; c < 16 * D / 8; c += NT) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < G) val = *reinterpret_cast<const uint4*>(q + r * D + col);
    *reinterpret_cast<uint4*>(qs + r * RS + col) = val;
  }
  if (tid < G) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  __syncthreads();
  if (n_tiles > 0) st.issue(0, 0);

  // this warp's 16-column groups of D: warp, warp + 4, ...; two 8-column
  // accumulator tiles each, rows gq (heads) and gq + 8
  constexpr int MAX_CG = MAX_D / 16 / NW;
  float o[MAX_CG][2][4];
#pragma unroll
  for (int i = 0; i < MAX_CG; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][h][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = a.nbuf > 1 ? t & 1 : 0;
    const bool next = t + 1 < n_tiles;
    if (next) st.flags(t + 1, buf ^ 1);
    cp_async_wait<1>();   // tile t's K rows; its V rows may be in flight
    __syncthreads();      // ... for every thread; tile t + 1's flags
    if (next) st.issue(t + 1, buf ^ 1);
    const int ns = st.slots(t);
    const T* ks = reinterpret_cast<const T*>(st.k_tile(buf));
    const T* vs = reinterpret_cast<const T*>(st.v_tile(buf));
    const unsigned* words = st.vis_words(buf);

    // ---- S = Q K^T, a warp per 16-slot group ---------------------------
    for (int grp = warp; grp * 16 < ns; grp += NW) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned qa[4], kb[4];
        ldmatrix_x4(qa, qs + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(kb, ks + (grp * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qa, kb[0], kb[1]);
        mma_bf16(s[1], qa, kb[2], kb[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = grp * 16 + 8 * h + 2 * tig + (e & 1), g = gq + 8 * (e >> 1);
          if (g < G && j < ns)
            sc[g * SP + j] = st.visible(words, j) ? s[h][e] * a.scale : -INFINITY;
        }
    }
    __syncthreads();
    softmax_tile(sc, SP, ns, lay.rows, G, sc, 1, SP, m_run, l_run, corr);
    if (next) {
      cp_async_wait<2>();   // tile t's V rows; tile t + 1's in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- O = O * corr + P V, P = hi + lo in bf16 -------------------------
    const float c0 = gq < G ? corr[gq] : 1.f, c1 = gq + 8 < G ? corr[gq + 8] : 1.f;
#pragma unroll
    for (int i = 0; i < MAX_CG; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[i][h][0] *= c0;
        o[i][h][1] *= c0;
        o[i][h][2] *= c1;
        o[i][h][3] *= c1;
      }
    for (int kk = 0; kk < (ns + 15) / 16; ++kk) {
      const float* p0 = sc + gq * SP + kk * 16 + 2 * tig;
      const float* p1 = p0 + 8 * SP;
      const float2 x00 = *reinterpret_cast<const float2*>(p0);
      const float2 x01 = *reinterpret_cast<const float2*>(p0 + 8);
      const float2 x10 = *reinterpret_cast<const float2*>(p1);
      const float2 x11 = *reinterpret_cast<const float2*>(p1 + 8);
      unsigned ph[4], pl[4];
      split_bf16(x00.x, x00.y, ph[0], pl[0]);
      split_bf16(x10.x, x10.y, ph[1], pl[1]);
      split_bf16(x01.x, x01.y, ph[2], pl[2]);
      split_bf16(x11.x, x11.y, ph[3], pl[3]);
#pragma unroll
      for (int i = 0; i < MAX_CG; ++i) {
        const int cg = warp + NW * i;
        if (cg * 16 >= D) break;
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                  cg * 16 + (lane >> 4) * 8);
        mma_bf16(o[i][0], ph, vb[0], vb[1]);
        mma_bf16(o[i][0], pl, vb[0], vb[1]);
        mma_bf16(o[i][1], ph, vb[2], vb[3]);
        mma_bf16(o[i][1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the buffer and the weights are free again
  }

  // ---- the output, or this split's partials and the merge ---------------
  const bool single = a.n_split == 1;
  const size_t part = (static_cast<size_t>(b) * a.HKV + kvh) * a.n_split + split;
  T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.H + kvh * G) * D;
#pragma unroll
  for (int i = 0; i < MAX_CG; ++i) {
    const int cg = warp + NW * i;
    if (cg * 16 >= D) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int g = gq + 8 * r, col = cg * 16 + 8 * h + 2 * tig;
        if (g >= G) continue;
        const float x = o[i][h][2 * r], y = o[i][h][2 * r + 1];
        if (single) {
          const float inv = 1.f / fmaxf(l_run[g], 1e-30f);
          *reinterpret_cast<__nv_bfloat162*>(out + g * D + col) =
              __floats2bfloat162_rn(x * inv, y * inv);
        } else {
          *reinterpret_cast<float2*>(a.part_acc + (part * G + g) * D + col) = make_float2(x, y);
        }
      }
  }
  if (!single) write_ml(a, b, kvh, split, m_run, l_run);
  else write_lse(a, b, kvh, m_run, l_run);
}

// ---- any other dtypes: CUDA cores, f32 products ------------------------
template <typename QT, typename KT>
__global__ void __launch_bounds__(NT) decode_core_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_run[MAX_G], l_run[MAX_G], corr[MAX_G];
  const int G = a.H / a.HKV, D = a.D, T = a.tile;
  const int gp = (G + 3) & ~3;
  const Layout lay(false, G, D, T, a.nbuf, sizeof(KT));
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* pw = reinterpret_cast<float*>(smem + lay.pw);
  const float* ksc = reinterpret_cast<const float*>(smem + lay.ksc);
  const float* vsc = reinterpret_cast<const float*>(smem + lay.vsc);
  const int kvh = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const bool quantized = a.k_scale != nullptr;
  const Stager<KT> st(a, lay, smem, b, kvh, split);
  const int n_tiles = st.n_tiles();
  const int cpr = D * static_cast<int>(sizeof(KT)) / 16;

  if (n_tiles > 0) st.flags(0, 0);
  const QT* q = static_cast<const QT*>(a.q) + (static_cast<size_t>(b) * a.H + kvh * G) * D;
  for (int i = tid; i < G * D; i += NT) qs[i] = to_f32(q[i]);
  if (tid < G) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  __syncthreads();
  if (n_tiles > 0) st.issue(0, 0);
  float acc[MAX_G][MAX_COLS];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c) acc[g][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = a.nbuf > 1 ? t & 1 : 0;
    if (t + 1 < n_tiles) st.flags(t + 1, buf ^ 1);
    cp_async_wait<0>();
    __syncthreads();   // tile t's rows, flags and scales; tile t + 1's flags
    if (t + 1 < n_tiles) st.issue(t + 1, buf ^ 1);
    const int ns = st.slots(t);
    const unsigned char* kt = st.k_tile(buf);
    const unsigned char* vt = st.v_tile(buf);
    const unsigned* words = st.vis_words(buf);
    // ---- scores: one thread per (slot, query head) -----------------------
    for (int i = tid; i < ns * G; i += NT) {
      const int j = i % ns, g = i / ns;
      float score = -INFINITY;
      if (st.visible(words, j)) {
        const unsigned char* krow = kt + j * lay.row_bytes;
        const float* qg = qs + g * D;
        const float ks = quantized ? ksc[buf * T + j] : 1.f;
        float dot = 0.f;
        for (int ch = 0; ch < cpr; ++ch) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + ch * 16);
          const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
          for (int u = 0; u < kVec<KT>; ++u) {
            float kf = to_f32(e[u]);
            if (quantized) kf *= ks;
            dot = fmaf(qg[ch * kVec<KT> + u], kf, dot);
          }
        }
        score = dot * a.scale;
      }
      sc[g * lay.sc_stride + j] = score;
    }
    __syncthreads();
    softmax_tile(sc, lay.sc_stride, ns, ns, G, pw, gp, 1, m_run, l_run, corr);
    __syncthreads();
    // ---- acc = acc * corr + P . V ----------------------------------------
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) {
          const float c = corr[g];
#pragma unroll
          for (int cc = 0; cc < MAX_COLS; ++cc) acc[g][cc] *= c;
        }
      for (int j = 0; j < ns; ++j) {
        float w[MAX_G];
#pragma unroll
        for (int g4 = 0; g4 < MAX_G / 4; ++g4)
          if (4 * g4 < G) {
            const float4 f = *reinterpret_cast<const float4*>(pw + j * gp + 4 * g4);
            w[4 * g4] = f.x;
            w[4 * g4 + 1] = f.y;
            w[4 * g4 + 2] = f.z;
            w[4 * g4 + 3] = f.w;
          }
        const KT* vrow = reinterpret_cast<const KT*>(vt + j * lay.row_bytes);
        const float vs = quantized ? vsc[buf * T + j] : 1.f;
#pragma unroll
        for (int cc = 0; cc < MAX_COLS; ++cc) {
          const int col = tid + NT * cc;
          if (col < D) {
            float vv = to_f32(vrow[col]);
            if (quantized) vv *= vs;
#pragma unroll
            for (int g = 0; g < MAX_G; ++g)
              if (g < G) acc[g][cc] = fmaf(w[g], vv, acc[g][cc]);
          }
        }
      }
    }
    __syncthreads();   // the buffer, scores and weights are free again
  }

  const bool single = a.n_split == 1;
  const size_t part = (static_cast<size_t>(b) * a.HKV + kvh) * a.n_split + split;
  QT* out = static_cast<QT*>(a.out) + (static_cast<size_t>(b) * a.H + kvh * G) * D;
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) {
        const float inv = 1.f / fmaxf(l_run[g], 1e-30f);
#pragma unroll
        for (int cc = 0; cc < MAX_COLS; ++cc) {
          const int col = tid + NT * cc;
          if (col >= D) continue;
          if (single) {
            out[g * D + col] = from_f32<QT>(acc[g][cc] * inv);
          } else {
            a.part_acc[(part * G + g) * D + col] = acc[g][cc];
          }
        }
      }
  }
  if (!single) write_ml(a, b, kvh, split, m_run, l_run);
  else write_lse(a, b, kvh, m_run, l_run);
}

// the splits' kernel, then, with more than one split, the merge
template <typename QT, typename K>
cudaError_t launch_kernel(K kernel, const Layout& lay, const Args& a, cudaStream_t stream) {
  if (lay.total + 4 * 3 * MAX_G > MAX_SMEM) return cudaErrorInvalidValue;
  // 48 KB, static shared memory included, without the opt-in
  if (lay.total > 32 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.HKV, a.n_split, a.B), NT, lay.total, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  decode_merge_kernel<QT><<<dim3(a.H / a.HKV, a.HKV, a.B), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.HKV;
  constexpr bool tc = sizeof(QT) == 2 && sizeof(KT) == 2;
  const Layout lay(tc, G, a.D, a.tile, a.nbuf, sizeof(KT));
  if constexpr (tc) {
    return launch_kernel<QT>(decode_tc_kernel, lay, a, stream);
  } else {
    return launch_kernel<QT>(decode_core_kernel<QT, KT>, lay, a, stream);
  }
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

// Returns the cudaError_t of the launches (0 on success). q_dtype: 0 =
// float32, 1 = bfloat16 (out has q's dtype); kv_dtype: 0 = float32, 1 =
// bfloat16, 2 = int8, which needs k_scale and v_scale (B, S, HKV) f32. Every
// tensor is contiguous in the layout of the header; q, k and v are 16-byte
// aligned. window <= 0 means no window. n_split splits of S (1 <= n_split
// <= min(S, 128)), each walked in tiles of `tile` <= 128 slots; with
// n_split > 1, part_acc holds B * HKV * n_split * G * D floats and part_ml
// B * HKV * n_split * G * 2, and a second kernel merges them. lse, when not
// null, receives (B, H) f32 log-sum-exps of the scaled scores.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* slot_pos, void* out, int q_dtype,
                            int kv_dtype, int B, int S, int H, int HKV, int D, int pos,
                            int window, int n_sink, float scale, int n_split, int tile,
                            void* part_acc, void* part_ml, void* lse, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || HKV < 1 || HKV > 65535 || H < HKV || H % HKV != 0 ||
      H / HKV > MAX_G || D < 32 || D > MAX_D || D % 32 != 0 ||
      (kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr) || n_split < 1 ||
      n_split > S || n_split > MAX_SPLITS || tile < 1 || tile > MAX_TILE ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int longest = (S + n_split - 1) / n_split;   // slots of the largest split
  const int nbuf = longest > tile ? 2 : 1;
  const Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(slot_pos), out, B, S, H, HKV, D, pos, window, n_sink,
               scale, n_split, tile, nbuf, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), static_cast<float*>(lse)};
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
