// IVF candidate top-k over the cache slab, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ivf_topk.py::_ivf_topk_kernel
// (ivf_topk_pallas), the candidate stage of IVFIndex.search. Per query row b:
// score the slab row of every visible candidate id cand[b, :] against the
// query and keep the k <= 32 best, ordered by (score desc, candidate position
// asc); return their slot ids, with (-inf, -1) where fewer than k ids are
// visible. The (B, M, d) tensor of gathered rows never exists.
//
// Visibility: an id is visible when 0 <= id < N. IVFIndex.candidates folds
// every other rule (bucket validity, aliveness, tenancy, per-row duplicates)
// into -1 before the call, and never gives an id >= N; the kernel treats one
// as invisible rather than read past the slab, and the plain version
// (kernels/ref.py::ivf_topk_ref) does the same.
//
// The grouping. IVFIndex builds cand from its probe: with probe (B, P) the
// probed bucket of each block of cap positions and buckets (C, cap) the
// bucket table, every entry cand[b, j * cap + t] is either -1 or
// buckets[probe[b, j], t]. So the queries that probe one bucket share its
// member rows. The kernel works bucket by bucket: it stages a bucket's live
// members (0 <= id < N) in shared memory once and scores them against every
// (row, probe) pair that probed the bucket, reading cand only at those
// members' positions to learn what each pair may see. Nothing checks the
// contract here (it would need a sync); ops.ivf_topk checks it on the CPU
// and chip_smoke.py on the serve path's operands. Called without a probe,
// the entry point describes cand itself as groups of one: each row's chunk
// of UNGROUPED_CAP positions is its own bucket, probed by that row alone,
// and the same kernel runs with the same task shape (a task's other three
// pairs left empty).
//
// Serve shape (B=128, P=16 probes of cap=1,024, M=16,384, N=16,384, d=384,
// k=4): 735 visible ids a row (94,133 in all), 5,625 distinct live slab rows,
// about 44 a bucket, so each live row is visible to ~16.7 pairs. Scoring
// each pair from its own copy of the row (the per-query kernel before this
// one) moved 145 MB from L2 a call. Bucket by bucket, the work is 72 MFLOP
// (~1 us of f32 FMAs at 67 TFLOP/s) and the bytes are the 8.6 MB of live rows
// (f32) read once, ~0.4 MB of cand entries at live positions, the bucket
// table and the probe matrix: bound by bytes, a few us at 3.35 TB/s. The
// busiest bucket is probed by 39 rows and holds 114 members (4,446 dot
// products, 6x the mean), so a bucket's work is cut into units that
// several SMs share.
//
// Design. Pass 1, grid (C buckets, ZM x ZS blocks a bucket), 4 warps a
// block. A block scans its bucket's row of the table and the (B, P) probe
// matrix (8 KB at the serve shape) with coalesced loads and ballots,
// counting the live members and the probing (row, probe) pairs first: a
// block with no unit of its own leaves before compacting anything. A unit
// is a tile of up to 32 live members times a slice of up to 16 pairs; block
// (zm, zs) takes tiles zm, zm + ZM, ... and slices zs, zs + ZS, ..., so a
// bucket of any cap and any number of probing rows is tiled, and the
// busiest bucket's 12 units run on 12 blocks at once. A unit stages its
// member rows in shared memory by 16-byte cp.async, all in flight at once,
// while each warp loads its four pairs' query slices into registers and
// the cand entries at its members' positions (what each pair may see).
// A warp scores 4 pairs x 8 members at a time: each lane holds the
// queries' elements 4g..4g+3 for g =
// lane, lane + 32, ..., runs one FMA chain per (pair, member) over them in
// element order, and a transposing butterfly (31 shuffles) leaves the 32
// dot products one a lane. Each segment of lanes (one pair) sorts its
// scores by (score desc, position asc) and merges them into the pair's
// running best (a bitonic half cleaner); the warp writes the best k (k <=
// the segment) of its share of the tile, keyed by candidate position j *
// cap + t. Above that each group is written whole. The block that holds a
// slice's first tile writes each of its pairs' entry count.
// Pass 2, one warp a row: the row's P lists of entries, read four a lane
// at once, offered to a warp top-k list, and the k positions mapped to
// slot ids through cand.
//
// Scores are bitwise the same wherever a (query, row) pair is scored: each
// lane's chain covers the same elements in the same order, and the
// butterfly adds the lanes in one fixed tree, whatever the tile, bucket,
// group size or position. So equal key rows tie exactly, ties resolve by
// candidate position alone (as the TPU kernel's lax.top_k over positions
// does), and the grouped and ungrouped forms give the same bits. Rows whose
// d * sizeof(key) is not a multiple of 16 are staged element by element,
// zero-padded to a multiple of 4 elements, with the same lane mapping.
#include <cuda_runtime.h>

#include "warp_topk.cuh"

namespace {

using namespace warp_topk;

constexpr int NT = 128;                 // pass-1 threads per block
constexpr int WARPS = NT / 32;
// A warp task scores QW pairs x GM members, QW * GM = 32: four pairs of a
// bucket share each staged row.
constexpr int QW = 4;                   // pairs
constexpr int GM = 32 / QW;             // members (one group)
constexpr int PS = WARPS * QW;          // pairs in a slice
constexpr int RQ = 3;                   // float4 query groups a lane holds per chunk
constexpr int WINDOW = 512;             // live members a block keeps from one scan
constexpr int PAIRS = 64;               // probing pairs a block keeps from one scan
constexpr int MAX_ROW_SMEM = 8 * 4096 * 4;  // the largest tile: 8 rows of d=4096 f32
constexpr int ROW_BUDGET = 48 * 1024;       // a tile's rows, four blocks an SM
constexpr int SCAN_E = 16;              // ints a thread scans per round
constexpr int MAX_D = 4096;
constexpr int MAX_P = 32;               // probes a row (grouped)
constexpr int UNGROUPED_CAP = 2048;     // positions of a group of one
constexpr int MW = 4;                   // pass-2 rows (warps) per block

struct Params {
  const float* q;
  const void* keys;
  const int* cand;     // (B, M)
  const int* probe;    // (B, P), or null: groups of one
  const int* buckets;  // (C, cap), or null
  int B, N, M, d, k, P, C, cap;
  int LPP;     // lists a pair can have: one per (tile, group)
  int KL;      // entries a list: min(k, GM)
  int MT;      // members in a tile
  int stride;  // shared bytes per staged row
  int ZM, ZS;  // blocks a bucket: tiles x slices
  float* part_s;  // (B * P, LPP, KL), in the scratch
  int* part_i;    // candidate positions, -1 where empty
  int* pair_cnt;  // (B * P): entries written for each pair
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// 4 staged key elements (group g of a row in shared memory) -> f32, as
// to_f32 converts one key
template <typename KT>
struct Four;

template <>
struct Four<float> {
  __device__ static float4 load(const char* row, int g) {
    return *reinterpret_cast<const float4*>(row + 16 * g);
  }
};

template <>
struct Four<__nv_bfloat16> {
  __device__ static float4 load(const char* row, int g) {
    const uint2 r = *reinterpret_cast<const uint2*>(row + 8 * g);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

template <>
struct Four<int8_t> {
  __device__ static float4 load(const char* row, int g) {
    const int w = *reinterpret_cast<const int*>(row + 4 * g);
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)  // byte i, sign-extended
      f[i] = __fmul_rn(
          static_cast<float>(static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * i)) >> 24),
          1.0f / 127.0f);
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename KT>
__device__ __forceinline__ KT zero_key();
template <>
__device__ __forceinline__ float zero_key<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_key<__nv_bfloat16>() { return __float2bfloat16(0.0f); }
template <>
__device__ __forceinline__ int8_t zero_key<int8_t>() { return 0; }

// ---- the block's ordered selection ----------------------------------------
// A round scans SCAN_E * NT ints of a source, coalesced; element e matches
// when its value passes the test (a live member: 0 <= v < N; a probing
// pair: v == c). Matches are ranked in element order, and those with rank in
// [lo, lo + W) are kept: out_a[rank - lo] = e and, for members, out_b[rank -
// lo] = v.
struct Scan {
  const int* src;
  int n;
  int lo, W;
  int* out_a;
  int* out_b;
  int found;  // matches before this round
};

__device__ __forceinline__ void scan_load(const Scan& s, int base, int (&v)[SCAN_E]) {
#pragma unroll
  for (int i = 0; i < SCAN_E; ++i) {
    const int e = base + i * NT + threadIdx.x;
    v[i] = e < s.n ? __ldg(s.src + e) : -1;
  }
}

// the warp's ballots and, from lane 0, its counts: per group of NT elements
// and in all
__device__ __forceinline__ void scan_count(const int (&v)[SCAN_E], bool members, int c, int N,
                                           unsigned (&bal)[SCAN_E], int (*cnt)[WARPS],
                                           int* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
#pragma unroll
  for (int i = 0; i < SCAN_E; ++i) {
    const bool match = members ? (v[i] >= 0 && v[i] < N) : v[i] == c;
    bal[i] = __ballot_sync(FULL, match);
    const int x = __popc(bal[i]);
    if (lane == 0) cnt[i][warp] = x;
    total += x;
  }
  if (lane == 0) warp_total[warp] = total;
}

// after the counts are visible to the block
__device__ __forceinline__ void scan_place(Scan& s, int base, const int (&v)[SCAN_E],
                                           const unsigned (&bal)[SCAN_E],
                                           const int (*cnt)[WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  int run = s.found;
#pragma unroll
  for (int i = 0; i < SCAN_E; ++i) {
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int x = cnt[i][w];
      before += w < warp ? x : 0;
      total += x;
    }
    if (bal[i] >> lane & 1u) {
      const int r = run + before + __popc(bal[i] & below) - s.lo;
      if (r >= 0 && r < s.W) {
        s.out_a[r] = base + i * NT + threadIdx.x;
        if (s.out_b) s.out_b[r] = v[i];
      }
    }
    run += total;
  }
}

struct ScanSmem {
  int cnt[2][SCAN_E][WARPS];
  int total[2][WARPS];
};

// Scans the members and (grouped) the probe matrix in one loop, so both
// rounds' loads are in flight together, and returns with the kept entries
// and the totals in mem.found and pairs.found visible to the whole block.
// Where one round covers both, a block that `idle` says has no work
// returns true before placing anything.
template <typename Idle>
__device__ __forceinline__ bool select(Scan& mem, Scan& pairs, bool grouped, int c, int N,
                                       ScanSmem& sm, Idle idle) {
  mem.found = 0;
  pairs.found = 0;
  const int n = grouped ? max(mem.n, pairs.n) : mem.n;
  for (int base = 0; base < n; base += SCAN_E * NT) {
    int vm[SCAN_E], vp[SCAN_E];
    unsigned bm[SCAN_E], bp[SCAN_E];
    scan_load(mem, base, vm);
    if (grouped) scan_load(pairs, base, vp);
    scan_count(vm, true, c, N, bm, sm.cnt[0], sm.total[0]);
    if (grouped) scan_count(vp, false, c, N, bp, sm.cnt[1], sm.total[1]);
    __syncthreads();
    int tm = 0, tp = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      tm += sm.total[0][w];
      tp += grouped ? sm.total[1][w] : 0;
    }
    if (n <= SCAN_E * NT && idle(tm, grouped ? tp : 1)) return true;  // block-uniform
    scan_place(mem, base, vm, bm, sm.cnt[0]);
    if (grouped) scan_place(pairs, base, vp, bp, sm.cnt[1]);
    mem.found += tm;
    pairs.found += tp;
    __syncthreads();
  }
  return false;
}

// ---- the warp's dot products ----------------------------------------------
// a[i] of every lane -> lane i holds the sum over the 32 lanes of a[i]: at
// each level a lane keeps the half of its values that its lane bit selects
// and adds its partner's copy of the same half, so value i is summed in the
// tree of a butterfly (xor 16, 8, 4, 2, 1) whatever i is
template <int O>
__device__ __forceinline__ void transpose_level(float (&a)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? a[i] : a[i + O];
    const float keep = upper ? a[i + O] : a[i];
    a[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

__device__ __forceinline__ float transpose_sum(float (&a)[32], int lane) {
  transpose_level<16>(a, lane);
  transpose_level<8>(a, lane);
  transpose_level<4>(a, lane);
  transpose_level<2>(a, lane);
  transpose_level<1>(a, lane);
  return a[0];
}

// sorts each GM-lane segment by ranks_before (bitonic), best in the
// segment's first lane
__device__ __forceinline__ void sort_segment(float& s, int& p, int lane) {
  const int m = lane & (GM - 1);
#pragma unroll
  for (int size = 2; size <= GM; size <<= 1) {
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
      const float os = __shfl_xor_sync(FULL, s, st);
      const int op = __shfl_xor_sync(FULL, p, st);
      const bool best_first = (m & size) == 0;  // this run's order
      const bool low = (m & st) == 0;
      const bool other_before = ranks_before(os, op, s, p);
      if (low == best_first ? other_before : (!other_before && (os != s || op != p))) {
        s = os;
        p = op;
      }
    }
  }
}

// (rs, rp), a GM-lane segment sorted best first, becomes the best GM of it
// and (ns, np), another such: the better of entry m and the other's entry
// GM-1-m makes a bitonic run holding the best GM, which a half cleaner
// sorts
__device__ __forceinline__ void merge_segment(float& rs, int& rp, float ns, int np, int lane) {
  const float os = __shfl_xor_sync(FULL, ns, GM - 1);
  const int op = __shfl_xor_sync(FULL, np, GM - 1);
  if (ranks_before(os, op, rs, rp)) {
    rs = os;
    rp = op;
  }
  const int m = lane & (GM - 1);
#pragma unroll
  for (int st = GM >> 1; st > 0; st >>= 1) {
    const float xs = __shfl_xor_sync(FULL, rs, st);
    const int xp = __shfl_xor_sync(FULL, rp, st);
    const bool other_before = ranks_before(xs, xp, rs, rp);
    if ((m & st) == 0 ? other_before : (!other_before && (xs != rs || xp != rp))) {
      rs = xs;
      rp = xp;
    }
  }
}

// x += q . k over 4 elements, in element order
__device__ __forceinline__ void fma4(float& x, const float4& q, const float4& k) {
  x = fmaf(q.x, k.x, x);
  x = fmaf(q.y, k.y, x);
  x = fmaf(q.z, k.z, x);
  x = fmaf(q.w, k.w, x);
}

template <bool VEC>
__device__ __forceinline__ void load_queries(const Params& a, const int* slice, int np, int quad,
                                             int ch, int lane, float4 (&qv)[QW][RQ]) {
#pragma unroll
  for (int p = 0; p < QW; ++p) {
    const int pi = quad * QW + p;
    const float* row = pi < np ? a.q + (size_t)(slice[pi] / a.P) * a.d : nullptr;
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int g = ch * (32 * RQ) + lane + 32 * r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row != nullptr && 4 * g < a.d) {
        if constexpr (VEC) {
          v = __ldg(reinterpret_cast<const float4*>(row) + g);
        } else {
          const int e = 4 * g;
          v.x = row[e];
          v.y = e + 1 < a.d ? row[e + 1] : 0.0f;
          v.z = e + 2 < a.d ? row[e + 2] : 0.0f;
          v.w = e + 3 < a.d ? row[e + 3] : 0.0f;
        }
      }
      qv[p][r] = v;
    }
  }
}

// at most 128 registers, so that four blocks fit an SM (the grouped forms
// spill 12-24 bytes, the others 0-4; 4% faster at the serve shape than
// 159-168 registers)
template <typename KT, bool GROUPED, bool VEC>
__global__ void __launch_bounds__(NT, 4)
ivf_topk_buckets(const Params a) {
  extern __shared__ __align__(16) char rows[];  // MT staged rows, a.stride bytes each
  __shared__ int mem_t[WINDOW], mem_id[WINDOW];  // live members: position, slot
  __shared__ int pair_f[PAIRS];                  // probing pairs: b * P + j
  __shared__ ScanSmem scan_smem;
  // the bucket, and this block's place among its ZM x ZS blocks
  const int c = blockIdx.x;
  const int zm = blockIdx.y % a.ZM, zs = blockIdx.y / a.ZM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the member source: the bucket's row of the table, or the row's chunk
  Scan mem, pairs;
  if constexpr (GROUPED) {
    mem.src = a.buckets + (size_t)c * a.cap;
    mem.n = a.cap;
    pairs.src = a.probe;
    pairs.n = a.B * a.P;
  } else {
    const int b = c / a.P, j = c % a.P;
    mem.src = a.cand + (size_t)b * a.M + (size_t)j * a.cap;
    mem.n = min(a.cap, a.M - j * a.cap);
    pairs.src = nullptr;
    pairs.n = 0;
  }
  mem.W = WINDOW;
  mem.out_a = mem_t;
  mem.out_b = mem_id;
  pairs.W = PAIRS;
  pairs.out_a = pair_f;
  pairs.out_b = nullptr;

  const int SD = (a.d + 3) & ~3;  // staged elements a row
  const int NG4 = SD / 4;
  const int chunks = (NG4 + 32 * RQ - 1) / (32 * RQ);
  const char* kbytes = static_cast<const char*>(a.keys);
  const size_t row_bytes = (size_t)a.d * sizeof(KT);

  // the windows of live members and pairs this block holds: [mem_lo, mem_lo
  // + WINDOW) and [pair_lo, pair_lo + PAIRS) in rank order
  int ntiles = 1, nslices = 1, live = 0, nq = 1, mem_lo = -1, pair_lo = -1;
  for (int it = 0;; ++it) {
    // this block's tiles zm, zm + ZM, ... (at least tile 0, which carries
    // the entry counts when the bucket has no live member) and slices zs,
    // zs + ZS, ...
    const int per = it == 0 ? 1 : (nslices - zs + a.ZS - 1) / a.ZS;
    const int mt = zm + a.ZM * (it / per), s = zs + a.ZS * (it % per);
    if (it > 0 && (mt >= ntiles || s >= nslices)) break;
    // scan again only for members or pairs past the windows
    const int lo = mt * a.MT, plo = s * PS;
    if (mem_lo < 0 || lo < mem_lo || lo + a.MT > mem_lo + WINDOW || plo < pair_lo ||
        plo + PS > pair_lo + PAIRS) {
      mem.lo = lo;
      pairs.lo = plo;
      // this block's first unit exists when tile zm and slice zs do
      const bool idle = select(mem, pairs, GROUPED, c, a.N, scan_smem, [&](int m, int q) {
        return it == 0 && (mt >= max(1, (m + a.MT - 1) / a.MT) || s >= (q + PS - 1) / PS);
      });
      if (idle) break;
      mem_lo = lo;
      pair_lo = plo;
      live = mem.found;
      nq = GROUPED ? pairs.found : 1;
      ntiles = max(1, (live + a.MT - 1) / a.MT);
      nslices = (nq + PS - 1) / PS;
      if (it == 0 && (mt >= ntiles || s >= nslices)) break;  // block-uniform
      if (!GROUPED) {
        if (threadIdx.x == 0) pair_f[0] = c;
        __syncthreads();
      }
    }
    const int* tile_t = mem_t + (lo - mem_lo);
    const int* tile_id = mem_id + (lo - mem_lo);
    const int* slice = pair_f + (plo - pair_lo);
    const int nm = max(0, min(a.MT, live - lo));
    const int np = min(PS, nq - plo);

    // a quad of pairs takes S warps, each a share of the tile's groups and a
    // top-k list for each of its pairs
    const int NQ = (np + QW - 1) / QW;
    const int S = max(1, min(WARPS / max(NQ, 1), a.MT / GM));
    // k <= GM: one sorted list of k a (pair, tile, share); else one of GM a
    // (pair, group)
    const bool running = a.k <= GM;
    if (mt == 0) {  // each pair's entry count, once
      const int n_entries = running ? (live + a.MT - 1) / a.MT * S * a.k
                                    : (live + GM - 1) / GM * GM;
      for (int i = threadIdx.x; i < np; i += NT) a.pair_cnt[slice[i]] = n_entries;
    }
    if (nm > 0) {
      // the tile's rows, every copy in flight at once
      if constexpr (VEC) {
        const int gran = (int)(row_bytes / 16);
        for (int x = threadIdx.x; x < nm * gran; x += NT) {
          const int r = x / gran, gq = x - r * gran;
          cp_async16(rows + r * a.stride + 16 * gq,
                     kbytes + (size_t)tile_id[r] * row_bytes + 16 * gq);
        }
        cp_async_commit();
      } else {
        const KT* keys = static_cast<const KT*>(a.keys);
        for (int x = threadIdx.x; x < nm * SD; x += NT) {
          const int r = x / SD, e = x - r * SD;
          reinterpret_cast<KT*>(rows + r * a.stride)[e] =
              e < a.d ? keys[(size_t)tile_id[r] * a.d + e] : zero_key<KT>();
        }
      }

      const int NG = (nm + GM - 1) / GM;
      const int quad = warp / S, sub = warp % S;
      const int po = lane / GM, mo = lane % GM;
      const bool active = quad < NQ;
      float4 qv[QW][RQ];
      int pos = -1;
      bool vis = false;
      // what this lane's (pair, member) of group grp may see: cand at the
      // member's position in the pair's row
      auto prepare = [&](int grp) {
        const int pi = quad * QW + po, mi = grp * GM + mo;
        const bool ok = pi < np && mi < nm;
        const int f = pi < np ? slice[pi] : 0;
        pos = ok ? (f % a.P) * a.cap + tile_t[mi] : -1;
        vis = ok;
        if constexpr (GROUPED) {
          if (ok) {
            const int id = __ldg(a.cand + (size_t)(f / a.P) * a.M + pos);
            vis = id >= 0 && id < a.N;
          }
        }
      };
      // the first group's loads go out while the rows land
      if (active) {
        load_queries<VEC>(a, slice, np, quad, 0, lane, qv);
        if (sub < NG) prepare(sub);
      }
      if constexpr (VEC) cp_async_wait_all();
      __syncthreads();
      if (active) {
        float rs = -INFINITY;  // this lane's entry of its segment's list
        int rp = -1;
        const int pi = quad * QW + po;
        const size_t list0 = pi < np ? (size_t)slice[pi] * a.LPP : 0;
        for (int grp = sub; grp < NG; grp += S) {
          if (grp != sub) prepare(grp);
          float acc[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
          for (int ch = 0; ch < chunks; ++ch) {
            if (ch > 0 || (grp != sub && chunks > 1))
              load_queries<VEC>(a, slice, np, quad, ch, lane, qv);
            // the same FMAs in both branches; a full chunk needs no bounds
            if ((ch + 1) * 32 * RQ <= NG4) {
#pragma unroll
              for (int m = 0; m < GM; ++m) {
                const char* row = rows + (grp * GM + m) * a.stride;
#pragma unroll
                for (int r = 0; r < RQ; ++r) {
                  const float4 kv = Four<KT>::load(row, ch * (32 * RQ) + lane + 32 * r);
#pragma unroll
                  for (int p = 0; p < QW; ++p) fma4(acc[p * GM + m], qv[p][r], kv);
                }
              }
            } else {
#pragma unroll
              for (int m = 0; m < GM; ++m) {
                const char* row = rows + (grp * GM + m) * a.stride;
#pragma unroll
                for (int r = 0; r < RQ; ++r) {
                  const int g = ch * (32 * RQ) + lane + 32 * r;
                  if (g < NG4) {
                    const float4 kv = Four<KT>::load(row, g);
#pragma unroll
                    for (int p = 0; p < QW; ++p) fma4(acc[p * GM + m], qv[p][r], kv);
                  }
                }
              }
            }
          }
          const float dot = transpose_sum(acc, lane);
          float sc = vis ? dot : -INFINITY;
          int ps = vis ? pos : -1;
          if (running) {
            sort_segment(sc, ps, lane);
            merge_segment(rs, rp, sc, ps, lane);
          } else if (pi < np) {  // k > GM: every score of the group
            const size_t o = (list0 + mt * (a.MT / GM) + grp) * GM + mo;
            a.part_s[o] = sc;
            a.part_i[o] = ps;
          }
        }
        // the best k of this warp's share of the tile, for each pair of its
        // quad, keyed by position
        if (running && pi < np && mo < a.k) {
          const size_t o = (list0 + mt * S + sub) * a.k + mo;
          a.part_s[o] = rs;
          a.part_i[o] = rp;
        }
      }
    }
    __syncthreads();  // the tile and lists are reused by the next unit
  }
}

__global__ void __launch_bounds__(MW * 32)
ivf_topk_merge(const Params a, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * MW + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp leaves together
  const size_t per_pair = (size_t)a.LPP * a.KL;
  float ls = -INFINITY;
  int li = -1;
  // the row's pairs 32 at a time: lane j holds pair j0 + j's entry count and
  // where its entries start among the chunk's
  for (int j0 = 0; j0 < a.P; j0 += 32) {
    const int j = j0 + lane;
    int n = 0;
    if (j < a.P) {
      const size_t f = (size_t)b * a.P + j;
      // a probe outside the table matched no bucket: no entries
      const bool ok = a.probe == nullptr || (unsigned)__ldg(a.probe + f) < (unsigned)a.C;
      n = ok ? a.pair_cnt[f] : 0;
    }
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const int start = incl - n, total = __shfl_sync(FULL, incl, 31);
    const int pairs = min(32, a.P - j0);
    // entries 32 at a time, four reads in flight
    constexpr int U = 4;
    for (int e0 = 0; e0 < total; e0 += 32 * U) {
      float s[U];
      int p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + 32 * u + lane;
        // the last pair whose entries start at or before e
        int lo = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int mid = lo + step;
          const int at = __shfl_sync(FULL, start, min(mid, 31));
          if (mid < pairs && at <= e) lo = mid;
        }
        const int from = __shfl_sync(FULL, start, lo);
        s[u] = -INFINITY;
        p[u] = -1;
        if (e < total) {
          const size_t o = ((size_t)b * a.P + j0 + lo) * per_pair + (e - from);
          s[u] = a.part_s[o];
          p[u] = a.part_i[o];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) warp_offer(s[u], p[u], p[u] >= 0, a.k, lane, ls, li);
    }
  }
  if (lane < a.k) {
    out_s[(size_t)b * a.k + lane] = ls;
    out_i[(size_t)b * a.k + lane] = li >= 0 ? __ldg(a.cand + (size_t)b * a.M + li) : -1;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename KT, bool GROUPED, bool VEC>
cudaError_t launch(const Params& a, float* out_s, int* out_i, cudaStream_t stream) {
  const auto kernel = ivf_topk_buckets<KT, GROUPED, VEC>;
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_ROW_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<dim3(a.C, a.ZM * a.ZS), NT, a.MT * a.stride, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ivf_topk_merge<<<(a.B + MW - 1) / MW, MW * 32, 0, stream>>>(a, out_s, out_i);
  return cudaGetLastError();
}

template <typename KT, bool GROUPED>
cudaError_t launch_form(const Params& a, float* out_s, int* out_i, cudaStream_t stream) {
  // 16-byte copies where every row starts on 16 bytes; the float4 query
  // loads where every query row does
  const bool vec = a.d * sizeof(KT) % 16 == 0 && a.d % 4 == 0 && aligned16(a.keys) &&
                   aligned16(a.q);
  return vec ? launch<KT, GROUPED, true>(a, out_s, out_i, stream)
             : launch<KT, GROUPED, false>(a, out_s, out_i, stream);
}

template <typename KT>
cudaError_t launch_keys(const Params& a, float* out_s, int* out_i, cudaStream_t stream) {
  return a.probe != nullptr ? launch_form<KT, true>(a, out_s, out_i, stream)
                            : launch_form<KT, false>(a, out_s, out_i, stream);
}

// The launch's plan, decided here alone; false where the kernel does not
// take the call. Grouped, (P, C, cap) are the caller's; else groups of one:
// cap = min(M, UNGROUPED_CAP), P = ceil(M / cap), C = B * P. A tile holds
// MT members, a multiple of GM (32, fewer where the rows would pass
// ROW_BUDGET bytes, at least one group); each bucket gets up to ZM x ZS
// blocks, its tiles and slices dealt round robin.
bool plan(Params& a, bool grouped, int key_dtype) {
  const int bytes = key_dtype == 0 ? 4 : key_dtype == 1 ? 2 : key_dtype == 2 ? 1 : 0;
  if (bytes == 0 || a.B < 1 || a.N < 1 || a.M < 1 || a.d < 1 || a.d > MAX_D || a.k < 1 ||
      a.k > MAX_K)
    return false;
  if (grouped) {
    if (a.P < 1 || a.P > MAX_P || a.C < 1 || a.cap < 1 || (long long)a.P * a.cap != a.M)
      return false;
  } else {
    a.cap = min(a.M, UNGROUPED_CAP);
    a.P = (a.M + a.cap - 1) / a.cap;
    a.C = a.B * a.P;
  }
  a.stride = ((a.d + 3) / 4 * 4 * bytes + 15) / 16 * 16;
  a.MT = max(GM, min(32, ROW_BUDGET / (GM * a.stride) * GM));
  a.LPP = (a.cap + a.MT - 1) / a.MT * (a.MT / GM);
  a.KL = min(a.k, GM);
  a.ZM = min((a.cap + a.MT - 1) / a.MT, grouped ? 4 : 2);
  a.ZS = grouped ? min((a.B * a.P + PS - 1) / PS, 3) : 1;
  return true;
}

Params call_params(int B, int N, int M, int d, int k, int P, int C, int cap) {
  Params a{};
  a.B = B;
  a.N = N;
  a.M = M;
  a.d = d;
  a.k = k;
  a.P = P;
  a.C = C;
  a.cap = cap;
  return a;
}

// part_s and part_i hold B * P * LPP * KL entries each
long long list_entries(const Params& a) { return (long long)a.B * a.P * a.LPP * a.KL; }

}  // namespace

extern "C" {

// The bytes of scratch ivf_topk_launch needs for this call, -1 where the
// kernel does not take it: part_s, part_i, then pair_cnt (B * P), 4 bytes
// an element. key_dtype: 0 = float32, 1 = bfloat16, 2 = int8. grouped != 0:
// the call passes a probe (B, P) and buckets (C, cap); else P, C and cap
// are not read.
long long ivf_topk_scratch_bytes(int key_dtype, int grouped, int B, int N, int M, int d, int k,
                                 int P, int C, int cap) {
  Params a = call_params(B, N, M, d, k, P, C, cap);
  if (!plan(a, grouped != 0, key_dtype)) return -1;
  return 4 * (2 * list_entries(a) + (long long)a.B * a.P);
}

// Returns the cudaError_t of its launches (0 on success). cand is (B, M)
// int32, row-major. With probe (B, P) and buckets (C, cap) int32, M == P *
// cap (the grouped form); with both null, P, C and cap are not read (groups
// of one, see plan). scratch holds ivf_topk_scratch_bytes bytes.
int ivf_topk_launch(const void* q, const void* keys, int key_dtype, const void* cand,
                    const void* probe, const void* buckets, int B, int N, int M, int d, int k,
                    int P, int C, int cap, void* scratch, void* out_s, void* out_i,
                    void* stream) {
  Params a = call_params(B, N, M, d, k, P, C, cap);
  if ((probe == nullptr) != (buckets == nullptr) || !plan(a, probe != nullptr, key_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = static_cast<const float*>(q);
  a.keys = keys;
  a.cand = static_cast<const int*>(cand);
  a.probe = static_cast<const int*>(probe);
  a.buckets = static_cast<const int*>(buckets);
  a.part_s = static_cast<float*>(scratch);
  a.part_i = reinterpret_cast<int*>(a.part_s + list_entries(a));
  a.pair_cnt = a.part_i + list_entries(a);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (key_dtype) {
    case 0:
      return static_cast<int>(launch_keys<float>(a, os, oi, st));
    case 1:
      return static_cast<int>(launch_keys<__nv_bfloat16>(a, os, oi, st));
    default:  // 2, as plan checked
      return static_cast<int>(launch_keys<int8_t>(a, os, oi, st));
  }
}

const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
