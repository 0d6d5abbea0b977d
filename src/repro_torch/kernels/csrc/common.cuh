// Device helpers shared by the port's kernels: the O3 rank of one code row
// (binary_ip.cu bit by bit; cluster_scan.cu and beam_search.cu through
// per-lane partial-sum tables, `build_tables` / `table_sum`; all three end
// in `o3_rank`), the rank policies of beam_search.cu and cluster_scan.cu
// (`O3Policy`, `HammingPolicy`, `ExactPolicy`: the three ranking backends),
// the 64-bit key sort in shared memory (the block routes of topk_select.cu
// and merge_topk.cu, cluster_scan.cu) and the one-warp row selection of
// their warp routes (`lane_sort`, `warp_select`, `write_selected`). Each .cu
// file includes this header once; _build.py hashes it into every kernel's
// library name, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

// The dynamic shared memory an H100 block may take (227 KB), the limit of
// cluster_scan.cu's top-EF slots and of beam_search.cu's lanes a block.
constexpr int kMaxSmem = 232448;

// Order-preserving key of a float: -0.0 ties with +0.0 and every NaN sorts
// after +inf, which is the order of a stable torch.sort.
__device__ __forceinline__ uint32_t float_key(float d) {
  if (isnan(d)) return 0xFFFFFFFFu;
  if (d == 0.0f) d = 0.0f;  // -0.0 ties with +0.0
  const uint32_t u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The key of +inf: a pad, a later duplicate (masked to +inf) and a real +inf
// all carry it, and all come out as (+inf, id -1).
constexpr uint32_t kInfKey = 0xFF800000u;

// The selection kernels' warp route: one warp a row, kSelectWarps rows a
// block, each lane holding R <= 32 slots of the row (columns lane, lane +
// 32, ...), so a row of up to kSelectWarpMaxC columns; k <= kSelectWarpMaxK
// (one output slot a lane). Wider rows or a larger k take the block route.
constexpr int kSelectWarps = 4;
constexpr int kSelectWarpMaxC = 1024;
constexpr int kSelectWarpMaxK = 32;

// Ascending sort of one lane's R keys in registers: a bitonic network over
// the next power of two P >= R, unrolled at compile time, the slots from R
// on all ones. Those are constants, so every compare-exchange that meets
// one folds away; no shared memory and no shuffle.
template <int R>
__device__ __forceinline__ void lane_sort(unsigned long long (&v)[R]) {
  constexpr int P =
      R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32;
  unsigned long long w[P];
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = i < R ? v[i] : ~0ull;
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = w[i], b = w[l];
          const bool swap = ((i & k) == 0) ? (a > b) : (a < b);
          w[i] = swap ? b : a;
          w[l] = swap ? a : b;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = w[i];
}

// The k (<= 32) smallest of a warp's 32 R keys, each lane's R keys sorted
// ascending: k rounds of a butterfly minimum over the lanes' heads (five
// 64-bit shuffles); the lane whose head won drops it, shifting its keys
// down. Real keys are unique (the column is their low word), so one lane
// wins a round. Lane j < k returns the j-th smallest key, the others ~0.
template <int R>
__device__ __forceinline__ unsigned long long warp_select(
    unsigned long long (&v)[R], int k) {
  const int lane = threadIdx.x & 31;
  unsigned long long mine = ~0ull;
  for (int j = 0; j < k; ++j) {
    unsigned long long m = v[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long x = __shfl_xor_sync(0xFFFFFFFFu, m, o);
      m = x < m ? x : m;
    }
    if (v[0] == m) {
#pragma unroll
      for (int r = 0; r + 1 < R; ++r) v[r] = v[r + 1];
      v[R - 1] = ~0ull;
    }
    if (lane == j) mine = m;
  }
  return mine;
}

// One output slot from its selected key (the column is the key's low
// word): a key at +inf writes (+inf, -1); any other writes the row's own
// distance, and its id where that distance is finite (-1 beside -inf or
// NaN), as the plain versions do.
__device__ __forceinline__ void write_selected(unsigned long long key,
                                               const int32_t* rid,
                                               const float* rd, int32_t* oid,
                                               float* od) {
  if (static_cast<uint32_t>(key >> 32) == kInfKey) {
    *od = INFINITY;
    *oid = -1;
    return;
  }
  const int col = static_cast<int>(key & 0xFFFFFFFFull);
  const float d = rd[col];
  *od = d;
  *oid = isfinite(d) ? rid[col] : -1;
}

// The least power of two >= n (host code: launch sizes).
inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// `return CALL(R);` with R the slots a lane holds on the warp route: the
// least of 1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 32 with 32 R >= c. CALL is a
// macro of one argument; each R is one instantiation of a warp kernel.
#define DISPATCH_LANE_SLOTS(c, CALL) \
  if ((c) <= 32) return CALL(1);     \
  if ((c) <= 64) return CALL(2);     \
  if ((c) <= 96) return CALL(3);     \
  if ((c) <= 128) return CALL(4);    \
  if ((c) <= 192) return CALL(6);    \
  if ((c) <= 256) return CALL(8);    \
  if ((c) <= 320) return CALL(10);   \
  if ((c) <= 384) return CALL(12);   \
  if ((c) <= 512) return CALL(16);   \
  if ((c) <= 768) return CALL(24);   \
  return CALL(32);

// Ascending bitonic sort of p (a power of two) keys in shared memory by all
// threads of the block. Ends with a barrier.
__device__ void bitonic_sort(unsigned long long* key, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = key[i], b = key[ixj];
          const bool ascending = (i & k) == 0;
          if ((a > b) == ascending) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ uint32_t lut_sum_word(uint32_t word,
                                                 const int32_t* lut) {
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    s += static_cast<uint32_t>(lut[j]) & (0u - ((word >> j) & 1u));
  }
  return s;
}

// S = sum of lut[d] over the set bits d of one W-byte code row, modulo
// 2^32. vec16: the row starts on a 16-byte boundary and W % 16 == 0.
__device__ __forceinline__ uint32_t code_lut_sum(const uint8_t* c,
                                                 const int32_t* lt, int w,
                                                 int vec16) {
  uint32_t s = 0;
  if (vec16) {
    for (int b = 0; b < w; b += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(c + b);
      s += lut_sum_word(v.x, lt + 8 * b);
      s += lut_sum_word(v.y, lt + 8 * b + 32);
      s += lut_sum_word(v.z, lt + 8 * b + 64);
      s += lut_sum_word(v.w, lt + 8 * b + 96);
    }
  } else {
    for (int b = 0; b < w; ++b) {
      const uint32_t byte = c[b];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += static_cast<uint32_t>(lt[8 * b + j]) & (0u - ((byte >> j) & 1u));
      }
    }
  }
  return s;
}

// Per-lane partial-sum tables of a LUT `lut` (8W int32, entries at or past
// dim zeroed), built by the threads t, t + nt, ... of a block or a warp.
// Byte tables: entry (b, x) at b * 256 + x sums lut[8b + j] over the set
// bits j of x, W * 256 entries. Nibble tables: entry (h = 2b + half, x) at
// h * 16 + x sums lut[8b + 4 half + j], W * 32 entries. Sums are uint32,
// modulo 2^32, so a row's table sum equals its bit-by-bit sum bitwise.
template <bool kNibble>
__device__ __forceinline__ void build_tables(uint32_t* tab,
                                             const int32_t* lut, int w,
                                             int t, int nt) {
  for (int i = t; i < (kNibble ? w * 32 : w * 256); i += nt) {
    const int x = kNibble ? (i & 15) : (i & 255);
    const int32_t* l = lut + (kNibble ? 4 * (i >> 4) : 8 * (i >> 8));
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < (kNibble ? 4 : 8); ++j) {
      if ((x >> j) & 1) s += static_cast<uint32_t>(l[j]);
    }
    tab[i] = s;
  }
}

// The table sum of code byte x at byte position b of the tables t.
template <bool kNibble>
__device__ __forceinline__ uint32_t table_lookup(const uint32_t* t, int b,
                                                 uint32_t x) {
  if (kNibble) return t[b * 32 + (x & 15u)] + t[b * 32 + 16 + (x >> 4)];
  return t[b * 256 + x];
}

// S of one code row. On the vec16 path each 16-byte chunk's tables start at
// a pointer of their own, so a lookup is one byte extraction (PRMT), one
// address (LEA) and a load at a constant offset.
template <bool kNibble>
__device__ __forceinline__ uint32_t table_sum(const uint8_t* c,
                                              const uint32_t* tab, int w,
                                              int vec16) {
  uint32_t s = 0;
  if (vec16) {
    for (int b = 0; b < w; b += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(c + b);
      const uint32_t word[4] = {v.x, v.y, v.z, v.w};
      const uint32_t* t = tab + b * (kNibble ? 32 : 256);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s += table_lookup<kNibble>(t, 4 * k + i,
                                     __byte_perm(word[k], 0, 0x4440 + i));
        }
      }
    }
  } else {
    for (int b = 0; b < w; ++b) s += table_lookup<kNibble>(tab, b, c[b]);
  }
  return s;
}

__device__ __forceinline__ int32_t shift_right(int32_t t, int32_t s) {
  // an XLA shift by an amount outside [0, 31] fills with the sign bit
  const int32_t a = (s < 0 || s > 31) ? 31 : s;
  return t >> a;
}

// The O3 epilogue in uint32, so every overflow wraps as the int32
// reference does without signed-overflow UB:
//   t = 2 S - sumq;  t' = t + (t >> s1) [+ (t >> s2) unless s2 >= 31]
//   rank = f_add - t'
__device__ __forceinline__ int32_t o3_rank(uint32_t s, int32_t f_add,
                                           int32_t sumq, int32_t s1,
                                           int32_t s2) {
  const int32_t t = static_cast<int32_t>(2u * s - static_cast<uint32_t>(sumq));
  const uint32_t third =
      s2 >= 31 ? 0u : static_cast<uint32_t>(shift_right(t, s2 < 30 ? s2 : 30));
  const uint32_t tp = static_cast<uint32_t>(t) +
                      static_cast<uint32_t>(shift_right(t, s1)) + third;
  return static_cast<int32_t>(static_cast<uint32_t>(f_add) - tp);
}

// ---------------------------------------------------------------------------
// Rank policies of beam_search.cu and cluster_scan.cu: how a lane ranks one
// code row (semantics: repro_torch/kernels/ref.py `row_ranker`). kO3
// (mulfree) and kHamming give int32 ranks, kExact float32. A policy P gives
//   P::Rank, P::pad()         the rank type and the rank of an invalid row,
//                             after every real one;
//   P::kFloat                 whether the rank is a float;
//   P::stage_bytes(w),        the bytes of the lane's staging area (its LUT,
//   P::table_bytes(w)         read once) and of its table in shared memory
//                             (each 16-byte aligned by the caller);
//   P::stage(...),            the lane's operands into the staging area (or
//   P::build(...)             the table), then the table from them, by the
//                             threads t, t + nt, ...; the caller
//                             synchronises after each;
//   P(args, lane, table)      the lane's scalars and table;
//   rank(row, g, w, vec16)    the rank of code row g, `row` its W bytes
//                             (vec16: the row starts on a 16-byte boundary
//                             and W % 16 == 0).
// ---------------------------------------------------------------------------

enum RankKind { kO3 = 0, kHamming = 1, kExact = 2 };  // ranks.KIND_IDS

// The launch's rank operands (kernels/ranks.py `pointers`).
struct RankArgs {
  const void* node0;  // O3: f_add (T,) int32; exact: residual_norm (T,) f32
  const void* node1;  // exact: cos_theta (T,) f32
  const void* lut;    // O3: (L, 8W) int32; exact: (L, 8W) f32;
                      // hamming: the qcode (L, W) uint8
  const void* lane0;  // O3: sumq (L,) int32; exact: sum_lut (L,) f32
  const void* lane1;  // O3: s1 (L,) int32; exact: query_norm (L,) f32
  const void* lane2;  // O3: s2 (L,) int32
  float sqrt_dim;     // exact: sqrt(float32(D)), rounded on the host
};

// O3, through the lane's uint32 partial-sum tables (byte or nibble).
template <bool kNibble>
struct O3Policy {
  using Rank = int32_t;
  static constexpr bool kFloat = false;
  __host__ __device__ static long long stage_bytes(int w) { return 32LL * w; }
  __host__ __device__ static long long table_bytes(int w) {
    return (kNibble ? 128LL : 1024LL) * w;
  }
  __device__ static Rank pad() { return INT32_MAX; }
  // the LUT, entries at or past dim zeroed
  __device__ static void stage(const RankArgs& a, long long lane, int w,
                               int dim, void* stage, void*, int t, int nt) {
    int32_t* s = static_cast<int32_t*>(stage);
    const int32_t* lut = static_cast<const int32_t*>(a.lut) + lane * 8 * w;
    for (int i = t; i < 8 * w; i += nt) s[i] = i < dim ? lut[i] : 0;
  }
  __device__ static void build(void* tab, const void* stage, int w, int t,
                               int nt) {
    build_tables<kNibble>(static_cast<uint32_t*>(tab),
                          static_cast<const int32_t*>(stage), w, t, nt);
  }
  const uint32_t* tab;
  const int32_t* f_add;
  int32_t sq, a1, a2;
  __device__ O3Policy(const RankArgs& a, long long lane, const void* t)
      : tab(static_cast<const uint32_t*>(t)),
        f_add(static_cast<const int32_t*>(a.node0)),
        sq(static_cast<const int32_t*>(a.lane0)[lane]),
        a1(static_cast<const int32_t*>(a.lane1)[lane]),
        a2(static_cast<const int32_t*>(a.lane2)[lane]) {}
  __device__ __forceinline__ Rank rank(const uint8_t* row, long long g,
                                       int w, int vec16) const {
    return o3_rank(table_sum<kNibble>(row, tab, w, vec16), f_add[g], sq, a1,
                   a2);
  }
};

// Hamming: the popcount of code XOR qcode, the qcode (W bytes, zero-padded
// to 16) held in the table; 32-bit words where the row is 4-byte aligned,
// then a byte tail (W % 4 != 0).
struct HammingPolicy {
  using Rank = int32_t;
  static constexpr bool kFloat = false;
  __host__ __device__ static long long stage_bytes(int) { return 0; }
  __host__ __device__ static long long table_bytes(int w) {
    return (w + 15) / 16 * 16LL;
  }
  __device__ static Rank pad() { return INT32_MAX; }
  __device__ static void stage(const RankArgs& a, long long lane, int w, int,
                               void*, void* tab, int t, int nt) {
    uint8_t* q = static_cast<uint8_t*>(tab);
    const uint8_t* src = static_cast<const uint8_t*>(a.lut) + lane * w;
    for (int i = t; i < (w + 15) / 16 * 16; i += nt) q[i] = i < w ? src[i] : 0;
  }
  __device__ static void build(void*, const void*, int, int, int) {}
  const uint8_t* q;
  __device__ HammingPolicy(const RankArgs&, long long, const void* t)
      : q(static_cast<const uint8_t*>(t)) {}
  __device__ __forceinline__ Rank rank(const uint8_t* row, long long, int w,
                                       int vec16) const {
    int32_t s = 0;
    int b = 0;
    if (vec16) {
      for (; b < w; b += 16) {
        const uint4 c = *reinterpret_cast<const uint4*>(row + b);
        const uint4 x = *reinterpret_cast<const uint4*>(q + b);
        s += __popc(c.x ^ x.x) + __popc(c.y ^ x.y) + __popc(c.z ^ x.z) +
             __popc(c.w ^ x.w);
      }
    } else if ((reinterpret_cast<uintptr_t>(row) & 3) == 0) {
      for (; b + 4 <= w; b += 4) {
        s += __popc(*reinterpret_cast<const uint32_t*>(row + b) ^
                    *reinterpret_cast<const uint32_t*>(q + b));
      }
    }
    for (; b < w; ++b) s += __popc(static_cast<uint32_t>(row[b] ^ q[b]));
    return s;
  }
};

// The exact estimator's epilogue, each operation rounded to float32 (the
// build contracts a * b + c to an FMA unless told not to, which would move
// a rank by an ulp): ref.exact_rank_ref's order, JAX's estimate_sqdist.
// The result is never -0.0: rn rn + qn qn is +0.0 or more, and a - b of
// equal values rounds to +0.0.
__device__ __forceinline__ float exact_rank(float s, float rn, float c,
                                            float sum_lut, float qn,
                                            float sqrt_dim) {
  const float obar =
      __fdiv_rn(__fsub_rn(__fmul_rn(2.0f, s), sum_lut), sqrt_dim);
  const float floor_c = isnan(c) ? c : fmaxf(c, 1e-6f);
  const float est = __fdiv_rn(obar, floor_c);
  const float a = __fadd_rn(__fmul_rn(rn, rn), __fmul_rn(qn, qn));
  return __fsub_rn(a, __fmul_rn(__fmul_rn(__fmul_rn(2.0f, rn), qn), est));
}

// Exact: float nibble tables at every W (2W x 16 floats, 2 KB at W = 16),
// T[h][x] summed over the set bits of x in ascending order from +0.0; a row
// sums T[h][nibble h] over h = 0 .. 2W-1 in ascending order
// (ref.exact_tables, ref.exact_rank_ref), so it equals the plain version
// bit for bit.
struct ExactPolicy {
  using Rank = float;
  static constexpr bool kFloat = true;
  __host__ __device__ static long long stage_bytes(int w) { return 32LL * w; }
  __host__ __device__ static long long table_bytes(int w) { return 128LL * w; }
  __device__ static Rank pad() { return FLT_MAX; }
  __device__ static void stage(const RankArgs& a, long long lane, int w,
                               int dim, void* stage, void*, int t, int nt) {
    float* s = static_cast<float*>(stage);
    const float* lut = static_cast<const float*>(a.lut) + lane * 8 * w;
    for (int i = t; i < 8 * w; i += nt) s[i] = i < dim ? lut[i] : 0.0f;
  }
  __device__ static void build(void* tab, const void* stage, int w, int t,
                               int nt) {
    float* tb = static_cast<float*>(tab);
    const float* lut = static_cast<const float*>(stage);
    for (int i = t; i < 32 * w; i += nt) {
      const int x = i & 15;
      const float* l = lut + 4 * (i >> 4);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((x >> j) & 1) s = __fadd_rn(s, l[j]);
      }
      tb[i] = s;
    }
  }
  const float* tab;
  const float* rn;
  const float* cs;
  float sum_lut, qn, sqrt_dim;
  __device__ ExactPolicy(const RankArgs& a, long long lane, const void* t)
      : tab(static_cast<const float*>(t)),
        rn(static_cast<const float*>(a.node0)),
        cs(static_cast<const float*>(a.node1)),
        sum_lut(static_cast<const float*>(a.lane0)[lane]),
        qn(static_cast<const float*>(a.lane1)[lane]),
        sqrt_dim(a.sqrt_dim) {}
  __device__ __forceinline__ Rank rank(const uint8_t* row, long long g,
                                       int w, int vec16) const {
    float s = 0.0f;
    if (vec16) {
      for (int b = 0; b < w; b += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + b);
        const uint32_t word[4] = {v.x, v.y, v.z, v.w};
        const float* t = tab + b * 32;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t x = __byte_perm(word[k], 0, 0x4440 + i);
            const float* tj = t + (4 * k + i) * 32;
            s = __fadd_rn(s, tj[x & 15u]);
            s = __fadd_rn(s, tj[16 + (x >> 4)]);
          }
        }
      }
    } else {
      for (int b = 0; b < w; ++b) {
        const uint32_t x = row[b];
        s = __fadd_rn(s, tab[b * 32 + (x & 15u)]);
        s = __fadd_rn(s, tab[b * 32 + 16 + (x >> 4)]);
      }
    }
    return exact_rank(s, rn[g], cs[g], sum_lut, qn, sqrt_dim);
  }
};

// The order key of a float rank: ascending total order, -0.0 before +0.0,
// every NaN taken as the positive quiet NaN (after +inf; a negative NaN
// would otherwise sort first, where the plain versions put every NaN
// last). Invertible but for the NaN payload: `rank_of_key`.
// ref.float_order_key bit for bit.
constexpr uint32_t kNanKey = 0xFFC00000u;   // rank_order_key(NaN)
__device__ __forceinline__ uint32_t rank_order_key(float r) {
  const uint32_t u = isnan(r) ? 0x7FC00000u : __float_as_uint(r);
  return u ^ ((u & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float rank_of_key(uint32_t k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu));
}

}  // namespace
