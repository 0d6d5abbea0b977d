// Device helpers shared by the port's kernels: the O3 rank of one code row
// (binary_ip.cu bit by bit; cluster_scan.cu and beam_search.cu through
// per-lane partial-sum tables, `build_tables` / `table_sum`; all three end
// in `o3_rank`) and the 64-bit key sort in shared memory (topk_select.cu,
// merge_topk.cu, cluster_scan.cu). Each .cu file includes
// this header once; _build.py hashes it into every kernel's library name,
// so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
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

}  // namespace
