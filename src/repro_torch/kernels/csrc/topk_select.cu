// topk_select: fused dedup (keep-first) + k-selection over rerank candidates.
//
// Replaces the Pallas TPU kernel `topk_select` (repro/kernels/topk_select.py,
// `topk_select` / `_topk_select_kernel`), whose semantics are
// repro/kernels/ref.py `topk_select_ref`: per query row of C candidate
// (id, dist) pairs, pads (id < 0) and every later occurrence of an id are
// masked to +inf, then the k smallest distances are taken with ties to the
// lower column; an output id is -1 where its distance is not finite.
//
// What bounds it on an H100: bytes, and at the rerank's shapes (Q = 1024,
// C = nprobe * ef = 320, k = 10) hardly anything: 8 bytes per candidate
// read and 8 per output written, one table probe and one compare a slot.
// What held the first design back was not work but waiting: two block-wide
// bitonic sorts of the whole row, ~90 block barriers to emit 10 slots, and
// 36 KB of static shared memory a block, so 1,024 rows took two waves.
//
// Every slot is keyed (order-preserving bits of its masked distance,
// column) as a 64-bit integer (common.cuh `float_key`): -0.0 ties with
// +0.0, every NaN sorts after +inf, and a tie goes to the lower column.
// Two routes, chosen by the wrapper from (C, k) alone:
//
// Warp route (C <= kSelectWarpMaxC = 1024, k <= kSelectWarpMaxK = 32): one
// warp a row, kSelectWarps rows a block, no block barrier.
//   1. Each lane loads its R slots, columns lane + 32 r (coalesced); R is
//      set from C (common.cuh `DISPATCH_LANE_SLOTS`; 10 at C = 320).
//   2. Keep-first without a sort, in R steps r = 0, 1, ...: step r holds
//      columns 32 r to 32 r + 31, one a lane, so the steps run in column
//      order. Inside a step, __match_any_sync finds the lanes that share an
//      id; all but the lowest are later duplicates. The lowest then claims
//      its id in an open-addressed table of 2 pow2(C) int32 ids in shared
//      memory by atomicCAS: it finds the id already there exactly when an
//      earlier step, so an earlier column, holds it. A __syncwarp ends each
//      step, so the answer does not depend on the order of the atomics.
//      Why a table: it is one match, at most one CAS and a probe or two a
//      slot (load factor at most 1/2), whatever the data, where sorting
//      the row by (id, column), as the block route does or a warp register
//      sort would, takes C log2(C) (log2(C) + 1) / 4 compare-exchanges and,
//      for a warp sort, a shuffle for most of them. Tried on the H100 and
//      dropped: a 64-bit (id, column) table with atomicMin (slower, twice
//      the shared memory); and testing on demand only the popped keys
//      against the earlier columns (no faster on rerank-like rows, and a
//      round for every duplicate that ranks in the top k, so many times
//      slower on rows of few distinct ids).
//   3. Each lane sorts its R keys in registers (common.cuh `lane_sort`).
//   4. k rounds of a warp minimum over the lanes' heads (`warp_select`);
//      lane j writes output slot j (`write_selected`).
//
// Block route (the rest, up to kMaxC = 4096 columns): one block a row, the
// row's C slots padded to P = next power of two as keys in dynamic shared
// memory sized from C (P 8 bytes + C flags).
//   1. key = (id with its sign bit flipped, column): one bitonic sort
//      groups equal ids with the earliest column first; a slot whose id
//      equals its predecessor's is a later duplicate and flagged bad.
//   2. key = (masked distance, column) as above; a second bitonic sort.
//   3. the first k slots are written out.
// The wrapper takes wider rows in passes (topk_select.chunked_select).

#include "common.cuh"

namespace {

constexpr int kMaxC = 4096;
constexpr int kThreads = 256;
constexpr int kRouteWarp = 0;
constexpr int kRouteBlock = 1;
constexpr int32_t kEmpty = -1;  // a table slot no real id (>= 0) holds

__device__ __forceinline__ uint32_t table_slot(int32_t id, int log2t) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> (32 - log2t);
}

template <int R>
__global__ void __launch_bounds__(kSelectWarps * 32)
topk_warp_kernel(const int32_t* __restrict__ ids,
                 const float* __restrict__ dists, int32_t* __restrict__ out_ids,
                 float* __restrict__ out_d, int n_rows, int c, int k,
                 int log2t) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q = static_cast<size_t>(blockIdx.x) * kSelectWarps + warp;
  if (q >= static_cast<size_t>(n_rows)) return;  // the whole warp
  const int t = 1 << log2t;
  int32_t* tab = smem + warp * t;
  const int32_t* rid = ids + q * c;
  const float* rd = dists + q * c;

  for (int i = lane; i < t; i += 32) tab[i] = kEmpty;
  int32_t id[R];
  float d[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int col = 32 * r + lane;
    id[r] = col < c ? rid[col] : -1;
    d[r] = col < c ? rd[col] : 0.0f;
  }
  __syncwarp();

  unsigned long long v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int col = 32 * r + lane;
    if (32 * r >= c) {  // the same for the whole warp
      v[r] = ~0ull;     // sorts after every real slot
      continue;
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, id[r]);
    bool bad = id[r] < 0 || __ffs(same) - 1 != lane;
    if (!bad) {
      uint32_t h = table_slot(id[r], log2t);
      while (true) {
        const int32_t prev = atomicCAS(tab + h, kEmpty, id[r]);
        if (prev == kEmpty) break;  // the first occurrence
        if (prev == id[r]) {        // an earlier step holds it
          bad = true;
          break;
        }
        h = (h + 1) & (t - 1);
      }
    }
    __syncwarp();
    v[r] = col < c
               ? (static_cast<unsigned long long>(
                      float_key(bad ? INFINITY : d[r])) << 32) |
                     static_cast<uint32_t>(col)
               : ~0ull;
  }
  lane_sort<R>(v);
  const unsigned long long mine = warp_select<R>(v, k);
  if (lane < k) {
    write_selected(mine, rid, rd, out_ids + q * k + lane,
                   out_d + q * k + lane);
  }
}

__global__ void topk_block_kernel(const int32_t* __restrict__ ids,
                                  const float* __restrict__ dists,
                                  int32_t* __restrict__ out_ids,
                                  float* __restrict__ out_d, int c, int p,
                                  int k) {
  extern __shared__ unsigned long long key[];  // p keys, then c flags
  uint8_t* bad = reinterpret_cast<uint8_t*>(key + p);
  const size_t q = blockIdx.x;
  const int32_t* rid = ids + q * c;
  const float* rd = dists + q * c;

  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    if (i < c) {
      const int32_t id = rid[i];
      bad[i] = id < 0;
      key[i] = (static_cast<unsigned long long>(
                    static_cast<uint32_t>(id) ^ 0x80000000u) << 32) |
               static_cast<uint32_t>(i);
    } else {
      key[i] = ~0ull;  // pad slots sort after every real one
    }
  }
  __syncthreads();
  bitonic_sort(key, p);

  // sorted slots [0, c) are exactly the real ones
  for (int i = threadIdx.x + 1; i < c; i += blockDim.x) {
    if ((key[i] >> 32) == (key[i - 1] >> 32)) {
      bad[key[i] & 0xFFFFFFFFull] = 1;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    if (i < c) {
      const float d = bad[i] ? INFINITY : rd[i];
      key[i] = (static_cast<unsigned long long>(float_key(d)) << 32) |
               static_cast<uint32_t>(i);
    } else {
      key[i] = ~0ull;
    }
  }
  __syncthreads();
  bitonic_sort(key, p);

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int col = static_cast<int>(key[j] & 0xFFFFFFFFull);
    const float d = bad[col] ? INFINITY : rd[col];
    out_d[q * k + j] = d;
    out_ids[q * k + j] = isfinite(d) ? rid[col] : -1;
  }
}

// log2 of the warp route's table entries a row: 2 pow2(C), at least 2.
int table_log2(int c) {
  int l = 1;
  while ((1 << l) < 2 * pow2_at_least(c)) ++l;
  return l;
}

template <int R>
int launch_warp(const void* ids, const void* dists, void* out_ids,
                void* out_d, int n_rows, int c, int k, cudaStream_t stream) {
  const int log2t = table_log2(c);
  const int blocks = (n_rows + kSelectWarps - 1) / kSelectWarps;
  topk_warp_kernel<R><<<blocks, kSelectWarps * 32,
                        kSelectWarps * (4 << log2t), stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(dists),
      static_cast<int32_t*>(out_ids), static_cast<float*>(out_d), n_rows, c,
      k, log2t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int topk_select_max_c() { return kMaxC; }
extern "C" int topk_select_warp_max_c() { return kSelectWarpMaxC; }
extern "C" int topk_select_warp_max_k() { return kSelectWarpMaxK; }

// Dynamic shared memory of one block of `route` at row width c.
extern "C" int topk_select_smem_bytes(int c, int route) {
  return route == kRouteWarp ? kSelectWarps * (4 << table_log2(c))
                             : pow2_at_least(c) * 8 + c;
}

extern "C" int topk_select_launch(const void* ids, const void* dists,
                                  void* out_ids, void* out_d, int n_rows,
                                  int c, int k, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || k < 1 || k > c) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWarp) {
    if (c > kSelectWarpMaxC || k > kSelectWarpMaxK) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#define LAUNCH(R) \
  launch_warp<R>(ids, dists, out_ids, out_d, n_rows, c, k, s)
    DISPATCH_LANE_SLOTS(c, LAUNCH)
#undef LAUNCH
  }
  if (route != kRouteBlock || c > kMaxC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = pow2_at_least(c);
  topk_block_kernel<<<n_rows, kThreads, p * 8 + c, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(dists),
      static_cast<int32_t*>(out_ids), static_cast<float*>(out_d), c, p, k);
  return static_cast<int>(cudaGetLastError());
}
