// merge_topk: the sharded tier's origin merge, k-selection over the owners'
// partial top-k runs.
//
// Replaces the Pallas TPU kernel `merge_topk` (repro/kernels/topk_select.py,
// `merge_topk` / `_merge_topk_kernel`), whose semantics are
// repro/kernels/ref.py `merge_topk_ref` (the port's plain version:
// repro_torch/kernels/ref.py `merge_topk_ref`): per query row of W = O * run
// (id, dist) slots, the k smallest distances with ties to the lower column;
// an output id is -1 where its distance is not finite. No dedup: the
// cluster partition keeps ids disjoint across runs.
//
// What bounds it on an H100: bytes, and at the origin merge's shapes
// (Q = 1024 queries, W = fanout * k = 80, k = 10) hardly anything: 8 bytes
// per slot read and 8 per output written, one compare a slot. The first
// design sorted each row with a block-wide bitonic sort (28 barriers for
// W = 80) in 32 KB of static shared memory, so 1,024 rows took two waves.
//
// Each slot is keyed (order-preserving bits of its distance, column), as in
// topk_select.cu (common.cuh `float_key`). The runs are not assumed sorted.
// Two routes, chosen by the wrapper from (W, k) alone:
//
// Warp route (W <= kSelectWarpMaxC = 1024, k <= kSelectWarpMaxK = 32): one
// warp a row, kSelectWarps rows a block, no shared memory and no barrier.
// Each lane loads R slots (columns lane + 32 r, coalesced; R set from W
// by common.cuh's `DISPATCH_LANE_SLOTS`, 3 at W = 80), sorts them in
// registers (`lane_sort`), and k rounds of a warp minimum over the lanes'
// heads (`warp_select`) give the k best; lane j writes output slot j.
//
// Block route (the rest, up to kMaxW = 4096 slots): one block a row, the
// row padded to P = next power of two keys in dynamic shared memory sized
// from W (8 P bytes), one bitonic sort, the first k written out. The
// wrapper takes wider rows as a tree of launches (merge_topk.merge_tree).

#include "common.cuh"

namespace {

constexpr int kMaxW = 4096;
constexpr int kRouteWarp = 0;
constexpr int kRouteBlock = 1;

template <int R>
__global__ void __launch_bounds__(kSelectWarps * 32)
merge_warp_kernel(const int32_t* __restrict__ ids,
                  const float* __restrict__ dists,
                  int32_t* __restrict__ out_ids, float* __restrict__ out_d,
                  int n_rows, int w, int k) {
  const int lane = threadIdx.x & 31;
  const size_t q =
      static_cast<size_t>(blockIdx.x) * kSelectWarps + (threadIdx.x >> 5);
  if (q >= static_cast<size_t>(n_rows)) return;  // the whole warp
  const int32_t* rid = ids + q * w;
  const float* rd = dists + q * w;
  unsigned long long v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t col = 32u * r + lane;
    v[r] = col < static_cast<uint32_t>(w)
               ? (static_cast<unsigned long long>(float_key(rd[col])) << 32) |
                     col
               : ~0ull;  // sorts after every real slot
  }
  lane_sort<R>(v);
  const unsigned long long mine = warp_select<R>(v, k);
  if (lane < k) {
    write_selected(mine, rid, rd, out_ids + q * k + lane,
                   out_d + q * k + lane);
  }
}

__global__ void merge_block_kernel(const int32_t* __restrict__ ids,
                                   const float* __restrict__ dists,
                                   int32_t* __restrict__ out_ids,
                                   float* __restrict__ out_d, int w, int p,
                                   int k) {
  extern __shared__ unsigned long long key[];
  const size_t q = blockIdx.x;
  const int32_t* rid = ids + q * w;
  const float* rd = dists + q * w;

  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    key[i] = i < w ? (static_cast<unsigned long long>(float_key(rd[i])) << 32) |
                         static_cast<uint32_t>(i)
                   : ~0ull;  // pad slots sort after every real one
  }
  __syncthreads();
  bitonic_sort(key, p);

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int col = static_cast<int>(key[j] & 0xFFFFFFFFull);
    const float d = rd[col];
    out_d[q * k + j] = d;
    out_ids[q * k + j] = isfinite(d) ? rid[col] : -1;
  }
}

template <int R>
int launch_warp(const void* ids, const void* dists, void* out_ids,
                void* out_d, int n_rows, int w, int k, cudaStream_t stream) {
  const int blocks = (n_rows + kSelectWarps - 1) / kSelectWarps;
  merge_warp_kernel<R><<<blocks, kSelectWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(dists),
      static_cast<int32_t*>(out_ids), static_cast<float*>(out_d), n_rows, w,
      k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int merge_topk_max_w() { return kMaxW; }

// Dynamic shared memory of one block of `route` at row width w.
extern "C" int merge_topk_smem_bytes(int w, int route) {
  return route == kRouteWarp ? 0 : 8 * pow2_at_least(w);
}

extern "C" int merge_topk_launch(const void* ids, const void* dists,
                                 void* out_ids, void* out_d, int n_rows,
                                 int w, int k, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 1 || k < 1 || k > w) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWarp) {
    if (w > kSelectWarpMaxC || k > kSelectWarpMaxK) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#define LAUNCH(R) \
  launch_warp<R>(ids, dists, out_ids, out_d, n_rows, w, k, s)
    DISPATCH_LANE_SLOTS(w, LAUNCH)
#undef LAUNCH
  }
  if (route != kRouteBlock || w > kMaxW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = pow2_at_least(w);
  // one compare-exchange pair per thread and stage, 32 to 256 threads
  int threads = p / 2;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  merge_block_kernel<<<n_rows, threads, 8 * p, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(dists),
      static_cast<int32_t*>(out_ids), static_cast<float*>(out_d), w, p, k);
  return static_cast<int>(cudaGetLastError());
}
