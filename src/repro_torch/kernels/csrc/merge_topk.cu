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
// per slot read and 8 per output written. The sorting network's compares
// stay in shared memory.
//
// The simple design: one block per query row. The row's W slots, padded to
// P = next power of two, live in shared memory as 64-bit keys
// (order-preserving bits of the distance, column); one bitonic sort orders
// them by (dist, column) and the first k are written out. This is right
// whether or not the runs arrive sorted; merging the O sorted runs instead
// of sorting the row is later performance work. W is limited to kMaxW =
// 4096 by the static shared memory (32 KB); the wrapper raises for a wider
// row.

#include "common.cuh"

namespace {

constexpr int kMaxW = 4096;

__global__ void merge_topk_kernel(const int32_t* __restrict__ ids,
                                  const float* __restrict__ dists,
                                  int32_t* __restrict__ out_ids,
                                  float* __restrict__ out_d, int w, int p,
                                  int k) {
  __shared__ unsigned long long key[kMaxW];
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

}  // namespace

extern "C" int merge_topk_max_w() { return kMaxW; }

extern "C" int merge_topk_launch(const void* ids, const void* dists,
                                 void* out_ids, void* out_d, int n_rows,
                                 int w, int k, void* stream) {
  int p = 1;
  while (p < w) p <<= 1;
  // one compare-exchange pair per thread and stage, 32 to 256 threads
  int threads = p / 2;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  merge_topk_kernel<<<n_rows, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(dists),
      static_cast<int32_t*>(out_ids), static_cast<float*>(out_d), w, p, k);
  return static_cast<int>(cudaGetLastError());
}
