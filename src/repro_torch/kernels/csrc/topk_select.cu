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
// read and 8 per output written. The sorting network's compares stay in
// shared memory.
//
// The simple design: one block per query row. The row's C slots, padded to
// P = next power of two, live in shared memory as 64-bit keys.
//   1. key = (id with its sign bit flipped, column): one bitonic sort
//      groups equal ids with the earliest column first; a slot whose id
//      equals its predecessor's is a later duplicate and flagged bad.
//   2. key = (order-preserving bits of the masked distance, column): a
//      second bitonic sort orders by (dist, column). -0.0 is folded into
//      +0.0 and every NaN into one value above +inf, which is the order
//      of the plain version's stable torch.sort.
//   3. the first k slots are written out.
// C is limited to kMaxC = 4096 by the static shared memory (32 KB of keys
// and 4 KB of flags); the wrapper raises for a wider row.

#include "common.cuh"

namespace {

constexpr int kMaxC = 4096;
constexpr int kThreads = 256;

__global__ void topk_select_kernel(const int32_t* __restrict__ ids,
                                   const float* __restrict__ dists,
                                   int32_t* __restrict__ out_ids,
                                   float* __restrict__ out_d, int c, int p,
                                   int k) {
  __shared__ unsigned long long key[kMaxC];
  __shared__ uint8_t bad[kMaxC];
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

}  // namespace

extern "C" int topk_select_max_c() { return kMaxC; }

extern "C" int topk_select_launch(const void* ids, const void* dists,
                                  void* out_ids, void* out_d, int n_rows,
                                  int c, int k, void* stream) {
  int p = 1;
  while (p < c) p <<= 1;
  topk_select_kernel<<<n_rows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(dists),
      static_cast<int32_t*>(out_ids), static_cast<float*>(out_d), c, p, k);
  return static_cast<int>(cudaGetLastError());
}
