// cluster_scan: the GEMV-mode scan, a fused whole-cluster O3 rank plus a
// running top-EF, for every lane of a search in one launch.
//
// Replaces the Pallas TPU kernel `cluster_scan` (repro/kernels/binary_ip.py,
// `cluster_scan` / `_cluster_scan_kernel`), which scans ONE cluster per call.
// Semantics: repro_torch/kernels/ref.py `cluster_scan_ref`, which is the
// order of the path it serves (repro/core/beam_search.py `full_scan_lane`,
// `lax.top_k` over the wrapped negated ranks): lane l ranks the rows
// [0, n_valid[l]) of its cluster, rows base_rows[l] + i of the flattened
// code table, exactly as binary_ip_rank does (uint32 sums, uint32
// epilogue, the s2 >= 31 guard); rows at n_valid or beyond rank INT_MAX
// without being read. Out come the EF best local row ids and their ranks
// in ascending rank, ties to the lower row, a rank of INT_MIN after
// INT_MAX (its negation wraps to itself). An inactive lane reads nothing
// and writes ids -1, ranks INT_MAX.
//
// What bounds it on an H100: operations. Each valid row costs its W code
// bytes and its f_add (20 bytes at D = 128) against a mask and an add per
// code bit (256 int32 operations), above the card's int32 ridge of about
// 5 operations per byte. The selection's compares come on top and stay in
// shared memory.
//
// The simple design: one block per lane. The lane's LUT sits in shared
// memory (entries at or past `dim` zeroed), beside kKeys = 4096 64-bit keys
// (32 KB): slots [0, EFp) hold the running top-EF (EFp = EF rounded up to a
// power of two), slots [EFp, 4096) the next chunk of rows. Each thread
// ranks rows of the chunk and writes its key (order key of the rank, row);
// one bitonic sort of the EFp + chunk keys then leaves the new top-EF in
// [0, EFp). Only rows [0, min(M, n_valid + EF)) take part: a pad row past
// n_valid + EF can never be among the EF best. After the last chunk the
// first EF keys are written out. Sorting the running top-EF again with
// every chunk, and sorting rows that a threshold would already reject, is
// the work a faster kernel would skip.

#include "common.cuh"

namespace {

constexpr int kKeys = 4096;
constexpr int kMaxEf = 1024;
constexpr int kMaxDpad = 2048;
constexpr int kThreads = 256;

// The path's rank order as a uint32: INT_MIN + 1 -> 0, ..., INT_MAX ->
// 0xFFFFFFFE, INT_MIN -> 0xFFFFFFFF.
__device__ __forceinline__ uint32_t rank_key(int32_t r) {
  return static_cast<uint32_t>(r) + 0x7FFFFFFFu;
}

__device__ __forceinline__ int32_t key_rank(uint32_t k) {
  return static_cast<int32_t>(k - 0x7FFFFFFFu);
}

__global__ void cluster_scan_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ f_add,
    const int32_t* __restrict__ base_rows, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ lut, const int32_t* __restrict__ sumq,
    const int32_t* __restrict__ s1, const int32_t* __restrict__ s2,
    const uint8_t* __restrict__ active, int32_t* __restrict__ out_ids,
    int32_t* __restrict__ out_ranks, int w, int dim, int ef, int ef_pad,
    int m, long long n_table, int vec16) {
  __shared__ unsigned long long key[kKeys];
  __shared__ int32_t s_lut[kMaxDpad];
  const size_t lane = blockIdx.x;
  int32_t* oid = out_ids + lane * ef;
  int32_t* ork = out_ranks + lane * ef;
  if (!active[lane]) {
    for (int j = threadIdx.x; j < ef; j += blockDim.x) {
      oid[j] = -1;
      ork[j] = INT32_MAX;
    }
    return;
  }

  const int dpad = w * 8;
  for (int i = threadIdx.x; i < dpad; i += blockDim.x) {
    s_lut[i] = i < dim ? lut[lane * dpad + i] : 0;
  }
  for (int i = threadIdx.x; i < ef_pad; i += blockDim.x) key[i] = ~0ull;
  __syncthreads();

  const int nv = min(max(n_valid[lane], 0), m);
  const int n_end = min(m, nv + ef);
  const long long base = base_rows[lane];
  const int32_t sq = sumq[lane], a1 = s1[lane], a2 = s2[lane];
  const int chunk = kKeys - ef_pad;
  for (int c0 = 0; c0 < n_end; c0 += chunk) {
    const int len = min(chunk, n_end - c0);
    int p = 1;
    while (p < ef_pad + len) p <<= 1;
    for (int i = threadIdx.x; i < p - ef_pad; i += blockDim.x) {
      unsigned long long k = ~0ull;
      if (i < len) {
        const int row = c0 + i;
        int32_t r = INT32_MAX;
        if (row < nv) {
          long long g = base + row;
          g = g < 0 ? 0 : (g < n_table ? g : n_table - 1);
          const uint32_t s = code_lut_sum(codes + static_cast<size_t>(g) * w,
                                          s_lut, w, vec16);
          r = o3_rank(s, f_add[g], sq, a1, a2);
        }
        k = (static_cast<unsigned long long>(rank_key(r)) << 32) |
            static_cast<uint32_t>(row);
      }
      key[ef_pad + i] = k;
    }
    __syncthreads();
    bitonic_sort(key, p);
  }

  for (int j = threadIdx.x; j < ef; j += blockDim.x) {
    const unsigned long long k = key[j];
    oid[j] = static_cast<int32_t>(k & 0xFFFFFFFFull);
    ork[j] = key_rank(static_cast<uint32_t>(k >> 32));
  }
}

}  // namespace

extern "C" int cluster_scan_max_ef() { return kMaxEf; }

extern "C" int cluster_scan_max_dpad() { return kMaxDpad; }

extern "C" int cluster_scan_launch(
    const void* codes, const void* f_add, const void* base_rows,
    const void* n_valid, const void* lut, const void* sumq, const void* s1,
    const void* s2, const void* active, void* out_ids, void* out_ranks,
    int n_lanes, int w, int dim, int ef, int m, long long n_table, int vec16,
    void* stream) {
  int ef_pad = 1;
  while (ef_pad < ef) ef_pad <<= 1;
  cluster_scan_kernel<<<n_lanes, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(f_add),
      static_cast<const int32_t*>(base_rows),
      static_cast<const int32_t*>(n_valid), static_cast<const int32_t*>(lut),
      static_cast<const int32_t*>(sumq), static_cast<const int32_t*>(s1),
      static_cast<const int32_t*>(s2), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(out_ids), static_cast<int32_t*>(out_ranks), w, dim,
      ef, ef_pad, m, n_table, vec16);
  return static_cast<int>(cudaGetLastError());
}
