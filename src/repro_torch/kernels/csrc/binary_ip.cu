// binary_ip_rank: the O3 multiplication-free rank, lane-batched gather form.
//
// Replaces the Pallas TPU kernel `binary_ip_rank` (repro/kernels/binary_ip.py,
// `binary_ip_rank` / `_binary_ip_kernel`). That kernel ranks one contiguous
// block of N code rows against ONE lane's LUT as an MXU matmul in f32. Here
// one launch ranks every lane of a beam hop at once: lane l ranks the rows
// rows[l, :] of the flattened placed code table, against its own LUT.
//
//   S   = sum of lut[l, d] over the set bits d < dim of codes[row]
//   t   = 2 S - sumq[l]
//   t'  = t + (t >> s1[l]) + (s2[l] < 31 ? t >> s2[l] : 0)
//   out = f_add[row] - t'                  (INT_MAX where row < 0)
//
// What bounds it on an H100: bytes. Each ranked row needs its W code bytes,
// its f_add and its row id, and writes one int32, for dim integer adds: at
// D = 128 that is 28 bytes against 128 adds, far below the card's ridge.
// The LUTs (Dpad int32 per lane) are the other large input.
//
// The simple design: a block takes `lanes_per_block` lanes and stages their
// LUTs in shared memory (entries at or past `dim` are zeroed there, so the
// padding bits of a code never count); each thread ranks one (lane, row)
// pair, loading its code with 16-byte vector loads when rows are 16-byte
// aligned, and sums the LUT over the set bits. Threads of a warp share a
// lane, so their LUT reads are broadcasts. S is accumulated in 32-bit
// unsigned integers (exact modulo 2^32, where the Pallas kernel's f32 sum is
// exact only below 2^24) and the epilogue runs in uint32_t, so every
// overflow wraps as the int32 reference does without signed-overflow UB.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void binary_ip_rank_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ f_add,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ lut,
    const int32_t* __restrict__ sumq, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, int32_t* __restrict__ out,
    int n_lanes, int n_rows, int w, int dim, int lanes_per_block,
    long long n_table, int vec16) {
  extern __shared__ int32_t s_lut[];
  const int dpad = w * 8;
  const int lane0 = blockIdx.x * lanes_per_block;
  const int nl = min(lanes_per_block, n_lanes - lane0);

  for (int i = threadIdx.x; i < nl * dpad; i += blockDim.x) {
    const int d = i % dpad;
    s_lut[i] = d < dim ? lut[static_cast<size_t>(lane0) * dpad + i] : 0;
  }
  __syncthreads();

  const int total = nl * n_rows;
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
    const int l = p / n_rows;
    const int lane = lane0 + l;
    const size_t o = static_cast<size_t>(lane) * n_rows + (p - l * n_rows);
    const int32_t row = rows[o];
    if (row < 0) {
      out[o] = INT32_MAX;
      continue;
    }
    const long long r = row < n_table ? row : n_table - 1;
    const int32_t* lt = s_lut + l * dpad;
    const uint32_t s = code_lut_sum(codes + static_cast<size_t>(r) * w, lt, w,
                                    vec16);
    out[o] = o3_rank(s, f_add[r], sumq[lane], s1[lane], s2[lane]);
  }
}

}  // namespace

extern "C" int binary_ip_rank_launch(
    const void* codes, const void* f_add, const void* rows, const void* lut,
    const void* sumq, const void* s1, const void* s2, void* out,
    int n_lanes, int n_rows, int w, int dim, long long n_table, int vec16,
    void* stream) {
  // enough lanes per block that a block holds ~kThreads (lane, row) pairs
  // and no more than fit the default 48 KB of shared memory
  int lanes_per_block = kThreads / (n_rows > 0 ? n_rows : 1);
  const int fit = static_cast<int>(48 * 1024 / (w * 8 * sizeof(int32_t)));
  if (lanes_per_block > fit) lanes_per_block = fit;
  if (lanes_per_block < 1) lanes_per_block = 1;
  if (lanes_per_block > n_lanes) lanes_per_block = n_lanes;
  const size_t smem = static_cast<size_t>(lanes_per_block) * w * 8 *
                      sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        binary_ip_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n_lanes + lanes_per_block - 1) / lanes_per_block;
  binary_ip_rank_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(f_add),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(lut),
      static_cast<const int32_t*>(sumq), static_cast<const int32_t*>(s1),
      static_cast<const int32_t*>(s2), static_cast<int32_t*>(out), n_lanes,
      n_rows, w, dim, lanes_per_block, n_table, vec16);
  return static_cast<int>(cudaGetLastError());
}
