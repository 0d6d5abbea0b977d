// cluster_scan: the GEMV-mode scan, a fused whole-cluster rank plus a
// running top-EF, for every lane of a search in one launch, by one of three
// rank policies (common.cuh): O3 (mulfree), Hamming and Exact.
//
// Replaces the Pallas TPU kernel `cluster_scan` (repro/kernels/binary_ip.py,
// `cluster_scan` / `_cluster_scan_kernel`), which scans ONE cluster per call
// by the O3 rank; the JAX package scans the exact and hamming backends in
// plain jnp (`full_scan_lane` over `rank_cluster`), and this kernel carries
// them too. Semantics: repro_torch/kernels/ref.py `ranked_cluster_scan_ref`,
// which is the order of the path it serves (repro/core/beam_search.py
// `full_scan_lane`, `lax.top_k` over the negated ranks): lane l ranks the
// rows [0, n_valid[l]) of its cluster, rows base_rows[l] + i of the
// flattened code table, by its policy (O3 exactly as binary_ip_rank does:
// uint32 sums, uint32 epilogue, the s2 >= 31 guard); rows at n_valid or
// beyond rank the pad (INT_MAX, or F32_MAX for the exact rank) without
// being read. Out come the EF best local row ids and their ranks in
// ascending rank, ties to the lower row; an int32 rank of INT_MIN after
// INT_MAX (its negation wraps to itself), a float32 rank in total order
// (common.cuh `rank_order_key`: -0.0 first, NaN canonicalised and last).
// An inactive lane reads nothing and writes ids -1, ranks the pad.
//
// What bounds it on an H100. Each valid row costs its W code bytes and its
// f_add (20 bytes at D = 128). Ranked a mask and an add per code bit, that
// is 256 int32 operations, far above the card's int32 ridge of about 5
// operations per byte, so a kernel that ranks bit by bit is bound by
// operations. This design cuts the rank to one lookup and one add per code
// byte (2W operations a row, still above the ridge) and the selection to
// the few rows that can still enter the top-EF. Its bytes are more than
// the bound counts: every live lane streams its own cluster (two lanes
// that probe one cluster read it twice), about 1.5 GB at the gemv search's
// real launch.
//
// 1. Rank by per-lane partial-sum tables. A lane's LUT is fixed for its
//    whole scan, so the block first builds, in shared memory, T[b][x] = the
//    sum of lut[8b + j] over the set bits j of x, for each code byte b and
//    each byte value x (uint32; LUT entries at or past `dim` zeroed, so the
//    padding bits of a code never count). A row then ranks as
//    S = sum over b of T[b][code[b]]: W lookups and W adds in place of 8W
//    masks and 8W adds. Sums modulo 2^32 do not depend on their order, so
//    S equals the bit-by-bit sum bitwise for every LUT, entries near
//    +-2^31 included. The tables and the row sum are common.cuh's
//    `build_tables` and `table_sum` (beam_search.cu ranks through the same
//    nibble tables); the O3 epilogue is common.cuh's `o3_rank`.
//    Layout: T[b][x] at b * 256 + x, byte b's 256 entries contiguous, at
//    the start of shared memory. The 32 threads of a warp rank 32 rows and
//    look up the same b at one time, so their addresses differ only in x:
//    bank x mod 32, spread uniformly by the data (about 3.5-way conflicts
//    at worst in a warp of random bytes). A layout [x][b] would put all 32
//    lookups of one b into W-strided banks (2 banks at W = 16). Nibble
//    tables (below) are free of conflicts, since a warp's lookups at one
//    half byte touch 16 words of 16 banks, but take twice the lookups and
//    adds; on the H100 at W = 16 they were the slower of the two.
//    The cut: byte tables take W * 1 KB; up to W = 64 (64 KB) they are
//    used. Above (W up to 256, kMaxDpad) they would take up to 256 KB, more
//    than a block may hold, so the kernel uses nibble tables there: T[h][x]
//    for each 4-bit half h of the code and x < 16, 2W * 16 entries (32 KB at
//    W = 256), 2W lookups a row.
//    The other policies: the exact rank takes float nibble tables at every
//    W, so that one order of float sums (ref.exact_rank_ref's, ascending
//    half bytes) serves this kernel, beam_search.cu and the plain version;
//    the Hamming rank takes no table, only the lane's W-byte qcode, and
//    ranks a row by W / 4 popcounts. Each row of the exact rank also reads
//    its residual_norm and cos_theta (8 bytes), a row of Hamming only its
//    code.
// 2. Select through a running threshold. Row r's key is the unique 64-bit
//    (rank_key(rank) << 32) | r. The block keeps its best EFp keys sorted
//    (EFp = EF rounded up to a power of two) and tau, the EF-th best key so
//    far (all ones until EF keys have been seen). Rows are ranked in row
//    order, one a thread per iteration (only `first` of them until tau is
//    set); a key enters the candidate buffer (kBuf slots) only if it is
//    below tau, appended with one atomicAdd per warp (`__ballot_sync` and
//    the popcount of the lanes below). Before an iteration, the buffer is
//    merged into the top-EFp if it could overflow, if `merge_at` keys wait,
//    or if EF keys wait while tau is unset; and once more at the end. A
//    merge sorts the buffer (up to 128 keys one warp sorts them in
//    registers, more take the block's bitonic sort) and places every key
//    of the two sorted runs by its rank in their union (`co_rank`); tau
//    becomes the new EF-th key. Keys are unique, so the filter is exact,
//    and "ties to the lower row" holds because the row is in the key. No
//    key is dropped: the buffer is merged before it could fill, and tau
//    only ever falls to a key that is in the top-EF already.
//    The worst case of the filter: ranks falling in row order pass every
//    row, so every iteration of 256 rows fills the buffer past merge_at and
//    the next starts with a block-wide sort of 256 keys: M / 256 sorts, the
//    same order of work as sorting every chunk of rows would take. On
//    random ranks 128 rows pass at first and, with tau refreshed every
//    merge_at passes, about EF ln(n / EF) of a lane's n rows after that:
//    a handful of small merges a lane.
//    Only rows [0, min(M, n_valid + EF)) take part: a pad row past
//    n_valid + EF can never be among the EF best.
// 3. Launch geometry: one block of kThreads per lane; inactive lanes exit
//    at once. The tables, the keys and the buffer are dynamic shared memory
//    sized from W and EF (`cluster_scan_smem`: 25 KB at W = 16, EF = 40;
//    EF up to 8,192 fits a block's 227 KB at every W up to 256);
//    the LUT is staged in the key slots while the tables are built.
//    Registers are capped for kBlocksPerSm blocks on an SM.

#include "common.cuh"

namespace {

constexpr int kMaxDpad = 2048;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;    // caps registers at 32 a thread
constexpr int kByteTableMaxW = 64;                 // byte tables up to 64 KB
constexpr int kBuf = 1024;        // candidate slots: >= kThreads, a power
                                   // of two, and room for the LUT (8 KB)

// The path's rank order as a uint32: int32 INT_MIN + 1 -> 0, ..., INT_MAX
// -> 0xFFFFFFFE, INT_MIN -> 0xFFFFFFFF; float32 by `rank_order_key`.
__device__ __forceinline__ uint32_t rank_key(int32_t r) {
  return static_cast<uint32_t>(r) + 0x7FFFFFFFu;
}
__device__ __forceinline__ uint32_t rank_key(float r) {
  return rank_order_key(r);
}

template <class Rank>
__device__ __forceinline__ Rank key_rank(uint32_t k);
template <>
__device__ __forceinline__ int32_t key_rank<int32_t>(uint32_t k) {
  return static_cast<int32_t>(k - 0x7FFFFFFFu);
}
template <>
__device__ __forceinline__ float key_rank<float>(uint32_t k) {
  return rank_of_key(k);
}

// Keys a block keeps: the top-EFp, the merge's output and the buffer.
int key_slots(int ef_pad) { return 2 * ef_pad + kBuf; }

// Bytes of a lane's rank table (a multiple of 16), by the policy.
long long table_bytes(int kind, int w) {
  if (kind == kHamming) return HammingPolicy::table_bytes(w);
  if (kind == kExact) return ExactPolicy::table_bytes(w);
  return w <= kByteTableMaxW ? O3Policy<false>::table_bytes(w)
                             : O3Policy<true>::table_bytes(w);
}

// Lower bound: the number of keys in the sorted a[0, n) below x.
__device__ __forceinline__ int count_below(const unsigned long long* a, int n,
                                           unsigned long long x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Ascending bitonic sort of buf[0, 32 R) by one warp, in registers: element
// i = lane * R + r; slots from `filled` on count as all ones. Strides below
// R compare within a thread, the others across lanes by shuffles, so the
// sort takes no barrier. Writes the sorted keys back to buf.
template <int R>
__device__ void warp_sort(unsigned long long* buf, int filled) {
  const int lane = threadIdx.x & 31;
  unsigned long long v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane * R + r;
    v[r] = i < filled ? buf[i] : ~0ull;
  }
#pragma unroll
  for (int k = 2; k <= 32 * R; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane * R + r;
        const bool up = (i & k) == 0;
        if (j >= R) {
          const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, v[r],
                                                       j / R);
          const bool keep_min = ((i & j) == 0) == up;
          v[r] = keep_min ? (o < v[r] ? o : v[r]) : (o > v[r] ? o : v[r]);
        } else if ((r & j) == 0) {
          const unsigned long long x = v[r], y = v[r | j];
          if ((x > y) == up) {
            v[r] = y;
            v[r | j] = x;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) buf[lane * R + r] = v[r];
  __syncwarp();
}

// Place each key of the sorted runs top[0, ef_pad) and buf[0, p) at its
// rank in their union (its index plus the keys of the other run below it)
// and keep the ranks below ef_pad in `out`, with the threads [t0, t0 + nt).
// Real keys are unique, so their ranks are distinct; the all-ones fillers
// of both runs land on the same value.
__device__ __forceinline__ void co_rank(const unsigned long long* top,
                                        const unsigned long long* buf,
                                        unsigned long long* out, int ef_pad,
                                        int p, int t, int nt) {
  for (int i = t; i < ef_pad; i += nt) {
    const unsigned long long x = top[i];
    const int at = i + count_below(buf, p, x);
    if (at < ef_pad) out[at] = x;
  }
  for (int j = t; j < min(p, ef_pad); j += nt) {
    const unsigned long long y = buf[j];
    const int at = j + count_below(top, ef_pad, y);
    if (at < ef_pad) out[at] = y;
  }
}

// Merge the first `filled` buffer keys into the sorted top-EFp, leaving the
// best ef_pad keys of both in `out`: sort the buffer, then co_rank. Up to
// 128 keys one warp sorts them in registers (no barrier per stage); more
// take the block's bitonic sort over the next power of two of slots, the
// slots from `filled` set to all ones. Ends with a barrier.
__device__ void merge_buffer(const unsigned long long* top,
                             unsigned long long* buf,
                             unsigned long long* out, int ef_pad,
                             int filled) {
  if (filled <= 128) {
    if (threadIdx.x < 32) {
      if (filled <= 64) {
        warp_sort<2>(buf, filled);
      } else {
        warp_sort<4>(buf, filled);
      }
      co_rank(top, buf, out, ef_pad, filled <= 64 ? 64 : 128, threadIdx.x,
              32);
    }
    __syncthreads();
    return;
  }
  int p = 1;
  while (p < filled) p <<= 1;
  for (int i = filled + threadIdx.x; i < p; i += blockDim.x) buf[i] = ~0ull;
  __syncthreads();
  bitonic_sort(buf, p);
  co_rank(top, buf, out, ef_pad, p, threadIdx.x, blockDim.x);
  __syncthreads();
}

template <class P>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
cluster_scan_kernel(
    const uint8_t* __restrict__ codes, RankArgs ra,
    const int32_t* __restrict__ base_rows, const int32_t* __restrict__ n_valid,
    const uint8_t* __restrict__ active, int32_t* __restrict__ out_ids,
    typename P::Rank* __restrict__ out_ranks, int w, int dim, int ef,
    int ef_pad, int n_keys, int m, long long n_table, int vec16) {
  // the lane's table first (at a fixed shared address, so a lookup's
  // address is its index and a constant), then n_keys keys, then the
  // buffer's fill count; no static shared memory, so the launch's 48 KB
  // test is exact
  extern __shared__ __align__(16) unsigned long long smem[];
  unsigned char* tab = reinterpret_cast<unsigned char*>(smem);
  unsigned long long* key = smem + P::table_bytes(w) / 8;
  int& s_count = *reinterpret_cast<int*>(key + n_keys);
  const size_t lane = blockIdx.x;
  int32_t* oid = out_ids + lane * ef;
  typename P::Rank* ork = out_ranks + lane * ef;
  if (!active[lane]) {
    for (int j = threadIdx.x; j < ef; j += blockDim.x) {
      oid[j] = -1;
      ork[j] = P::pad();
    }
    return;
  }

  // the LUT, staged in the key slots (kBuf >= kMaxDpad / 2), then the
  // lane's table
  P::stage(ra, lane, w, dim, key, tab, threadIdx.x, blockDim.x);
  __syncthreads();
  P::build(tab, key, w, threadIdx.x, blockDim.x);
  __syncthreads();
  const P pol(ra, lane, tab);
  unsigned long long* top = key;                   // the sorted top-EFp
  unsigned long long* spare = key + ef_pad;        // the next merge's output
  unsigned long long* buf = key + 2 * ef_pad;      // kBuf candidate slots
  for (int i = threadIdx.x; i < ef_pad; i += blockDim.x) top[i] = ~0ull;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  const int nv = min(max(n_valid[lane], 0), m);
  const int n_end = min(m, nv + ef);
  const long long base = base_rows[lane];
  unsigned long long tau = ~0ull;
  const unsigned lane_id = threadIdx.x & 31u;
  const unsigned below = (1u << lane_id) - 1u;
  // rows per iteration: one a thread, but only `first` until tau is set,
  // so that the first merge sorts few keys
  const int first = min(kThreads, max(2 * ef_pad, 64));
  const int merge_at = max(ef_pad, 64);
  // the buffer's fill, the same in every thread: the sum of the appends,
  // counted by the barrier that ends each iteration. (Reading s_count
  // instead races: a warp that has passed the merge test may append before
  // a slower warp reads the count, and the two then take different paths.)
  int filled = 0;
  for (int r0 = 0, step = first; r0 < n_end; r0 += step) {
    // merge before the buffer could overflow, as soon as EF keys are in it
    // while tau is still all ones, and whenever merge_at keys wait
    if (filled > kBuf - kThreads || filled >= merge_at ||
        (tau == ~0ull && filled >= ef)) {
      merge_buffer(top, buf, spare, ef_pad, filled);
      unsigned long long* t = top;
      top = spare;
      spare = t;
      tau = top[ef - 1];
      filled = 0;
      if (threadIdx.x == 0) s_count = 0;
      __syncthreads();
    }
    step = tau == ~0ull ? first : kThreads;
    const int row = r0 + threadIdx.x;
    unsigned long long k = ~0ull;
    if (row < min(n_end, r0 + step)) {
      typename P::Rank r = P::pad();
      if (row < nv) {
        long long g = base + row;
        g = g < 0 ? 0 : (g < n_table ? g : n_table - 1);
        r = pol.rank(codes + static_cast<size_t>(g) * w, g, w, vec16);
      }
      k = (static_cast<unsigned long long>(rank_key(r)) << 32) |
          static_cast<uint32_t>(row);
    }
    // append below tau: one atomicAdd per warp
    const bool pass = k < tau;
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, pass);
    if (mask) {
      const int leader = __ffs(mask) - 1;
      int at = 0;
      if (lane_id == static_cast<unsigned>(leader)) {
        at = atomicAdd(&s_count, __popc(mask));
      }
      at = __shfl_sync(0xFFFFFFFFu, at, leader);
      if (pass) buf[at + __popc(mask & below)] = k;
    }
    filled += __syncthreads_count(pass);
  }
  if (filled > 0) {
    merge_buffer(top, buf, spare, ef_pad, filled);
    top = spare;
  }

  for (int j = threadIdx.x; j < ef; j += blockDim.x) {
    const unsigned long long kk = top[j];
    oid[j] = static_cast<int32_t>(kk & 0xFFFFFFFFull);
    ork[j] = key_rank<typename P::Rank>(static_cast<uint32_t>(kk >> 32));
  }
}

template <class P>
int launch(const void* codes, const RankArgs& ra, const void* base_rows,
           const void* n_valid, const void* active, void* out_ids,
           void* out_ranks, int n_lanes, int w, int dim, int ef, int m,
           long long n_table, int vec16, int smem, void* stream) {
  const int ef_pad = pow2_at_least(ef);
  const void* fn = reinterpret_cast<const void*>(cluster_scan_kernel<P>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cluster_scan_kernel<P>
      <<<n_lanes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(codes), ra,
          static_cast<const int32_t*>(base_rows),
          static_cast<const int32_t*>(n_valid),
          static_cast<const uint8_t*>(active),
          static_cast<int32_t*>(out_ids),
          static_cast<typename P::Rank*>(out_ranks), w, dim, ef, ef_pad,
          key_slots(ef_pad), m, n_table, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cluster_scan_max_dpad() { return kMaxDpad; }
extern "C" int cluster_scan_max_smem() { return kMaxSmem; }

// Dynamic shared memory of one block: the keys, the lane's table and the
// fill count (padded to 8 bytes).
extern "C" long long cluster_scan_smem(int kind, int w, int ef) {
  const int n_keys = key_slots(pow2_at_least(ef));
  return static_cast<long long>(n_keys) * 8 + table_bytes(kind, w) + 8;
}

extern "C" int cluster_scan_launch(
    int kind, const void* codes, const void* node0, const void* node1,
    const void* lut, const void* lane0, const void* lane1, const void* lane2,
    const void* base_rows, const void* n_valid, const void* active,
    void* out_ids, void* out_ranks, int n_lanes, int w, int dim, int ef,
    int m, long long n_table, int vec16, float sqrt_dim, void* stream) {
  const long long smem = cluster_scan_smem(kind, w, ef);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const RankArgs ra{node0, node1, lut, lane0, lane1, lane2, sqrt_dim};
  const int s = static_cast<int>(smem);
  switch (kind) {
    case kO3:
      if (w > kByteTableMaxW) {
        return launch<O3Policy<true>>(codes, ra, base_rows, n_valid, active,
                                      out_ids, out_ranks, n_lanes, w, dim,
                                      ef, m, n_table, vec16, s, stream);
      }
      return launch<O3Policy<false>>(codes, ra, base_rows, n_valid, active,
                                     out_ids, out_ranks, n_lanes, w, dim, ef,
                                     m, n_table, vec16, s, stream);
    case kHamming:
      return launch<HammingPolicy>(codes, ra, base_rows, n_valid, active,
                                   out_ids, out_ranks, n_lanes, w, dim, ef,
                                   m, n_table, vec16, s, stream);
    case kExact:
      return launch<ExactPolicy>(codes, ra, base_rows, n_valid, active,
                                 out_ids, out_ranks, n_lanes, w, dim, ef, m,
                                 n_table, vec16, s, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
