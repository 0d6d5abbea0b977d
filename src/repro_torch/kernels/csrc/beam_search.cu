// beam_search: the whole mulfree beam search of every lane in one launch,
// the O3 rank of each hop's neighbours fused into the hop that needs it.
//
// Replaces the Pallas TPU kernel `binary_ip_rank` (repro/kernels/binary_ip.py,
// `binary_ip_rank` / `_binary_ip_kernel`) on the beam path, fused with the
// loop that called it once a hop (repro/core/beam_search.py
// `beam_search_lane`). Semantics: repro_torch/kernels/ref.py
// `beam_search_ref`, the port's lock-step loop (`lockstep_beam_search`)
// ranking through `binary_ip_rank_ref`; ids, ranks and hops are bitwise
// equal to it. For each active lane l, over its cluster (rows base_rows[l]
// + [0, m) of the flattened code and neighbour tables):
//   1. the entry ranks as the beam's first entry (the rest id -1, rank
//      INT_MAX); an inactive lane stops here with 0 hops;
//   2. while an unexpanded entry ranks below INT_MAX, at most max_iters
//      times: the first unexpanded entry of the sorted beam (the
//      reference's argmin, first minimum) is expanded; its R neighbours are
//      tested against the visited bitmap before any of them is marked (so
//      both copies of an id repeated in a row stay fresh); the bitmap is
//      then updated with the reference's quirk (ROADMAP C1): ids above 0
//      are set, node 0 only if the last slot <= 0 of the masked row is a 0;
//      the fresh neighbours are ranked by O3 (sums mod 2^32, equal bitwise
//      to binary_ip.cu's bit-by-bit sums), the others rank INT_MAX;
//      the beam and the neighbours merge stably into the best EF by signed
//      rank: beam entries before neighbours on equal ranks, neighbours in
//      column order.
// A lane that stops never starts again, so each lane runs its own loop to
// its own end: the lock-step loop's result, without its host round trips.
//
// What bounds it on an H100: little. Per live lane and hop it reads one
// neighbour row (4R bytes) and the code and f_add of each fresh neighbour
// (W + 4 bytes), plus the lane's LUT once; a rank bit by bit takes 2 dim
// int32 operations a row, through nibble tables 4W. At the main path's
// real search (342K hops, 5.7M rows ranked) that is 0.088 ms by the bit
// count's operations, 0.051 ms by bytes. The real cost is latency: a hop
// is a chain of two dependent gathers (the neighbour row, then the codes)
// and a few dozen dependent steps in shared memory, so the design keeps
// many lanes in flight and few instructions a hop.
//
// Design:
//  * One warp per lane, kWarps = 4 lanes a block (a block frees its slot
//    when its slowest lane ends; 4 beat 8 and 2 in a trial on the H100;
//    capping registers for more blocks spilled and was slower).
//    Thread t takes neighbours t, t + 32, ... of a row (one each at R = 32)
//    and ranks them.
//  * The rank: the warp first builds the lane's nibble tables from its LUT
//    (common.cuh's `build_tables<true>`, as cluster_scan.cu builds them
//    above W = 64: 2W x 16 uint32, 2 KB at W = 16), then a row ranks by
//    `table_sum<true>`, 2W lookups and adds, in place of 8W masks and adds
//    bit by bit. The 32 lookups of a warp at one half byte touch 16 words
//    of 16 banks, so they are free of bank conflicts. Byte tables would
//    take 16 KB a lane. A first version ranked bit by bit (binary_ip.cu's
//    sum, the LUT read by broadcast) and sorted in shared memory at every
//    R: on the real search it took 0.98 ms, this one 0.52 (PERF.md).
//  * A lane's state: the LUT (8W int32, entries at or past dim zeroed, read
//    only to build the tables), the tables, the visited bitmap ((M + 1)
//    bits: 2,140 bytes at M = 17,089), two beams (EF ranks, ids and
//    expanded flags each; the merge writes the other), the neighbours' sort
//    keys (RP = R rounded up to a power of two, at least 32) and masked ids
//    (R): 5.8 KB at the main path's shape. It lives in shared memory,
//    kWarps lanes a block (fewer where kWarps do not fit); where one lane
//    does not fit a block, the wrapper passes a global scratch of the same
//    layout and the same code runs on it (kShared = false).
//  * Selection: a ballot over the expanded flags in chunks of 32; the beam
//    stays sorted, so the first unexpanded entry is the best one.
//  * The quirk: a ballot of the slots <= 0 gives the last one, a ballot of
//    the zeros says whether it is a 0.
//  * Merge: the neighbours' keys ((signed rank as an ordered uint32) << 32 |
//    column) are sorted by a bitonic network over the warp (in registers by
//    shuffles at RP = 32, one key a thread; in shared memory above), then
//    each entry of both sorted runs is placed at its rank in their union
//    (co-ranking, as cluster_scan.cu places its buffer): beam entry i at i
//    + the neighbours of lower rank, neighbour j at j + the beam entries of
//    lower or equal rank.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                 // lanes per block
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Layout {
  int dpad, vis_words, ef, r, rp;
  long long lut, tab, vis, rank0, id0, exp0, rank1, id1, exp1, key, nid,
      bytes;
};

long long align16(long long x) { return (x + 15) / 16 * 16; }

Layout layout(int ef, int r, int m, int w) {
  Layout L;
  L.dpad = 8 * w;
  L.vis_words = (m + 1 + 31) / 32;
  L.ef = ef;
  L.r = r;
  L.rp = 32;
  while (L.rp < r) L.rp <<= 1;
  long long at = 0;
  L.key = at;  at = align16(at + 8LL * L.rp);
  L.lut = at;  at = align16(at + 4LL * L.dpad);
  L.tab = at;  at = align16(at + 4LL * 32 * w);
  L.vis = at;  at = align16(at + 4LL * L.vis_words);
  L.rank0 = at;  at = align16(at + 4LL * ef);
  L.rank1 = at;  at = align16(at + 4LL * ef);
  L.id0 = at;  at = align16(at + 4LL * ef);
  L.id1 = at;  at = align16(at + 4LL * ef);
  L.nid = at;  at = align16(at + 4LL * r);
  L.exp0 = at;  at = align16(at + ef);
  L.exp1 = at;  at = align16(at + ef);
  L.bytes = at;
  return L;
}

// Lanes a block holds in shared memory (kWarps, 4, 2 or 1), or 0 where one
// lane does not fit and the state goes to global scratch.
int warps_in_smem(const Layout& L) {
  for (int wp = kWarps; wp >= 1; wp >>= 1)
    if (wp * L.bytes <= kMaxSmem) return wp;
  return 0;
}

// The path's rank order as a uint32: INT_MIN -> 0, ..., INT_MAX -> ~0.
__device__ __forceinline__ uint32_t order_key(int32_t r) {
  return static_cast<uint32_t>(r) ^ 0x80000000u;
}

// The number of keys in the sorted a[0, n) below x.
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

// The number of ranks in the sorted (signed) a[0, n) at or below x.
__device__ __forceinline__ int count_at_or_below(const int32_t* a, int n,
                                                 int32_t x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] <= x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Ascending bitonic sort of key[0, p) (p a power of two) by one warp in
// shared memory; each stage ends with __syncwarp.
__device__ void warp_bitonic(unsigned long long* key, int p, int tl) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tl; i < p; i += 32) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = key[i], b = key[ixj];
          if ((a > b) == ((i & k) == 0)) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// The same network over 32 keys, one a thread, by shuffles.
__device__ __forceinline__ unsigned long long warp_bitonic32(
    unsigned long long v, int tl) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, v, j);
      const bool keep_min = ((tl & j) == 0) == ((tl & k) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  return v;
}

template <bool kShared>
__global__ void __launch_bounds__(32 * kWarps)
beam_search_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ f_add,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ base_rows,
    const int32_t* __restrict__ entry, const int32_t* __restrict__ lut,
    const int32_t* __restrict__ sumq, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const uint8_t* __restrict__ active,
    int32_t* __restrict__ out_ids, int32_t* __restrict__ out_ranks,
    int32_t* __restrict__ out_hops, unsigned char* __restrict__ scratch,
    Layout L, int n_lanes, int warps, int w, int dim, int max_iters, int m,
    long long n_table, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, tl = threadIdx.x & 31;
  const long long lane = static_cast<long long>(blockIdx.x) * warps + warp;
  if (lane >= n_lanes) return;
  unsigned char* st =
      kShared ? smem + warp * L.bytes : scratch + lane * L.bytes;
  auto* key = reinterpret_cast<unsigned long long*>(st + L.key);
  auto* lt = reinterpret_cast<int32_t*>(st + L.lut);
  auto* tab = reinterpret_cast<uint32_t*>(st + L.tab);
  auto* vis = reinterpret_cast<uint32_t*>(st + L.vis);
  auto* nid = reinterpret_cast<int32_t*>(st + L.nid);
  // the two beams, picked by `cur` with selects (an array of pointers
  // indexed by a variable would live in local memory)
  auto rank = [&](int b) {
    return reinterpret_cast<int32_t*>(st + (b ? L.rank1 : L.rank0));
  };
  auto ids = [&](int b) {
    return reinterpret_cast<int32_t*>(st + (b ? L.id1 : L.id0));
  };
  auto expd = [&](int b) { return st + (b ? L.exp1 : L.exp0); };
  const int ef = L.ef, r = L.r, rp = L.rp;

  for (int i = tl; i < L.dpad; i += 32)
    lt[i] = i < dim ? lut[lane * L.dpad + i] : 0;
  __syncwarp();
  build_tables<true>(tab, lt, w, tl, 32);
  for (int i = tl; i < L.vis_words; i += 32) vis[i] = 0u;
  for (int i = tl; i < ef; i += 32) {
    rank(0)[i] = INT32_MAX;
    ids(0)[i] = -1;
    expd(0)[i] = 0;
  }
  __syncwarp();

  const long long base = base_rows[lane];
  const int32_t sq = sumq[lane], a1 = s1[lane], a2 = s2[lane];
  // the flattened row of local id x >= 0 (clipped as the plain version's
  // gathers clip it)
  auto row_of = [&](int32_t x) {
    long long g = base + min(x, m - 1);
    return g < 0 ? 0 : (g < n_table ? g : n_table - 1);
  };
  // the O3 rank of local id x >= 0 through the lane's tables
  auto rank_of = [&](int32_t x) {
    const long long g = row_of(x);
    return o3_rank(table_sum<true>(codes + static_cast<size_t>(g) * w, tab,
                                   w, vec16),
                   f_add[g], sq, a1, a2);
  };
  if (tl == 0) {
    const int32_t e = entry[lane];
    rank(0)[0] = e >= 0 ? rank_of(e) : INT32_MAX;
    ids(0)[0] = e;
    if (e >= 0) {
      const int b = min(e, m);  // id m is the sink, never read
      vis[b >> 5] |= 1u << (b & 31);
    }
  }
  __syncwarp();

  int cur = 0, hops = 0;
  for (int it = 0; active[lane] && it < max_iters; ++it) {
    // the first unexpanded entry of the sorted beam
    int sel = -1;
    for (int c = 0; c < ef; c += 32) {
      const int i = c + tl;
      const unsigned open = __ballot_sync(kFull, i < ef && !expd(cur)[i]);
      if (open) {
        sel = c + __ffs(open) - 1;
        break;
      }
    }
    if (sel < 0 || rank(cur)[sel] == INT32_MAX) break;
    const int32_t node = ids(cur)[sel];
    const int32_t* row = nbrs + row_of(max(node, 0)) * r;

    // fresh against the bitmap as it was before this row; the last slot
    // <= 0 of the masked row and whether it is a 0 (the quirk)
    int last = -1;
    bool last_zero = false;
    for (int c = 0; c < r; c += 32) {
      const int j = c + tl;
      int32_t x = -1;
      if (j < r) {
        const int32_t nb = row[j];
        if (nb >= 0 && node >= 0) {
          const int v = min(nb, m - 1);
          if (!((vis[v >> 5] >> (v & 31)) & 1u)) x = nb;
        }
        nid[j] = x;
      }
      const unsigned le0 = __ballot_sync(kFull, j < r && x <= 0);
      const unsigned zero = __ballot_sync(kFull, j < r && x == 0);
      if (le0) {
        last = c + 31 - __clz(le0);
        last_zero = (zero >> (31 - __clz(le0))) & 1u;
      }
    }
    __syncwarp();
    for (int j = tl; j < r; j += 32) {
      const int32_t x = nid[j];
      if (x > 0) {
        const int v = min(x, m - 1);
        atomicOr(&vis[v >> 5], 1u << (v & 31));
      }
    }
    if (tl == 0 && last >= 0 && last_zero) atomicOr(&vis[0], 1u);

    // rank the fresh neighbours; key (rank order << 32) | column, the
    // padding slots past R all ones; sorted
    auto key_of = [&](int j) {
      if (j >= r) return ~0ull;
      const int32_t x = nid[j];
      return (static_cast<unsigned long long>(
                  order_key(x >= 0 ? rank_of(x) : INT32_MAX))
              << 32) |
             static_cast<uint32_t>(j);
    };
    if (rp == 32) {
      key[tl] = warp_bitonic32(key_of(tl), tl);
      __syncwarp();
    } else {
      for (int j = tl; j < rp; j += 32) key[j] = key_of(j);
      __syncwarp();
      warp_bitonic(key, rp, tl);
    }

    // stable merge of the beam and the sorted neighbours into the best EF
    const int nx = cur ^ 1;
    for (int i = tl; i < ef; i += 32) {
      const int32_t rk = rank(cur)[i];
      const int at = i + count_below(key, r, static_cast<unsigned long long>(
                                                 order_key(rk)) << 32);
      if (at < ef) {
        rank(nx)[at] = rk;
        ids(nx)[at] = ids(cur)[i];
        expd(nx)[at] = expd(cur)[i] | (i == sel);
      }
    }
    for (int j = tl; j < min(r, ef); j += 32) {
      const unsigned long long k = key[j];
      const int32_t rk = static_cast<int32_t>(static_cast<uint32_t>(k >> 32) ^
                                              0x80000000u);
      const int at = j + count_at_or_below(rank(cur), ef, rk);
      if (at < ef) {
        rank(nx)[at] = rk;
        ids(nx)[at] = nid[k & 0xFFFFFFFFull];
        expd(nx)[at] = 0;
      }
    }
    __syncwarp();
    cur = nx;
    ++hops;
  }

  for (int i = tl; i < ef; i += 32) {
    out_ids[lane * ef + i] = ids(cur)[i];
    out_ranks[lane * ef + i] = rank(cur)[i];
  }
  if (tl == 0) out_hops[lane] = hops;
}

}  // namespace

// Bytes of global scratch the launch needs: 0 where every lane's state fits
// a block's shared memory, else n_lanes times one lane's state.
extern "C" long long beam_search_scratch_bytes(int n_lanes, int ef, int r,
                                               int m, int w) {
  const Layout L = layout(ef, r, m, w);
  return warps_in_smem(L) ? 0 : static_cast<long long>(n_lanes) * L.bytes;
}

// Shared memory of one block (0 on the scratch route).
extern "C" long long beam_search_smem(int ef, int r, int m, int w) {
  const Layout L = layout(ef, r, m, w);
  return warps_in_smem(L) * L.bytes;
}

extern "C" int beam_search_launch(
    const void* codes, const void* f_add, const void* nbrs,
    const void* base_rows, const void* entry, const void* lut,
    const void* sumq, const void* s1, const void* s2, const void* active,
    void* out_ids, void* out_ranks, void* out_hops, void* scratch,
    int n_lanes, int r, int w, int dim, int ef, int max_iters, int m,
    long long n_table, int vec16, void* stream) {
  const Layout L = layout(ef, r, m, w);
  const int in_smem = warps_in_smem(L);
  const int warps = in_smem ? in_smem : kWarps;
  const int smem = static_cast<int>(in_smem * L.bytes);
  if (!in_smem && scratch == nullptr) return -1;
  const void* fn = in_smem
      ? reinterpret_cast<const void*>(beam_search_kernel<true>)
      : reinterpret_cast<const void*>(beam_search_kernel<false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto* kernel = in_smem ? beam_search_kernel<true>
                         : beam_search_kernel<false>;
  const int blocks = (n_lanes + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(f_add),
      static_cast<const int32_t*>(nbrs),
      static_cast<const int32_t*>(base_rows),
      static_cast<const int32_t*>(entry), static_cast<const int32_t*>(lut),
      static_cast<const int32_t*>(sumq), static_cast<const int32_t*>(s1),
      static_cast<const int32_t*>(s2), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(out_ids), static_cast<int32_t*>(out_ranks),
      static_cast<int32_t*>(out_hops),
      static_cast<unsigned char*>(scratch), L, n_lanes, warps, w, dim,
      max_iters, m, n_table, vec16);
  return static_cast<int>(cudaGetLastError());
}
