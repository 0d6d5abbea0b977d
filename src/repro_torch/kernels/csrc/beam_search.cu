// beam_search: the whole beam search of every lane in one launch, the rank
// of each hop's neighbours fused into the hop that needs it, by one of three
// rank policies (common.cuh): O3 (mulfree), Hamming and Exact.
//
// Replaces the Pallas TPU kernel `binary_ip_rank` (repro/kernels/binary_ip.py,
// `binary_ip_rank` / `_binary_ip_kernel`) on the beam path, fused with the
// loop that called it once a hop (repro/core/beam_search.py
// `beam_search_lane`); the JAX package ranks the exact and hamming backends
// in plain jnp (repro/core/backends.py), and this kernel carries them too.
// Semantics: repro_torch/kernels/ref.py `ranked_beam_search_ref`, the port's
// lock-step loop (`lockstep_beam_search`) ranking through `row_ranker`; ids,
// ranks and hops are bitwise equal to it. For each active lane l, over its
// cluster (rows base_rows[l] + [0, m) of the flattened code and neighbour
// tables):
//   1. the entry ranks as the beam's first entry (the rest id -1, rank the
//      policy's pad: INT_MAX, or F32_MAX for the exact rank); an inactive
//      lane stops here with 0 hops;
//   2. while an unexpanded entry ranks below the pad (JAX's `min(frontier)
//      < pad_rank`), at most max_iters times: the first unexpanded entry of
//      the sorted beam (the reference's argmin, first minimum) is expanded;
//      its R neighbours are tested against the visited bitmap before any of
//      them is marked (so both copies of an id repeated in a row stay
//      fresh); the bitmap is then updated with the reference's quirk
//      (ROADMAP C1): ids above 0 are set, node 0 only if the last slot <= 0
//      of the masked row is a 0; the fresh neighbours are ranked by the
//      policy (O3 sums mod 2^32, equal bitwise to binary_ip.cu's bit-by-bit
//      sums; the exact rank's float sums in ref.exact_rank_ref's order), the
//      others rank the pad; the beam and the neighbours merge stably into
//      the best EF by rank: beam entries before neighbours on equal ranks,
//      neighbours in column order.
// A lane that stops never starts again, so each lane runs its own loop to
// its own end: the lock-step loop's result, without its host round trips.
//
// What bounds it on an H100: little. Per live lane and hop it reads one
// neighbour row (4R bytes) and the code and per-row factors of each fresh
// neighbour (W + 4 bytes for O3, W for Hamming, W + 8 for Exact), plus the
// lane's LUT once; a rank bit by bit takes 2 dim operations a row, through
// nibble tables 4W, by popcounts W / 2. At the main path's real search
// (342K hops, 5.7M rows ranked) that is 0.088 ms by the bit count's
// operations, 0.051 ms by bytes. The real cost is latency: a hop is a chain
// of two dependent gathers (the neighbour row, then the codes) and a few
// dozen dependent steps in shared memory, so the design keeps many lanes in
// flight and few instructions a hop.
//
// Float ranks (exact). The beam holds each rank as its 32-bit order key
// (common.cuh `rank_order_key`: total order, NaN canonicalised and last),
// which the plain loop's stable sort matches: that sort ties -0.0 with
// +0.0, and the estimator never gives -0.0. A NaN rank is never expanded
// (its key is above the pad's), and the plain loop's argmin stops a lane at
// a NaN in its frontier; NaN keys sort last, so a NaN in the beam is in its
// last slot, and the loop stops there too.
//
// Design:
//  * One warp per lane, kWarps = 4 lanes a block (a block frees its slot
//    when its slowest lane ends; 4 beat 8 and 2 in a trial on the H100;
//    capping registers for more blocks spilled and was slower).
//    Thread t takes neighbours t, t + 32, ... of a row (one each at R = 32)
//    and ranks them.
//  * The rank, by the policy: O3 and Exact first build the lane's nibble
//    tables from its LUT (2W x 16 words, 2 KB at W = 16: O3 as
//    cluster_scan.cu builds them above W = 64, common.cuh's
//    `build_tables<true>`), then a row ranks by 2W lookups and adds, in
//    place of 8W masks and adds bit by bit. The 32 lookups of a warp at one
//    half byte touch 16 words of 16 banks, so they are free of bank
//    conflicts. Byte tables would take 16 KB a lane. Hamming holds the
//    lane's W-byte qcode instead and ranks a row by W / 4 popcounts. A
//    first version ranked bit by bit (binary_ip.cu's sum, the LUT read by
//    broadcast) and sorted in shared memory at every R: on the real search
//    it took 0.98 ms, the table version 0.52 (PERF.md).
//  * A lane's state: the staged LUT (8W words, entries at or past dim
//    zeroed, read only to build the tables; none for Hamming), the tables
//    (or the qcode), the visited bitmap ((M + 1) bits: 2,140 bytes at M =
//    17,089), two beams (EF rank keys, ids and expanded flags each; the
//    merge writes the other), the neighbours' sort keys (RP = R rounded up
//    to a power of two, at least 32) and masked ids (R): 5.8 KB at the main
//    path's shape (O3 and Exact), 3.3 KB (Hamming). It lives in shared
//    memory, kWarps lanes a block (fewer where kWarps do not fit); where one
//    lane does not fit a block, the wrapper passes a global scratch of the
//    same layout and the same code runs on it (kShared = false).
//  * Selection: a ballot over the expanded flags in chunks of 32; the beam
//    stays sorted, so the first unexpanded entry is the best one.
//  * The quirk: a ballot of the slots <= 0 gives the last one, a ballot of
//    the zeros says whether it is a 0.
//  * Merge: the neighbours' keys ((rank order key) << 32 | column) are
//    sorted by a bitonic network over the warp (in registers by shuffles at
//    RP = 32, one key a thread; in shared memory above), then each entry of
//    both sorted runs is placed at its rank in their union (co-ranking, as
//    cluster_scan.cu places its buffer): beam entry i at i + the neighbours
//    of lower key, neighbour j at j + the beam entries of lower or equal
//    key.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                 // lanes per block
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Layout {
  int vis_words, ef, r, rp;
  long long key, stage, tab, vis, bkey0, bkey1, id0, id1, nid, exp0, exp1,
      bytes;
};

long long align16(long long x) { return (x + 15) / 16 * 16; }

template <class P>
Layout layout(int ef, int r, int m, int w) {
  Layout L;
  L.vis_words = (m + 1 + 31) / 32;
  L.ef = ef;
  L.r = r;
  L.rp = 32;
  while (L.rp < r) L.rp <<= 1;
  long long at = 0;
  L.key = at;  at = align16(at + 8LL * L.rp);
  L.stage = at;  at = align16(at + P::stage_bytes(w));
  L.tab = at;  at = align16(at + P::table_bytes(w));
  L.vis = at;  at = align16(at + 4LL * L.vis_words);
  L.bkey0 = at;  at = align16(at + 4LL * ef);
  L.bkey1 = at;  at = align16(at + 4LL * ef);
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

// The path's rank order as a uint32 (a stable argsort of the ranks): int32
// INT_MIN -> 0, ..., INT_MAX -> ~0; float32 by `rank_order_key`.
__device__ __forceinline__ uint32_t order_key(int32_t r) {
  return static_cast<uint32_t>(r) ^ 0x80000000u;
}
__device__ __forceinline__ uint32_t order_key(float r) {
  return rank_order_key(r);
}

template <class Rank>
__device__ __forceinline__ Rank key_rank(uint32_t k);
template <>
__device__ __forceinline__ int32_t key_rank<int32_t>(uint32_t k) {
  return static_cast<int32_t>(k ^ 0x80000000u);
}
template <>
__device__ __forceinline__ float key_rank<float>(uint32_t k) {
  return rank_of_key(k);
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

// The number of keys in the sorted a[0, n) at or below x.
__device__ __forceinline__ int count_at_or_below(const uint32_t* a, int n,
                                                 uint32_t x) {
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

template <class P, bool kShared>
__global__ void __launch_bounds__(32 * kWarps)
beam_search_kernel(
    const uint8_t* __restrict__ codes, RankArgs ra,
    const int32_t* __restrict__ nbrs, const int32_t* __restrict__ base_rows,
    const int32_t* __restrict__ entry, const uint8_t* __restrict__ active,
    int32_t* __restrict__ out_ids, typename P::Rank* __restrict__ out_ranks,
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
  auto* vis = reinterpret_cast<uint32_t*>(st + L.vis);
  auto* nid = reinterpret_cast<int32_t*>(st + L.nid);
  // the two beams, picked by `cur` with selects (an array of pointers
  // indexed by a variable would live in local memory); a beam holds each
  // rank as its order key
  auto bkey = [&](int b) {
    return reinterpret_cast<uint32_t*>(st + (b ? L.bkey1 : L.bkey0));
  };
  auto ids = [&](int b) {
    return reinterpret_cast<int32_t*>(st + (b ? L.id1 : L.id0));
  };
  auto expd = [&](int b) { return st + (b ? L.exp1 : L.exp0); };
  const int ef = L.ef, r = L.r, rp = L.rp;
  const uint32_t pad_key = order_key(P::pad());

  P::stage(ra, lane, w, dim, st + L.stage, st + L.tab, tl, 32);
  __syncwarp();
  P::build(st + L.tab, st + L.stage, w, tl, 32);
  for (int i = tl; i < L.vis_words; i += 32) vis[i] = 0u;
  for (int i = tl; i < ef; i += 32) {
    bkey(0)[i] = pad_key;
    ids(0)[i] = -1;
    expd(0)[i] = 0;
  }
  __syncwarp();
  const P pol(ra, lane, st + L.tab);

  const long long base = base_rows[lane];
  // the flattened row of local id x >= 0 (clipped as the plain version's
  // gathers clip it)
  auto row_of = [&](int32_t x) {
    long long g = base + min(x, m - 1);
    return g < 0 ? 0 : (g < n_table ? g : n_table - 1);
  };
  // the rank order key of local id x >= 0, by the lane's policy
  auto key_of_node = [&](int32_t x) {
    const long long g = row_of(x);
    return order_key(
        pol.rank(codes + static_cast<size_t>(g) * w, g, w, vec16));
  };
  if (tl == 0) {
    const int32_t e = entry[lane];
    bkey(0)[0] = e >= 0 ? key_of_node(e) : pad_key;
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
    // stop where no unexpanded entry ranks below the pad, or (a float rank)
    // where a NaN is in the beam: its last slot
    if (sel < 0 || bkey(cur)[sel] >= pad_key ||
        (P::kFloat && bkey(cur)[ef - 1] == kNanKey))
      break;
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
      return (static_cast<unsigned long long>(x >= 0 ? key_of_node(x)
                                                     : pad_key)
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
      const uint32_t bk = bkey(cur)[i];
      const int at =
          i + count_below(key, r, static_cast<unsigned long long>(bk) << 32);
      if (at < ef) {
        bkey(nx)[at] = bk;
        ids(nx)[at] = ids(cur)[i];
        expd(nx)[at] = expd(cur)[i] | (i == sel);
      }
    }
    for (int j = tl; j < min(r, ef); j += 32) {
      const unsigned long long k = key[j];
      const uint32_t nk = static_cast<uint32_t>(k >> 32);
      const int at = j + count_at_or_below(bkey(cur), ef, nk);
      if (at < ef) {
        bkey(nx)[at] = nk;
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
    out_ranks[lane * ef + i] = key_rank<typename P::Rank>(bkey(cur)[i]);
  }
  if (tl == 0) out_hops[lane] = hops;
}

Layout layout_of(int kind, int ef, int r, int m, int w) {
  if (kind == kHamming) return layout<HammingPolicy>(ef, r, m, w);
  if (kind == kExact) return layout<ExactPolicy>(ef, r, m, w);
  return layout<O3Policy<true>>(ef, r, m, w);
}

template <class P>
int launch(const void* codes, const RankArgs& ra, const void* nbrs,
           const void* base_rows, const void* entry, const void* active,
           void* out_ids, void* out_ranks, void* out_hops, void* scratch,
           int n_lanes, int r, int w, int dim, int ef, int max_iters, int m,
           long long n_table, int vec16, void* stream) {
  const Layout L = layout<P>(ef, r, m, w);
  const int in_smem = warps_in_smem(L);
  const int warps = in_smem ? in_smem : kWarps;
  const int smem = static_cast<int>(in_smem * L.bytes);
  if (!in_smem && scratch == nullptr) return -1;
  const void* fn = in_smem
      ? reinterpret_cast<const void*>(beam_search_kernel<P, true>)
      : reinterpret_cast<const void*>(beam_search_kernel<P, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto* kernel = in_smem ? beam_search_kernel<P, true>
                         : beam_search_kernel<P, false>;
  const int blocks = (n_lanes + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), ra,
      static_cast<const int32_t*>(nbrs),
      static_cast<const int32_t*>(base_rows),
      static_cast<const int32_t*>(entry), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(out_ids),
      static_cast<typename P::Rank*>(out_ranks),
      static_cast<int32_t*>(out_hops),
      static_cast<unsigned char*>(scratch), L, n_lanes, warps, w, dim,
      max_iters, m, n_table, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of global scratch the launch needs: 0 where every lane's state fits
// a block's shared memory, else n_lanes times one lane's state.
extern "C" long long beam_search_scratch_bytes(int kind, int n_lanes, int ef,
                                               int r, int m, int w) {
  const Layout L = layout_of(kind, ef, r, m, w);
  return warps_in_smem(L) ? 0 : static_cast<long long>(n_lanes) * L.bytes;
}

// Shared memory of one block (0 on the scratch route).
extern "C" long long beam_search_smem(int kind, int ef, int r, int m, int w) {
  const Layout L = layout_of(kind, ef, r, m, w);
  return warps_in_smem(L) * L.bytes;
}

extern "C" int beam_search_launch(
    int kind, const void* codes, const void* node0, const void* node1,
    const void* lut, const void* lane0, const void* lane1, const void* lane2,
    const void* nbrs, const void* base_rows, const void* entry,
    const void* active, void* out_ids, void* out_ranks, void* out_hops,
    void* scratch, int n_lanes, int r, int w, int dim, int ef, int max_iters,
    int m, long long n_table, int vec16, float sqrt_dim, void* stream) {
  const RankArgs ra{node0, node1, lut, lane0, lane1, lane2, sqrt_dim};
  switch (kind) {
    case kO3:
      return launch<O3Policy<true>>(codes, ra, nbrs, base_rows, entry,
                                    active, out_ids, out_ranks, out_hops,
                                    scratch, n_lanes, r, w, dim, ef,
                                    max_iters, m, n_table, vec16, stream);
    case kHamming:
      return launch<HammingPolicy>(codes, ra, nbrs, base_rows, entry, active,
                                   out_ids, out_ranks, out_hops, scratch,
                                   n_lanes, r, w, dim, ef, max_iters, m,
                                   n_table, vec16, stream);
    case kExact:
      return launch<ExactPolicy>(codes, ra, nbrs, base_rows, entry, active,
                                 out_ids, out_ranks, out_hops, scratch,
                                 n_lanes, r, w, dim, ef, max_iters, m,
                                 n_table, vec16, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
