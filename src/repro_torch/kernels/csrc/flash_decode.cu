// flash_decode: the attention forward of a float32 query whose rows that
// read one KV head fit one tile, Sq x (Hq / Hkv) <= 64: the decode step over
// a sequence-split KV cache (models/attention.py `_seq_split_step`, one
// float32 row a request over a rank's slots, with its logsumexp), split over
// the keys (split-KV, "flash decoding").
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (repro/kernels/flash_attn.py) on those calls, where flash_attn.cu's
// CUDA-core `flash_fwd_kernel` stood for it; float32 q beyond 64 rows
// stays there. The
// function is flash_attn.cu's, mask for mask: key j is valid for the query
// at absolute position p = q_offset + i when j < kv_valid_len, j <= p if
// causal, and p - j < window if window > 0; GQA reads KV head h / g for
// query head h; `softcap` > 0 caps each scaled score at softcap tanh(s /
// softcap) before the mask; the output in float32 and, when asked for, each
// row's logsumexp of its scaled, masked scores (natural log). Plain version:
// ref.py `flash_attention_ref` (float32 operands); ref.py
// `flash_decode_ref` mirrors this split and combine step by step.
//
// What bounds it on an H100: the bytes. At a danube decode_32k rank (B 8,
// one row a request, 32 query heads over 8 KV heads of 80, 2,048 bf16
// slots) K and V are 41.9 MB, 12.6 us at 3.35 TB/s; the 168 MFLOP of
// Q.K^T and P.V are ~one float32 FMA a byte of K/V, far below what the CUDA
// cores do a byte of HBM bandwidth, so tensor cores would buy nothing.
//
// The design (kernels/flash_attn.py `decode_design` computes the split and
// passes it in):
//  * The keys some row can see, [kv_begin, kv_end), in tiles of 32, are
//    split into chunks of whole tiles; the chunk count comes from B x Hkv
//    and the tile count, so that ~8 warps an SM are in flight.
//  * One warp per (batch row, KV head, chunk), up to four chunks of one
//    (batch row, KV head) a block (Ring::kWarpsB: as many warps as keep
//    the block's rings within 96 KB). The R = Sq x g query rows that read
//    the KV head (row r = position r / g, head hk g + r % g) sit in the
//    block's shared memory, float32, scaled once by 1 / sqrt(dk), so the
//    warp reads each K/V row once for all of them (flash_fwd reads it once
//    a query head). Four rows at a time: R > 4 stages the chunk again
//    (from L2) for each further four.
//  * Staging: each warp has a ring of its own in shared memory, two stages
//    of a (K tile, V tile) pair. Its lanes fill a stage with 16-byte
//    cp.async copies where the rows are 16-byte aligned (zero-filled past
//    min(Sk, kv_valid_len) and past dk, dv), with element loads
//    otherwise; tile j + 2 is issued as soon as tile j is consumed, so the
//    next tile's copies overlap this one's arithmetic. A warp waits on no
//    other: __syncwarp, never a block barrier, in its loop.
//  * Q.K^T: each lane one key of the tile, its K row read from the stage
//    (K rows padded by 16 bytes, so the lanes' 16-byte reads spread over
//    the banks), the rows' dot products in float32 FMAs; the online
//    softmax by warp shuffles. P.V: the tile's weights through a slot of
//    the warp's in shared memory, each lane 4 columns (8 over 128) of
//    every V row of the stage.
//  * Designs measured before this one (PERF.md): the K/V tiles in a ring
//    shared by a block's 8 warps, two block barriers a tile (75 us at the
//    decode_32k rank); K/V rows loaded straight into registers, one warp
//    a chunk (40 us): a warp's round trips to memory in a row.
//  * Each chunk writes its partial per row into a float32 workspace the
//    wrapper allocates: the running max m, the denominator l and the
//    unnormalised accumulator. A chunk in which a row sees no key leaves m
//    at -1e30 and l, acc at 0: it weighs exp(-1e30 - M) = 0 in the combine.
//  * `flash_decode_combine`, a second launch on the same stream, combines
//    each row's chunks in chunk order: M = max m_c, then L = sum l_c
//    exp(m_c - M) and the accumulator sum, each taken over consecutive runs
//    of chunks by the block's threads and the runs added in order; out =
//    acc / max(L, 1e-30), lse = M + log(max(L, 1e-30)). The split does not
//    depend on whether the lse is asked for, so the output is the same bits
//    either way. No block waits on another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // chunks (warps) a block at most
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 64;         // Sq x g a block
constexpr int kTile = 32;            // keys a tile: one a lane
constexpr int kRW = 4;               // rows a pass of the warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  int sq, sk, hq, hkv, g, rows;
  long long q_sb, q_ss, q_sh;  // element strides of batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, q_offset, limit;  // limit = min(Sk, kv_valid_len)
  int dk, dv;
  float sqrt_dk, softcap;
  int t0, t1, tpc, chunks;  // tiles [t0, t1), tpc tiles a chunk
  int vec;                  // K/V rows 16-byte aligned: vector loads
};

template <typename TKV, int D>
struct Geo {
  static constexpr int kVec = 16 / sizeof(TKV);  // K elements a 16-byte load
  static constexpr int kPieces = D / kVec;        // 16-byte pieces a K row
  static constexpr int kGroups = D / 4;           // 4-column groups of V
  static constexpr int kCG = (kGroups + 31) / 32; // groups a lane
  static constexpr int kQS = D + 4;               // row stride of Q (floats)
};

// 16 bytes of a K row (4 float32 or 8 bf16), 4 columns of a V row (16 or
// 8 bytes), as read from a stage
template <typename TKV> struct Raw16;
template <> struct Raw16<float> { using T = float4; };
template <> struct Raw16<__nv_bfloat16> { using T = uint4; };
template <typename TKV> struct Raw4;
template <> struct Raw4<float> { using T = float4; };
template <> struct Raw4<__nv_bfloat16> { using T = uint2; };

// two bf16 packed in 32 bits as floats
__device__ __forceinline__ float lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ void floats(float4 x, float* f) {
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void floats(uint4 x, float* f) {
  f[0] = lo(x.x); f[1] = hi(x.x); f[2] = lo(x.y); f[3] = hi(x.y);
  f[4] = lo(x.z); f[5] = hi(x.z); f[6] = lo(x.w); f[7] = hi(x.w);
}
__device__ __forceinline__ void floats(uint2 x, float* f) {
  f[0] = lo(x.x); f[1] = hi(x.x); f[2] = lo(x.y); f[3] = hi(x.y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared without registers; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// a warp's ring: 2 stages of (K tile, V tile), then P of a tile
template <typename TKV, int D>
struct Ring {
  static constexpr int kKS = D + 16 / sizeof(TKV);  // K row stride: 16 B x odd
  static constexpr int kTileK = kTile * kKS;
  static constexpr int kStage = kTileK + kTile * D;  // elements a stage
  static constexpr int kBytes = 2 * kStage * sizeof(TKV) + kTile * kRW * 4;
  static constexpr int kWarpsB =  // warps a block: rings within 96 KB
      98304 / kBytes > kWarps ? kWarps : 98304 / kBytes < 1 ? 1
                                                        : 98304 / kBytes;
};

template <typename TKV, int D>
__device__ __forceinline__ void stage(TKV* sK, const TKV* kb, const TKV* vb,
                                      int key0, const DecodeArgs& a,
                                      int lane) {
  using G = Geo<TKV, D>;
  using R = Ring<TKV, D>;
  TKV* sV = sK + R::kTileK;
  if (a.vec) {
    for (int i = lane; i < kTile * G::kPieces; i += 32) {
      const int r = i / G::kPieces, c = (i - r * G::kPieces) * G::kVec;
      const int key = key0 + r;
      const bool ik = key < a.limit && c < a.dk, iv = key < a.limit && c < a.dv;
      cp_async16(sK + r * R::kKS + c, ik ? kb + key * a.k_ss + c : kb,
                 ik ? 16 : 0);
      cp_async16(sV + r * D + c, iv ? vb + key * a.v_ss + c : vb, iv ? 16 : 0);
    }
  } else {
    for (int i = lane; i < kTile * D; i += 32) {
      const int r = i / D, c = i - r * D;
      const int key = key0 + r;
      sK[r * R::kKS + c] = key < a.limit && c < a.dk ? kb[key * a.k_ss + c]
                                                     : zero<TKV>();
      sV[r * D + c] = key < a.limit && c < a.dv ? vb[key * a.v_ss + c]
                                                : zero<TKV>();
    }
  }
}

// The launch bounds ask for 2 blocks an SM (the rings' shared memory admits
// 1-3): given the block size alone, ptxas trimmed some instantiations to
// 64 registers and spilled
template <typename TKV, int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 2)
    flash_decode_kernel(const float* __restrict__ q,
                        const TKV* __restrict__ k, const TKV* __restrict__ v,
                        float* __restrict__ ws, DecodeArgs a) {
  using G = Geo<TKV, D>;
  using R = Ring<TKV, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // rows x kQS

  const int per = (a.chunks + R::kWarpsB - 1) / R::kWarpsB;
  const int item = blockIdx.x / per;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = (blockIdx.x - item * per) * R::kWarpsB + w;
  const int hk = item % a.hkv, b = item / a.hkv;
  TKV* ring = reinterpret_cast<TKV*>(smem + sizeof(float) * a.rows * G::kQS +
                                     w * R::kBytes);
  float* sP = reinterpret_cast<float*>(ring + 2 * R::kStage);

  for (int i = threadIdx.x; i < a.rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    sQ[r * G::kQS + d] =
        d < a.dk ? q[b * a.q_sb + (r / a.g) * a.q_ss +
                     (hk * a.g + r % a.g) * a.q_sh + d] / a.sqrt_dk
                 : 0.f;
  }
  __syncthreads();
  if (chunk >= a.chunks) return;

  const int tile_beg = a.t0 + chunk * a.tpc;
  const int n = min(a.tpc, a.t1 - tile_beg);
  const TKV* kb = k + b * a.k_sb + hk * a.k_sh;
  const TKV* vb = v + b * a.v_sb + hk * a.v_sh;
  const long long row0 = (static_cast<long long>(item) * a.chunks + chunk) *
                         a.rows;
  const long long n_rows =
      static_cast<long long>(gridDim.x / per) * a.chunks * a.rows;
  float* ws_acc = ws + row0 * D;
  float* ws_ml = ws + n_rows * D + row0 * 2;

  for (int r0 = 0; r0 < a.rows; r0 += kRW) {
    const int nr = min(kRW, a.rows - r0);
    float m[kRW], l[kRW], acc[kRW][G::kCG][4];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int x = 0; x < G::kCG; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][x][e] = 0.f;
    }
    stage<TKV, D>(ring, kb, vb, tile_beg * kTile, a, lane);
    cp_async_commit();
    if (n > 1)
      stage<TKV, D>(ring + R::kStage, kb, vb, (tile_beg + 1) * kTile, a,
                    lane);
    cp_async_commit();
    for (int j = 0; j < n; ++j) {
      cp_async_wait<1>();  // tile j landed (this lane's copies)
      __syncwarp();        // every lane's
      const TKV* tK = ring + (j & 1) * R::kStage;
      const TKV* tV = tK + R::kTileK;
      const int key = (tile_beg + j) * kTile + lane;

      float s[kRW];
#pragma unroll
      for (int r = 0; r < kRW; ++r) s[r] = 0.f;
      const TKV* krow = tK + lane * R::kKS;
#pragma unroll 2
      for (int p0 = 0; p0 < G::kPieces; ++p0) {
        float kf[G::kVec];
        floats(*reinterpret_cast<const typename Raw16<TKV>::T*>(
                   krow + p0 * G::kVec),
               kf);
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          if (r < nr) {
            const float* qr = sQ + (r0 + r) * G::kQS + p0 * G::kVec;
#pragma unroll
            for (int e = 0; e < G::kVec; e += 4) {
              const float4 x = *reinterpret_cast<const float4*>(qr + e);
              s[r] = fmaf(x.x, kf[e], s[r]);
              s[r] = fmaf(x.y, kf[e + 1], s[r]);
              s[r] = fmaf(x.z, kf[e + 2], s[r]);
              s[r] = fmaf(x.w, kf[e + 3], s[r]);
            }
          }
        }
      }
      float p[kRW];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        p[r] = 0.f;
        if (r < nr) {
          const int qpos = a.q_offset + (r0 + r) / a.g;
          float x = s[r];
          if constexpr (kCap)
            x = __fmul_rn(tanhf(__fdiv_rn(x, a.softcap)), a.softcap);
          const bool ok = key < a.limit && (!a.causal || key <= qpos) &&
                          (a.window <= 0 || qpos - key < a.window);
          float mx = ok ? x : kNegInf;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
          const float m_new = fmaxf(m[r], mx);
          const float corr = expf(m[r] - m_new);
          p[r] = ok ? expf(x - m_new) : 0.f;
          float ps = p[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            ps += __shfl_xor_sync(kFull, ps, off);
          l[r] = l[r] * corr + ps;
          m[r] = m_new;
#pragma unroll
          for (int x2 = 0; x2 < G::kCG; ++x2)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][x2][e] *= corr;
        }
      }
      *reinterpret_cast<float4*>(sP + lane * kRW) =
          make_float4(p[0], p[1], p[2], p[3]);
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < kTile; ++c) {
        const float4 pc = *reinterpret_cast<const float4*>(sP + c * kRW);
#pragma unroll
        for (int x = 0; x < G::kCG; ++x) {
          const int d = 4 * (lane + 32 * x);
          if (d < D) {
            float vf[4];
            floats(*reinterpret_cast<const typename Raw4<TKV>::T*>(
                       tV + c * D + d),
                   vf);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[0][x][e] = fmaf(pc.x, vf[e], acc[0][x][e]);
              acc[1][x][e] = fmaf(pc.y, vf[e], acc[1][x][e]);
              acc[2][x][e] = fmaf(pc.z, vf[e], acc[2][x][e]);
              acc[3][x][e] = fmaf(pc.w, vf[e], acc[3][x][e]);
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the stage and P
      if (j + 2 < n)
        stage<TKV, D>(ring + (j & 1) * R::kStage, kb, vb,
                      (tile_beg + j + 2) * kTile, a, lane);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      if (r < nr) {
#pragma unroll
        for (int x = 0; x < G::kCG; ++x) {
          const int d = 4 * (lane + 32 * x);
          if (d < D)
            *reinterpret_cast<float4*>(ws_acc + (r0 + r) * D + d) =
                make_float4(acc[r][x][0], acc[r][x][1], acc[r][x][2],
                            acc[r][x][3]);
        }
        if (lane == 0) {
          ws_ml[2 * (r0 + r)] = m[r];
          ws_ml[2 * (r0 + r) + 1] = l[r];
        }
      }
    }
  }
}

struct CombineArgs {
  int sq, hq, hkv, g, rows, chunks, d, dv;  // d: the acc's row stride
};

constexpr int kCombine = 256;  // threads a combine block: one row

// One block a query row (see the top): M over every chunk, then each
// thread (run s, 4 columns) sums a run of consecutive chunks in order, and
// the runs are added in order.
__global__ void __launch_bounds__(kCombine)
    flash_decode_combine(const float* __restrict__ ws, float* __restrict__ o,
                         float* __restrict__ lse, CombineArgs a) {
  __shared__ float red[kCombine * 5];
  __shared__ float top[kCombine / 32];
  const int item = blockIdx.x / a.rows, r = blockIdx.x % a.rows;
  const int hk = item % a.hkv, b = item / a.hkv;
  const int i = r / a.g, h = hk * a.g + r % a.g;
  const long long first = static_cast<long long>(item) * a.chunks * a.rows +
                          r;  // the partial row of chunk 0
  const long long n_rows = static_cast<long long>(gridDim.x) * a.chunks;
  const long long step = a.rows;  // rows from one chunk to the next
  const float* acc = ws + first * a.d;
  const float* ml = ws + n_rows * a.d + first * 2;
  const int t = threadIdx.x;

  float big = kNegInf;
  for (int c = t; c < a.chunks; c += kCombine)
    big = fmaxf(big, ml[2 * c * step]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    big = fmaxf(big, __shfl_xor_sync(kFull, big, off));
  if ((t & 31) == 0) top[t >> 5] = big;
  __syncthreads();
  big = top[0];
#pragma unroll
  for (int x = 1; x < kCombine / 32; ++x) big = fmaxf(big, top[x]);

  const int groups = (a.dv + 3) / 4;
  const int runs = kCombine / groups;  // >= 1: dv <= 256 has <= 64 groups
  const int run = t / groups, cg = t - run * groups;
  const int per = (a.chunks + runs - 1) / runs;
  float den = 0.f, x[4] = {0.f, 0.f, 0.f, 0.f};
  if (run < runs) {
    const int c_end = min(a.chunks, (run + 1) * per);
#pragma unroll 4
    for (int c = run * per; c < c_end; ++c) {
      const float wc = expf(ml[2 * c * step] - big);
      den += ml[2 * c * step + 1] * wc;
      const float4 y =
          *reinterpret_cast<const float4*>(acc + c * step * a.d + 4 * cg);
      x[0] += y.x * wc;
      x[1] += y.y * wc;
      x[2] += y.z * wc;
      x[3] += y.w * wc;
    }
    red[5 * t] = den;
#pragma unroll
    for (int e = 0; e < 4; ++e) red[5 * t + 1 + e] = x[e];
  }
  __syncthreads();
  if (t < groups) {
    den = red[0];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = red[5 * t + 1 + e];
    for (int s = 1; s < runs; ++s) {
      den += red[5 * s * groups];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] += red[5 * (s * groups + t) + 1 + e];
    }
    den = fmaxf(den, 1e-30f);
    float* orow =
        o + ((static_cast<long long>(b) * a.sq + i) * a.hq + h) * a.dv;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * t + e < a.dv) orow[4 * t + e] = x[e] / den;
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * a.hq + h) * a.sq + i] =
          big + logf(den);
  }
}

template <typename TKV, int D, bool kCap>
int launch(const float* q, const void* k, const void* v, float* o,
           float* lse, float* ws, int b, const DecodeArgs& a,
           cudaStream_t stream) {
  using R = Ring<TKV, D>;
  auto kernel = flash_decode_kernel<TKV, D, kCap>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * kMaxRows * Geo<TKV, D>::kQS +
                       R::kWarpsB * R::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(b) * a.hkv *
                          ((a.chunks + R::kWarpsB - 1) / R::kWarpsB);
  const size_t smem = sizeof(float) * a.rows * Geo<TKV, D>::kQS +
                      R::kWarpsB * R::kBytes;
  kernel<<<blocks, 32 * R::kWarpsB, smem, stream>>>(
      q, static_cast<const TKV*>(k), static_cast<const TKV*>(v), ws, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const CombineArgs c{a.sq, a.hq, a.hkv, a.g, a.rows, a.chunks, D, a.dv};
  flash_decode_combine<<<static_cast<unsigned>(b) * a.hkv * a.rows,
                         kCombine, 0, stream>>>(ws, o, lse, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, bool kCap>
int launch_d(const float* q, const void* k, const void* v, float* o,
             float* lse, float* ws, int b, int d, const DecodeArgs& a,
             cudaStream_t s) {
  switch (d) {
    case 64: return launch<TKV, 64, kCap>(q, k, v, o, lse, ws, b, a, s);
    case 80: return launch<TKV, 80, kCap>(q, k, v, o, lse, ws, b, a, s);
    case 96: return launch<TKV, 96, kCap>(q, k, v, o, lse, ws, b, a, s);
    case 128: return launch<TKV, 128, kCap>(q, k, v, o, lse, ws, b, a, s);
    case 160: return launch<TKV, 160, kCap>(q, k, v, o, lse, ws, b, a, s);
    case 256: return launch<TKV, 256, kCap>(q, k, v, o, lse, ws, b, a, s);
    default: return -1;
  }
}

// 16-byte aligned rows: the base and the batch, sequence and head strides
bool rows_aligned(const void* p, long long sb, long long ss, long long sh,
                  int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb * elem % 16 == 0 &&
         ss * elem % 16 == 0 && sh * elem % 16 == 0;
}

// the instantiation that holds a head of max(dk, dv) columns (0: none)
int padded_dim(int dk, int dv) {
  static const int dims[] = {64, 80, 96, 128, 160, 256};
  const int need = dk > dv ? dk : dv;
  for (int d : dims)
    if (need <= d) return d;
  return 0;
}

}  // namespace

// q float32 (B, Sq, Hq, dk); k, v (B, Sk, Hkv, dk / dv) of one type
// (kv_bf16: 1 bf16, 0 float32); o float32 (B, Sq, Hq, dv), contiguous; lse
// null or float32 (B, Hq, Sq); ws float32, B Hkv chunks Sq g (D + 2)
// elements, D the instantiation. The split (t0, t1, tpc, chunks) is
// kernels/flash_attn.py `decode_design`'s: tiles [t0, t1) of 32 keys, tpc a
// chunk. Needs Sq (Hq / Hkv) <= 64 and dk, dv <= 256 (run in the smallest of
// 64, 80, 96, 128, 160, 256 that holds both); anything else returns -1
// without a launch. Returns the CUDA error of the launches (0 on success).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* ws, int kv_bf16, int b, int sq, int sk, int hq, int hkv, int dk,
    int dv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, int q_offset, int kv_valid,
    float sqrt_dk, float softcap, int t0, int t1, int tpc, int chunks,
    void* stream) {
  if (!(softcap >= 0.f) || isinf(softcap)) return -1;
  if (hkv < 1 || hq % hkv || sq < 1 || sq * (hq / hkv) > kMaxRows) return -1;
  if (chunks < 1 || tpc < 1 || t0 < 0 || t1 <= t0 ||
      (long long)(chunks - 1) * tpc >= t1 - t0 ||
      (long long)chunks * tpc < t1 - t0)
    return -1;
  const int d = padded_dim(dk, dv);
  if (d == 0) return -1;
  const int elem = kv_bf16 ? 2 : 4, vec = 16 / elem;
  const DecodeArgs a{sq, sk, hq, hkv, hq / hkv, sq * (hq / hkv), q_sb, q_ss,
                     q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
                     window, q_offset, sk < kv_valid ? sk : kv_valid, dk, dv,
                     sqrt_dk, softcap, t0, t1, tpc, chunks,
                     rows_aligned(k, k_sb, k_ss, k_sh, elem) &&
                         rows_aligned(v, v_sb, v_ss, v_sh, elem) &&
                         dk % vec == 0 && dv % vec == 0};
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  float* wf = static_cast<float*>(ws);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f)
    return kv_bf16 ? launch_d<__nv_bfloat16, true>(qf, k, v, of, lf, wf, b,
                                                   d, a, s)
                   : launch_d<float, true>(qf, k, v, of, lf, wf, b, d, a, s);
  return kv_bf16 ? launch_d<__nv_bfloat16, false>(qf, k, v, of, lf, wf, b, d,
                                                  a, s)
                 : launch_d<float, false>(qf, k, v, of, lf, wf, b, d, a, s);
}
