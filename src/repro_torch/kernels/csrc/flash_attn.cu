// flash_attention: the attention forward of every prefill of the LM stack,
// softmax(q k^T / sqrt(dk) + mask) v per query head, online over KV tiles.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (repro/kernels/flash_attn.py, `_flash_fwd_kernel`) and, through the port's
// `attend`, the blockwise scan it stands for (repro/models/attention.py
// `_flash_fwd`). Beyond the TPU kernel's causal mask and q_offset it takes
// the masks of the function it replaces: key j is valid for the query at
// absolute position p = q_offset + i when j < kv_valid_len, j <= p if
// causal, and p - j < window if window > 0. GQA reads KV head h / g for
// query head h; K and V are not repeated. The output is written in q's type
// and, when asked for (the training path's residual), each row's
// logsumexp of its scaled, masked scores in float32 (`store_lse`), from
// the running max and denominator every route holds anyway.
//
// Two routes, chosen by q's type in flash_attn_launch (not a fallback: a
// launch of either route that fails returns its error):
//
//  * bf16 q (every prefill of the serving path): `flash_tc_kernel`, on the
//    tensor cores. Its plain twin is ref.py `flash_attention_ref(...,
//    operands=torch.bfloat16)`: q, K and V in bf16 (the serving path's
//    float32 cache holds bf16-exact values, so only P is new), S = q.K^T
//    summed in float32 and then scaled by log2(e)/sqrt(dk) in float32,
//    p = exp2(t - m) in float32 with m the running max at the same 64-key
//    tiles, l summed from the float32 p, and P rounded to bf16 for the P.V
//    product only. This is what the JAX package's einsums at DEFAULT
//    precision computed on the TPU (bf16 operands, float32 sums).
//  * float32 q: `flash_fwd_kernel`, the CUDA-core kernel in float32
//    throughout, plain version `flash_attention_ref` with the default
//    operands. kernels/flash_attn.py sends it only the calls whose query
//    rows that read one KV head exceed 64 (Sq x Hq / Hkv); the others, the
//    decode step over a sequence-split cache among them, take the split-KV
//    kernel of flash_decode.cu.
//
// What bounds it on an H100: at the serving path's prefill shapes (B = 8,
// S = 2048, 32 query heads over 8 KV heads, head_dim 80) the operations,
// 4 * B * Hq * hd * (valid keys summed over the rows) ~ 1.7e11 a layer, or
// 0.17 ms at the 989 TFLOP/s bf16 tensor-core rate; the bytes (q, K, V read
// once, the output written once) ~ 0.25 GB, or 0.08 ms.
//
// The tensor-core design (sm_90a): one block of three warpgroups per work
// item, 128 query rows that share their KV tiles: gh query heads of one KV
// head (4, 2 or 1, the largest that divides the GQA group) at 128 / gh
// positions each, so each tile is staged once for gh heads. Blocks go in
// (batch row, KV head, query block, head set) order, the heaviest query
// blocks of each KV head (the last rows, under a causal mask) first, so the
// blocks in flight share a few KV heads' tiles in L2. Tiles of 64 keys that
// no row of the item can see are never loaded.
// Warpgroup 0 is the producer; full and empty mbarriers order it against
// the consumers. bf16 K/V: cp.async (16 bytes a thread, no registers) into
// a ring of 4 stages, the full barrier counting the landings. float32 K/V
// (the serving path's cache): cp.async into 2 float32 staging tiles, which
// the producer converts (round to nearest even) into a ring of 2 bf16
// stages. TMA is not used: it cannot convert types, and it would ask
// 16-byte-aligned strides of the callers (rows that are not aligned take
// element loads through registers here instead).
// Warpgroups 1 and 2 each own 64 item rows: S = Q.K^T by `wgmma` m64n64k16
// with Q (staged once a block) and K read from shared memory; the online
// softmax in float32 registers (ex2.approx of the log2e-scaled scores;
// masks only in tiles that straddle the causal diagonal, the window edge or
// kv_valid_len); O += P.V by `wgmma` m64n{hd}k16 with P from registers (the
// S accumulator's layout is the A operand's, so P never touches shared
// memory) and V read in wgmma's transposed-B form. The softmax of tile j
// runs while the tensor cores do P.V of tile j - 1.
// Shared memory layout: every bf16 tile is stored as 8x8 "core matrices" of
// 16 bytes a row (wgmma's no-swizzle canonical layout), row-group major:
// element (r, c) of a tile with hd columns sits at ((r/8)*(hd/8) + c/8)*64 +
// (r%8)*8 + c%8. That layout holds any hd that is a multiple of 8, so head
// dim 80 (160 bytes a row, not a whole number of the 128-byte swizzle atom)
// needs neither the 32-byte swizzle nor padding; a core matrix is 128
// contiguous bytes, so wgmma reads it without bank conflicts. K and V use
// the same layout: K is read K-major (the leading offset steps along hd), V
// MN-major (the leading offset steps along the keys).
// What bounds it now (NVIDIA H100, layer 0 of the serving path): staging
// the K/V tiles, 2.7 GB of float32 a layer read from L2 by the 4,096 items;
// the tensor cores run at ~15% of their rate (PERF.md).
//
// Head dim 160 (stablelm-12b) is the same kernel at D = 160: wgmma
// m64n160k16 for P.V (80 float32 accumulators a thread, beside S's 32),
// Q.K^T in 10 steps of 16, one float32 staging tile in flight instead of
// two so that the block fits its shared memory (200 KB).
//
// The float32-q design (CUDA cores): one block of 256 threads
// per (64 query rows, query head, batch row); the Q tile (scaled), K, V and
// P tiles in float32 shared memory, float32 FMAs on CUDA cores.
//
// Head dims: both routes run any dk, dv up to 256 in the smallest
// instantiation (64, 80, 96, 128, 160, 256) that holds both; the extra
// columns are staged as zeros (element loads with a column limit), which
// add exact zeros to Q.K^T, and the output is written at its real dv. The
// smoke configs of the LM stack (head dims 8, 12, 16; MLA's 40 / 32) take
// it.
//
// Head dim 256 (recurrentgemma-9b's local attention: 16 query heads over one
// KV head, a window of 2,048) runs on the tensor cores in the wide kernel,
// `flash_wide_kernel<TKV, kCap>`, and (dk, dv) = (576, 512), MLA's absorbed
// attention (deepseek-v2-lite: q_all of 16 heads against one latent head, V
// the latent cache's first 512 columns), in the split-dv kernel,
// `flash_mla_kernel<TKV, kCap>` (their designs are beside them). Both are a
// producer warpgroup and two consumer warpgroups (384 threads, one block an
// SM; setmaxnreg gives the producer 40 registers and each consumer 232 of
// the 168 a thread starts with).
// What bounds them on an H100 at the serving path's prefills: the
// operations. hd 256 (B = 8, S = 3,072, window 2,048): 4 B Hq hd x
// 4,195,328 windowed causal keys = 550 GFLOP, 0.556 ms at 989 TFLOP/s; the
// bytes (q, K, V once, the output) 0.13 ms. MLA (B = 8, S = 2,048, causal):
// 2 B Hq (dk + dv) x 2,098,176 valid keys = 584 GFLOP, 0.59 ms; the bytes
// (q, the latent cache once, the output) 0.59 GB, 0.18 ms.
// What they stage from L2 there (kernels/cost.py `flash_staged_bytes`,
// tests/test_torch_flash_staging.py): the 64-row blocks of the design
// before (warpgroup 0 alone computed S and the softmax while warpgroup 1
// waited; all 256 threads staged by cp.async, two stages) staged 4.98 GB of
// latent tiles for MLA and 8.86 GB of K/V for hd 256. Now each tile comes
// by TMA once for a cluster pair of neighbouring blocks (multicast): MLA
// 2.49 GB (64-row blocks: O is 64 x 512), hd 256 2.21 GB (128-row blocks,
// a quarter). Shared memory: 214,624 bytes a block at MLA's width (Q's
// first 448 columns, two latent tiles, the P tile), 197,728 at 256 (Q's
// 128 rows, two K and two V tiles). Measured times, the limits that hold
// them and the ablations behind the design are in PERF.md.
// The float32 route runs hd 256 on the CUDA cores (213,760 bytes of shared
// memory a block).

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Args {
  int sq, sk, hq, hkv;
  long long q_sb, q_ss, q_sh;  // element strides of batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, q_offset, kv_valid;
  float sqrt_dk;
  float scale_log2;  // log2(e) / sqrt(dk), rounded once to float32
  int q_vec, kv_vec;  // rows start on 16-byte boundaries
  int dk, dv;         // the real head dims (the instantiation may be wider)
  int v_alias;        // v is the first dv columns of k's own rows
  float softcap;      // > 0: a scaled score s becomes softcap tanh(s / softcap)
  float cap_inv;      // 1 / (sqrt(dk) softcap), rounded once to float32
  float cap_log2;     // log2(e) softcap, rounded once to float32
  float* lse;         // (B, Hq, Sq) row logsumexp of the scaled, masked
                      // scores, natural log; null when not asked for
};

constexpr float kLn2 = 0.6931471805599453f;

// the row logsumexp at (batch b, head h, position p): m and the
// denominator l of the online softmax, m in the units of the exponent
// (natural for the CUDA-core kernel, log2 for the tensor-core kernels)
__device__ __forceinline__ void store_lse(const Args& a, int b, int h, int p,
                                          float m, float den, bool log2) {
  a.lse[(static_cast<long long>(b) * a.hq + h) * a.sq + p] =
      log2 ? __fmul_rn(m + log2f(den), kLn2) : m + logf(den);
}

// The attention softcap (repro/models/attention.py `_flash_fwd`: s =
// tanh(s / cap) cap, after the 1 / sqrt(dk) scale and before the mask).
// The CUDA-core kernel caps its scaled score; the tensor-core kernels turn
// the raw sum S into the capped score in log2 units, log2(e) cap tanh(S /
// (sqrt(dk) cap)), through the two float32 constants of Args, each product
// rounded on its own (the twin, ref.py `_flash_scan`, rounds alike). tanhf
// is the accurate one (2 ulp), not tanh.approx.f32 (2^-11): the bounds of
// ref.py take its error. The running max, the log2 units of the lse and the
// masks are unchanged: a capped score is one more score.
__device__ __forceinline__ float cap_scaled(const Args& a, float s) {
  return __fmul_rn(tanhf(__fdiv_rn(s, a.softcap)), a.softcap);
}
__device__ __forceinline__ float cap_log2(const Args& a, float raw) {
  return __fmul_rn(tanhf(__fmul_rn(raw, a.cap_inv)), a.cap_log2);
}

// ---------------------------------------------------------------------------
// float32 q: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: tx picks keys/columns, ty rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
template <int DK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (DK + 1) + kBK * (DK + 1) + kBK * DV + kBQ * (kBK + 1));
}

template <typename TQ, typename TKV, int DK, int DV, bool kCap>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, TQ* __restrict__ o, Args a) {
  static_assert(DV % 16 == 0, "dv must be a multiple of 16");
  constexpr int kCols = DV / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                   // kBQ x (DK + 1)
  float* sK = sQ + kBQ * (DK + 1);    // kBK x (DK + 1)
  float* sV = sK + kBK * (DK + 1);    // kBK x DV
  float* sP = sV + kBK * DV;          // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const TQ* qb = q + b * a.q_sb + h * a.q_sh;
  for (int i = tid; i < kBQ * DK; i += kThreads) {
    const int r = i / DK, d = i - r * DK;
    sQ[r * (DK + 1) + d] = q0 + r < a.sq && d < a.dk
                               ? to_float(qb[(q0 + r) * a.q_ss + d]) / a.sqrt_dk
                               : 0.f;
  }

  // the KV tiles some row of this block can see
  const int rows = min(kBQ, a.sq - q0);
  const int qp_lo = a.q_offset + q0, qp_hi = a.q_offset + q0 + rows - 1;
  int kv_end = min(a.sk, a.kv_valid);
  if (a.causal) kv_end = min(kv_end, qp_hi + 1);
  const int kv_begin = a.window > 0 ? max(0, qp_lo - a.window + 1) : 0;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const TKV* kb = k + b * a.k_sb + hk * a.k_sh;
  const TKV* vb = v + b * a.v_sb + hk * a.v_sh;
  for (int kv0 = kv_begin / kBK * kBK; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and sQ written)
    for (int i = tid; i < kBK * DK; i += kThreads) {
      const int c = i / DK, d = i - c * DK;
      sK[c * (DK + 1) + d] = kv0 + c < a.sk && d < a.dk
                                 ? to_float(kb[(kv0 + c) * a.k_ss + d])
                                 : 0.f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int c = i / DV, d = i - c * DV;
      sV[c * DV + d] = kv0 + c < a.sk && d < a.dv
                           ? to_float(vb[(kv0 + c) * a.v_ss + d])
                           : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * (DK + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * (DK + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    if constexpr (kCap) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = cap_scaled(a, s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = a.q_offset + q0 + r;
      bool ok[4];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + tx + 16 * j;
        ok[j] = kp < a.sk && kp < a.kv_valid && (!a.causal || kp <= qpos) &&
                (a.window <= 0 || qpos - kp < a.window);
        if (ok[j]) tile_max = fmaxf(tile_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[r * (kBK + 1) + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int n = 0; n < kCols; ++n) vv[n] = sV[c * DV + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < kCols; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && tx == 0) store_lse(a, b, h, r, m[i], den, false);
    TQ* orow = o + ((static_cast<long long>(b) * a.sq + r) * a.hq + h) * a.dv;
#pragma unroll
    for (int n = 0; n < kCols; ++n)
      if (tx + 16 * n < a.dv) store(orow + tx + 16 * n, acc[i][n] / den);
  }
}


// ---------------------------------------------------------------------------
// bf16 q: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;     // query rows per block, 64 a consumer
constexpr int kTcKeys = 64;      // keys per KV tile
constexpr int kTcThreads = 384;  // producer + two consumer warpgroups

// Stages of the bf16 K/V ring: 4 for bf16 K/V, which cp.async fills in
// place; 2 for float32 K/V, converted from kPreOf<D> float32 staging tiles
// that cp.async fills: 2 up to hd = 128 (the most that fits there: 224 KB),
// 1 at hd = 160 (200 KB; two would take 280 KB, more than a block may hold).
template <typename TKV>
constexpr int kStagesOf = sizeof(TKV) == 2 ? 4 : 2;
template <int D>
constexpr int kPreOf = D > 128 ? 1 : 2;

// Row pitch (floats) of a float32 staging tile: hd / 4 16-byte units a row,
// XOR-swizzled by row within groups of 8 units where hd / 4 is a multiple of
// 8, else (hd = 80) padded by one unit; either way the 8 rows that a quarter
// warp converts sit in 8 distinct 16-byte bank groups.
template <int D>
constexpr int kPitch = (D / 4) % 8 == 0 ? D : D + 4;
template <int D>
__device__ __forceinline__ int staged(int r, int c4) {  // float offset
  return r * kPitch<D> + 4 * ((D / 4) % 8 == 0 ? c4 ^ (r & 7) : c4);
}

template <typename TKV, int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (kTcRows * D + 2 * kStagesOf<TKV> * kTcKeys * D) +
         (sizeof(TKV) == 4
              ? kPreOf<D> * 2 * kTcKeys * kPitch<D> * sizeof(float)
              : 0) +
         2 * kStagesOf<TKV> * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// release: the caller's shared-memory writes are seen by the waiters
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// until the phase of the given parity has completed (acquire)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// shared-memory writes of this thread become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 2^x to ~2 ulp, subnormal results flushed to zero (ex2.approx.ftz)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving register reads and writes across wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of the no-swizzle layout: lbo and sbo are
// the byte offsets between core matrices along the leading dimension and
// along the strided one
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// element offset of (r, c), c a multiple of 8, in a core-matrix tile of D
// columns
template <int D>
__device__ __forceinline__ int cm_off(int r, int c) {
  return ((r >> 3) * (D / 8) + (c >> 3)) * 64 + (r & 7) * 8;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The first n of 8 consecutive elements as bf16 by element loads, the
// others (all of them when n <= 0) zeros: the columns past a head dim that
// is padded to the instantiation's. float32 is rounded to nearest even.
__device__ __forceinline__ uint4 load8n(const __nv_bfloat16* p, int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (2 * i < n ? static_cast<uint32_t>(s[2 * i]) : 0u) |
           (2 * i + 1 < n ? static_cast<uint32_t>(s[2 * i + 1]) << 16 : 0u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 load8n(const float* p, int n) {
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = i < n ? p[i] : 0.f;
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}
// 8 consecutive elements as bf16; vec: p is 16-byte aligned
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  return load8n(p, 8);
}

// Rows row0 .. row0 + 63 of a K or V whose rows do not start on 16-byte
// boundaries, or are narrower than D (`cols` real columns, the rest
// zeros), into a bf16 core-matrix tile (rows at or past `lim` are zeros),
// element loads through registers, by the 128 threads of a warpgroup,
// t = 0..127. The row index is fastest across threads, so a quarter warp's
// 16-byte stores hit eight distinct bank groups.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const T* src,
                                           long long ss, int row0, int lim,
                                           int cols, int t) {
  constexpr int kPer = kTcKeys * D / 8 / 128;
  uint4 x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = t + 128 * i;
    const int r = (u & 7) + 8 * (u / D);  // D chunk slots per 8 rows
    const int c = ((u >> 3) % (D / 8)) * 8;
    x[i] = row0 + r < lim ? load8n(src + (row0 + r) * ss + c, cols - c)
                          : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = t + 128 * i;
    const int r = (u & 7) + 8 * (u / D);
    const int c = ((u >> 3) % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + cm_off<D>(r, c)) = x[i];
  }
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
// one arrival on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Rows row0 .. row0 + 63 of a bf16 K or V (rows at or past lim zeros)
// straight into their core-matrix slots, by cp.async (16-byte aligned rows).
// Lanes 2k and 2k + 1 copy the two halves of one 32-byte sector of a row.
template <int D>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long ss, int row0, int lim,
                                            int t) {
#pragma unroll
  for (int i = 0; i < kTcKeys * D / 8 / 128; ++i) {
    const int u = t + 128 * i;
    const int rest = u >> 4;
    const int r = (rest / (D / 16)) * 8 + ((u >> 1) & 7);
    const int c = (2 * (rest % (D / 16)) + (u & 1)) * 8;
    const bool in = row0 + r < lim;
    cp_async16(dst + cm_off<D>(r, c), in ? src + (row0 + r) * ss + c : src,
               in ? 16 : 0);
  }
}

// Rows row0 .. row0 + 63 of a float32 K or V into a staging tile, row by
// row (consecutive lanes on consecutive 16 bytes of a row), by cp.async.
template <int D>
__device__ __forceinline__ void stage_async_f32(float* slot, const float* src,
                                                long long ss, int row0,
                                                int lim, int t) {
#pragma unroll
  for (int i = 0; i < kTcKeys * D / 4 / 128; ++i) {
    const int u = t + 128 * i;
    const int r = u / (D / 4), c4 = u % (D / 4);
    const bool in = row0 + r < lim;
    cp_async16(slot + staged<D>(r, c4),
               in ? src + (row0 + r) * ss + 4 * c4 : src, in ? 16 : 0);
  }
}

// A staging tile into its bf16 core-matrix tile, 8 floats a chunk, the row
// index fastest across lanes.
template <int D>
__device__ __forceinline__ void convert_staged(__nv_bfloat16* dst,
                                               const float* slot, int t) {
#pragma unroll
  for (int i = 0; i < kTcKeys * D / 8 / 128; ++i) {
    const int u = t + 128 * i;
    const int r = (u & 7) + 8 * (u / D);
    const int c = ((u >> 3) % (D / 8)) * 8;
    const float4 x =
        *reinterpret_cast<const float4*>(slot + staged<D>(r, c / 4));
    const float4 y =
        *reinterpret_cast<const float4*>(slot + staged<D>(r, c / 4 + 1));
    *reinterpret_cast<uint4*>(dst + cm_off<D>(r, c)) =
        make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                   pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
  }
}

// wgmma m64nNk16, bf16 x bf16 -> float32: S = Q K^T (both operands in
// shared memory, K-major) and O += P V (P in registers, V MN-major)

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}"
      ", {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// O += P V over 256 output columns with P read from shared memory (K-major)
// and V in its transposed (MN-major) form: the latent attention's P.V, half
// of dv a warpgroup
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}"
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[4], uint64_t v) {
  if constexpr (D == 64) wgmma_rs_n64(o, p, v);
  else if constexpr (D == 80) wgmma_rs_n80(o, p, v);
  else if constexpr (D == 96) wgmma_rs_n96(o, p, v);
  else if constexpr (D == 128) wgmma_rs_n128(o, p, v);
  else wgmma_rs_n160(o, p, v);
}

template <typename TKV, int D, bool kCap>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const TKV* __restrict__ k, const TKV* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, Args a) {
  static_assert(D % 16 == 0 && D <= 160, "head dim");
  constexpr int kTile = kTcKeys * D;  // elements of one K or V stage
  constexpr int kS = kStagesOf<TKV>;
  constexpr int kPre = kPreOf<D>;     // float32 K/V tiles in flight
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTcRows * D;
  __nv_bfloat16* sV = sK + kS * kTile;
  float* staging = reinterpret_cast<float*>(sV + kS * kTile);
  constexpr int kStaged = kTcKeys * kPitch<D>;  // floats of a staging tile
  uint64_t* full = reinterpret_cast<uint64_t*>(
      staging + (sizeof(TKV) == 4 ? kPre * 2 * kStaged : 0));
  uint64_t* empty = full + kS;

  // A block serves gh query heads of one KV head (4, 2 or 1: the largest
  // that divides the group), rows_h = 128 / gh positions each, so each KV
  // tile is staged once for gh heads. Block row r is head h0 + r / rows_h
  // at position q0 + r % rows_h. Block x -> (batch row, KV head, query
  // block, head set), the last fastest: the blocks in flight share a few KV
  // heads' tiles in L2, and each KV head's heaviest query blocks (the last
  // rows) go first.
  const int g = a.hq / a.hkv;
  const int gh = g % 4 == 0 ? 4 : g % 2 == 0 ? 2 : 1;
  const int rows_h = kTcRows / gh;
  const int n_qb = (a.sq + rows_h - 1) / rows_h;
  int x = blockIdx.x;
  const int h_set = x % (g / gh);
  x /= g / gh;
  const int q0 = (n_qb - 1 - x % n_qb) * rows_h;
  x /= n_qb;
  const int hk = x % a.hkv;
  const int b = x / a.hkv;
  const int h0 = hk * g + h_set * gh;
  const int tid = threadIdx.x;

  // the KV tiles some row of this block can see
  const int qp_lo = a.q_offset + q0;
  const int qp_hi = a.q_offset + min(q0 + rows_h, a.sq) - 1;
  const int kv_lim = min(a.sk, a.kv_valid);
  const int kv_end = a.causal ? min(kv_lim, qp_hi + 1) : kv_lim;
  const int first =
      (a.window > 0 ? max(0, qp_lo - a.window + 1) : 0) / kTcKeys * kTcKeys;
  const int n_tiles = (kv_end - first + kTcKeys - 1) / kTcKeys;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 128);  // every producer thread
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer: K and V tiles into the ring
    const TKV* kb = k + b * a.k_sb + hk * a.k_sh;
    const TKV* vb = v + b * a.v_sb + hk * a.v_sh;
    if (!a.kv_vec) {
      // rows not on 16-byte boundaries: element loads through registers
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kS;
        if (it >= kS) mbar_wait(&empty[s], (it / kS - 1) & 1);
        const int kv0 = first + it * kTcKeys;
        stage_rows<D>(sK + s * kTile, kb, a.k_ss, kv0, kv_lim, a.dk, tid);
        stage_rows<D>(sV + s * kTile, vb, a.v_ss, kv0, kv_lim, a.dv, tid);
        fence_async_smem();
        mbar_arrive(&full[s]);
      }
    } else if constexpr (sizeof(TKV) == 2) {
      // bf16: cp.async into the ring, the full barrier counts the landings
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kS;
        if (it >= kS) mbar_wait(&empty[s], (it / kS - 1) & 1);
        const int kv0 = first + it * kTcKeys;
        stage_async<D>(sK + s * kTile, kb, a.k_ss, kv0, kv_lim, tid);
        stage_async<D>(sV + s * kTile, vb, a.v_ss, kv0, kv_lim, tid);
        cp_async_arrive(&full[s]);
      }
    } else {
      // float32: kPre tiles in flight to staging by cp.async, converted
      // into the bf16 ring by the whole warpgroup
      auto fetch = [&](int it) {
        if (it < n_tiles) {
          float* slot = staging + (it % kPre) * 2 * kStaged;
          const int kv0 = first + it * kTcKeys;
          stage_async_f32<D>(slot, kb, a.k_ss, kv0, kv_lim, tid);
          stage_async_f32<D>(slot + kStaged, vb, a.v_ss, kv0, kv_lim, tid);
        }
        cp_async_commit();
      };
      for (int it = 0; it < kPre; ++it) fetch(it);
      for (int it = 0; it < n_tiles; ++it) {
        cp_async_wait<kPre - 1>();  // this thread's copies of tile it
        warpgroup_sync(3);          // and everyone's
        const int s = it % kS;
        if (it >= kS) mbar_wait(&empty[s], (it / kS - 1) & 1);
        const float* slot = staging + (it % kPre) * 2 * kStaged;
        convert_staged<D>(sK + s * kTile, slot, tid);
        convert_staged<D>(sV + s * kTile, slot + kStaged, tid);
        fence_async_smem();
        mbar_arrive(&full[s]);
        warpgroup_sync(3);  // the slot is read: refill it
        fetch(it + kPre);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: warpgroup w (0 or 1) owns block rows 64 w .. 64 w + 63,
  // whose positions are wg_p0 .. wg_p0 + wg_n - 1 (wg_n <= 0: none)
  const int w = tid / 128 - 1;
  const int tw = tid & 127;
  const int lane = tid & 31;
  const int wg_p0 = q0 + (rows_h == kTcRows ? 64 * w : 0);
  const int wg_n = min(min(64, rows_h), a.sq - wg_p0);
  const int wp_lo = a.q_offset + wg_p0, wp_hi = wp_lo + wg_n - 1;
  // this thread's two accumulator rows r_in + 8 i (i = 0, 1), their
  // absolute positions, and its column pair
  const int r_in = 16 * (tw >> 5) + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = a.q_offset + q0 + (64 * w + r_in + 8 * i) % rows_h;
  const int col = 2 * (lane & 3);

  // this warpgroup's Q rows (positions past Sq as zeros)
  __nv_bfloat16* sQw = sQ + 64 * w * D;
#pragma unroll
  for (int i = 0; i < 64 * D / 8 / 128; ++i) {
    const int u = tw + 128 * i;
    const int r = (u & 7) + 8 * (u / D);
    const int c = ((u >> 3) % (D / 8)) * 8;
    const int br = 64 * w + r;
    const int p = q0 + br % rows_h;
    const __nv_bfloat16* qr =
        q + b * a.q_sb + (h0 + br / rows_h) * a.q_sh + p * a.q_ss + c;
    *reinterpret_cast<uint4*>(sQw + cm_off<D>(r, c)) =
        p >= a.sq  ? make_uint4(0u, 0u, 0u, 0u)
        : a.q_vec ? load8(qr, true)
                  : load8n(qr, a.dk - c);
  }
  fence_async_smem();
  warpgroup_sync(1 + w);

  // The tiles this warpgroup's rows can see are a contiguous run [lo, hi]
  // of the block's: the causal limit cuts from above, the window from
  // below. The others are only waited for and released.
  int lo = 0, hi = n_tiles - 1;
  if (wg_n <= 0) {
    hi = -1;
  } else {
    if (a.causal) hi = min(hi, (wp_hi - first) / kTcKeys);
    if (a.window > 0)
      lo = max(0, (wp_lo - a.window + 1 - first) / kTcKeys);
  }
  auto wait_full = [&](int it) {
    mbar_wait(&full[it % kS], (it / kS) & 1);
  };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % kS]);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

  // S = Q K^T of tile it (64 x 64, float32 sums of bf16 products), issued
  auto issue_s = [&](int it) {
    const __nv_bfloat16* kt = sK + (it % kS) * kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, gmma_desc(sQw + 128 * kk, 128, 16 * D),
                   gmma_desc(kt + 128 * kk, 128, 16 * D), kk > 0);
    wgmma_commit();
  };
  // O += P V of tile it, V the B operand in its transposed (MN-major) form
  auto issue_pv = [&](int it) {
    const __nv_bfloat16* vt = sV + (it % kS) * kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(acc, pa[kk], gmma_desc(vt + 16 * D * kk, 16 * D, 128));
    wgmma_commit();
  };
  // the online softmax of tile it on sc: t = S log2(e) / sqrt(dk) in
  // float32 (never contracted into an FMA), masked only where the tile
  // straddles a mask edge; sc becomes p, and m, l and corr advance
  auto softmax = [&](int it) {
    const int kv0 = first + it * kTcKeys;
    const bool whole = kv0 + kTcKeys <= kv_lim &&
                       (!a.causal || kv0 + kTcKeys - 1 <= wp_lo) &&
                       (a.window <= 0 || wp_hi - kv0 < a.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float t = kCap
                        ? cap_log2(a, sc[4 * n + 2 * i + j])
                        : __fmul_rn(sc[4 * n + 2 * i + j], a.scale_log2);
          if (!whole) {
            const int kp = kv0 + 8 * n + col + j;
            const bool ok = kp < kv_lim && (!a.causal || kp <= qpos[i]) &&
                            (a.window <= 0 || qpos[i] - kp < a.window);
            if (!ok) t = -INFINITY;
          }
          sc[4 * n + 2 * i + j] = t;
          mx[i] = fmaxf(mx[i], t);
        }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2_ftz(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2_ftz(sc[4 * n + 2 * i + j] - m[i]);
          sc[4 * n + 2 * i + j] = p;
          psum[i] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
  };
  // after the previous P.V has landed: rescale O, and P into bf16 in the A
  // operand's register layout (keys 16 kk .. 16 kk + 15 are the
  // accumulator's 8-column chunks 2 kk and 2 kk + 1)
  auto rescale_and_pack = [&]() {
    reg_fence(acc);
    reg_fence(sc);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  for (int it = 0; it < lo && it < n_tiles; ++it) {
    wait_full(it);
    release(it);
  }
  if (lo <= hi) {
    // software pipeline: the softmax of tile it runs while the tensor cores
    // do P.V of tile it - 1
    wait_full(lo);
    reg_fence(sc);
    wgmma_fence();
    issue_s(lo);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(lo);
    rescale_and_pack();
    for (int it = lo + 1; it <= hi; ++it) {
      wait_full(it);
      reg_fence(sc);
      reg_fence(acc);
      wgmma_fence();
      issue_s(it);
      issue_pv(it - 1);
      wgmma_wait<1>();  // S of tile it has landed
      reg_fence(sc);
      softmax(it);
      wgmma_wait<0>();  // P.V of tile it - 1 has landed
      release(it - 1);
      rescale_and_pack();
    }
    reg_fence(acc);
    wgmma_fence();
    issue_pv(hi);
    wgmma_wait<0>();
    reg_fence(acc);
    release(hi);
  }
  for (int it = max(hi + 1, lo); it < n_tiles; ++it) {
    wait_full(it);
    release(it);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * w + r_in + 8 * i;
    const int p = q0 + r % rows_h;
    if (p >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && (lane & 3) == 0)
      store_lse(a, b, h0 + r / rows_h, p, m[i], den, true);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * a.sq + p) * a.hq + h0 + r / rows_h) *
                a.dv +
        col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[4 * n + 2 * i] / den;
      const float x1 = acc[4 * n + 2 * i + 1] / den;
      if (a.dv == D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(x0, x1);
      } else {  // a padded dv: only its real columns, one at a time
        if (8 * n + col < a.dv) orow[8 * n] = __float2bfloat16_rn(x0);
        if (8 * n + col + 1 < a.dv) orow[8 * n + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 q at (dk, dv) = (576, 512), MLA's latent (absorbed) attention: the
// split-dv kernel; and at head dim 256 (recurrentgemma's local attention):
// the wide kernel. Both: a producer warpgroup and two consumer warpgroups.
// ---------------------------------------------------------------------------

constexpr int kMlaDK = 576;       // kv_lora + rope: q_all and the cache row
constexpr int kMlaDV = 512;       // kv_lora: V is the cache row's head
constexpr int kWideD = 256;       // the widest dk == dv instantiation
constexpr int kSdThreads = 384;   // a producer and two consumer warpgroups
// setmaxnreg: __launch_bounds__(384, 1) gives every thread 168 registers;
// the producer gives 128 of them back, 128 x 40 + 256 x 232 = 64,512
constexpr int kProdRegs = 40;
constexpr int kConsRegs = 232;
constexpr int kBoxCols = 64;              // bf16 columns of a swizzle box
constexpr int kBox = kTcKeys * kBoxCols;  // elements of a 64-row box: 8 KB
// the K/V ring (elements): two latent tiles of 64 x 576 (73,728 bytes each),
// or one latent tile and a V tile of its own; at 256 four K tiles or two
// K + V pairs (32,768 bytes a tile)
constexpr int kMlaRing = 2 * kTcKeys * kMlaDK;
constexpr int kWideRing = 4 * kTcKeys * kWideD;
// Shared memory a block, with 1,024 bytes to align the base for the
// 128-byte swizzle: Q's first 448 columns (its last 128 live in
// registers), the ring, the P tile, the row maxima of both warpgroups, 12
// mbarriers (214,624 bytes); at 256 the two warpgroups' Q rows, the ring,
// 12 mbarriers (197,728).
constexpr size_t kMlaSmem =
    sizeof(__nv_bfloat16) *
        (kTcKeys * (kMlaDK - 128) + kMlaRing + kTcKeys * kTcKeys) +
    2 * kTcKeys * sizeof(float) + 12 * sizeof(uint64_t) + 1024;
constexpr size_t kWideSmem =
    sizeof(__nv_bfloat16) * (kTcRows * kWideD + kWideRing) +
    12 * sizeof(uint64_t) + 1024;

// Element offset of the 8 columns at (r, c), c a multiple of 8, in a tile
// of 64 rows stored as 64-column boxes in the 128-byte swizzle, TMA's
// CU_TENSOR_MAP_SWIZZLE_128B: box after box, a row 128 bytes, its 16-byte
// chunk c / 8 % 8 at chunk (c / 8 % 8) ^ (r % 8). Boxes are 1,024-byte
// aligned, so the pattern follows the address, as wgmma reads it.
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * kBox + r * kBoxCols + ((((c >> 3) & 7) ^ (r & 7)) << 3);
}

// wgmma descriptors of the 128-byte swizzle (layout type 1). K-major (Q, K:
// a row's columns contiguous): 8-row groups 1,024 bytes apart, the start
// stepping 32 bytes (16 columns) inside the 128-byte atom. MN-major (V as
// the transposed B of P.V: a key's columns contiguous): 64-column atoms
// lbo bytes apart, 8-key groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p,
                                                  uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// an arrival on bar that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// the two consumer warpgroups' barrier (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 8 consecutive elements as bf16: 16-byte loads where the row is aligned
// and whole (vec), else element loads of the first n (zeros after)
__device__ __forceinline__ uint4 load8v(const __nv_bfloat16* p, int n,
                                        bool vec) {
  return vec ? __ldg(reinterpret_cast<const uint4*>(p)) : load8n(p, n);
}
__device__ __forceinline__ uint4 load8v(const float* p, int n, bool vec) {
  if (!vec) return load8n(p, n);
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                    pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
}

// Rows row0 .. row0 + 63 of K or V (D columns, the first `cols` real and
// the rest zeros; rows at or past lim zeros) into a swizzled tile through
// registers (float32 rounded to bf16), by the producer warpgroup (t =
// 0..127), two 8-column units a thread in flight. A row's units are
// consecutive across lanes: 8 lanes read 128 contiguous bytes of bf16 and
// fill one box row, 8 distinct bank groups.
template <int D, typename T>
__device__ __forceinline__ void stage_sw(__nv_bfloat16* dst, const T* src,
                                         long long ss, int row0, int lim,
                                         int cols, bool vec, int t) {
  constexpr int kUnits = kTcKeys * D / 8;
  static_assert(kUnits % 256 == 0, "two units a thread a round");
#pragma unroll 1
  for (int u0 = t; u0 < kUnits; u0 += 256) {
    uint4 x[2];
    int off[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int u = u0 + 128 * j;
      const int r = u / (D / 8), c = (u % (D / 8)) * 8;
      off[j] = sw_off(r, c);
      x[j] = row0 + r < lim ? load8v(src + (row0 + r) * ss + c, cols - c, vec)
                            : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint4*>(dst + off[j]) = x[j];
  }
}

// The scores of a tile in log2 units, S log2(e) / sqrt(dk) (or capped),
// over N 8-column chunks of the S accumulator (sc[4 n + 2 i + j]: row i,
// key k0 + 8 n + j), and the rows' maxima. Only a tile that straddles a
// mask edge (`masked`) computes the mask, in a pass of its own, branch-free,
// to -inf: one branch a tile, not one a score.
template <bool kCap, int N>
__device__ __forceinline__ void tile_scores(float (&sc)[4 * N],
                                            float (&mx)[2], const Args& a,
                                            bool masked, int k0,
                                            const int (&qpos)[2],
                                            int kv_lim) {
#pragma unroll
  for (int e = 0; e < 4 * N; ++e)
    sc[e] = kCap ? cap_log2(a, sc[e]) : __fmul_rn(sc[e], a.scale_log2);
  if (masked) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = k0 + 8 * n + j;
          const bool ok = kp < kv_lim && (!a.causal || kp <= qpos[i]) &&
                          (a.window <= 0 || qpos[i] - kp < a.window);
          if (!ok) sc[4 * n + 2 * i + j] = -INFINITY;
        }
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mx[i] = fmaxf(mx[i], sc[4 * n + 2 * i + j]);
}

// Block rows row0 .. row0 + 63 of Q (D columns) into a swizzled 64-row
// tile by `n` threads (t = 0 .. n - 1): block row br is head h0 + br /
// rows_h at position q0 + br % rows_h; positions past Sq are zeros. Whole,
// aligned rows by cp.async, every copy of a thread in flight at once (the
// caller waits for them); others by element loads with a column limit.
template <int D>
__device__ __forceinline__ void stage_q(__nv_bfloat16* dst,
                                        const __nv_bfloat16* q, const Args& a,
                                        int b, int h0, int q0, int rows_h,
                                        int row0, int t, int n) {
  for (int u = t; u < kTcKeys * D / 8; u += n) {
    const int r = u / (D / 8), c = (u % (D / 8)) * 8;
    const int br = row0 + r;
    const int p = q0 + br % rows_h;
    const __nv_bfloat16* qr =
        q + b * a.q_sb + (h0 + br / rows_h) * a.q_sh + p * a.q_ss + c;
    if (a.q_vec)
      cp_async16(dst + sw_off(r, c), p < a.sq ? qr : q, p < a.sq ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst + sw_off(r, c)) =
          p < a.sq ? load8n(qr, a.dk - c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A consumer warp's release of a slot: its lane 0 arrives on the slot's
// empty barrier in this block and, in a cluster pair, in the peer's (whose
// producer multicasts into this block's slot too)
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar,
                                                 uint32_t peer) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(smem_u32(bar)), "r"(peer) : "memory");
}
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane,
                                             bool pair, uint32_t peer) {
  if (lane == 0) {
    mbar_arrive(empty);
    if (pair) mbar_arrive_peer(empty, peer);
  }
}

// every thread of both blocks of a cluster pair (their barriers initialised
// before either touches the other's)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one box of a 4-D tensor map at (c0, c1, c2, c3) into the same offset of
// both blocks of a cluster pair, its bytes counted on the barrier at bar's
// offset in each
__device__ __forceinline__ void tma_load_4d_pair(void* dst,
                                                 const CUtensorMap* map,
                                                 uint64_t* bar, int c0,
                                                 int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "h"(static_cast<uint16_t>(3))
      : "memory");
}

// Where a block's K and V tiles sit. K and V have rings of their own (ks
// and vs slots), so a K slot is free once S has read it and a V slot once
// P.V has; when v aliases k there is no V ring (vs = 0) and V is the first
// dv columns of the K slot, free after P.V. Each slot has a full barrier
// (the tile has landed) and an empty one (every consumer warp of the
// block, and of its cluster peer, is done with it).
struct Ring {
  __nv_bfloat16* base;
  int k_elems, v_elems, ks, vs;
  uint64_t *full_k, *empty_k, *full_v, *empty_v;
  __device__ __nv_bfloat16* k(int it) const {
    return base + (it % ks) * k_elems;
  }
  __device__ __nv_bfloat16* v(int it) const {
    return vs ? base + ks * k_elems + (it % vs) * v_elems : k(it);
  }
};

// the ring of `elems` elements at base: as many K slots as fit when v
// aliases k, else as many K + V pairs; bars holds 12 barriers
template <int DK, int DV>
__device__ __forceinline__ Ring make_ring(__nv_bfloat16* base, int elems,
                                          bool alias, uint64_t* bars) {
  Ring r;
  r.base = base;
  r.k_elems = kTcKeys * DK;
  r.v_elems = kTcKeys * DV;
  r.ks = alias ? elems / r.k_elems : elems / (r.k_elems + r.v_elems);
  r.vs = alias ? 0 : r.ks;
  r.full_k = bars;
  r.empty_k = bars + 4;
  r.full_v = bars + 8;
  r.empty_v = bars + 10;
  return r;
}

// The producer warpgroup (t = 0..127): the block's tiles, keys first + 64
// it for it = 0 .. n_tiles - 1, K then V of each, into the ring. bf16
// rows that are 16-byte aligned and whole (kv_vec) come by TMA, and the
// block is one of a cluster pair: thread 0 waits for the slot, expects the
// tile's bytes on its full barrier and issues every other 64 x 64 box of
// it (the peer the others), each multicast into both blocks (rows at or
// past kv_valid_len are outside the map and land as zeros); it stays until
// its slots' last releases, the peer's included, have arrived, since the
// peer's consumers arrive on this block's barriers. Any other K/V
// (float32, unaligned rows, a head dim padded into the instantiation) the
// warpgroup loads, converts and stores, then arrives on the full barrier,
// 128 arrivals.
template <int DK, int DV, typename TKV>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* mk,
                                        const CUtensorMap* mv, const TKV* kb,
                                        const TKV* vb, const Args& a, int b,
                                        int hk, int first, int n_tiles,
                                        int kv_lim, int rank, int t) {
  const bool tma = sizeof(TKV) == 2 && a.kv_vec;  // and so a cluster pair
  if (tma && t != 0) return;
  auto fill = [&](__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* full,
                  int cols, int kv0) {
    mbar_expect_tx(full, sizeof(__nv_bfloat16) * kTcKeys * cols);
#pragma unroll 1
    for (int i = rank; i < cols / kBoxCols; i += 2)
      tma_load_4d_pair(dst + i * kBox, map, full, kBoxCols * i, kv0, hk, b);
  };
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = first + it * kTcKeys;
    if (it >= r.ks) mbar_wait(&r.empty_k[it % r.ks], (it / r.ks - 1) & 1);
    if (tma) {
      fill(r.k(it), mk, &r.full_k[it % r.ks], DK, kv0);
    } else {
      stage_sw<DK>(r.k(it), kb, a.k_ss, kv0, kv_lim, a.dk, a.kv_vec, t);
      fence_async_smem();
      mbar_arrive(&r.full_k[it % r.ks]);
    }
    if (!r.vs) continue;
    if (it >= r.vs) mbar_wait(&r.empty_v[it % r.vs], (it / r.vs - 1) & 1);
    if (tma) {
      fill(r.v(it), mv, &r.full_v[it % r.vs], DV, kv0);
    } else {
      stage_sw<DV>(r.v(it), vb, a.v_ss, kv0, kv_lim, a.dv, a.kv_vec, t);
      fence_async_smem();
      mbar_arrive(&r.full_v[it % r.vs]);
    }
  }
  if (tma) {
    for (int it = max(0, n_tiles - r.ks); it < n_tiles; ++it)
      mbar_wait(&r.empty_k[it % r.ks], (it / r.ks) & 1);
    for (int it = max(0, n_tiles - r.vs); it < n_tiles; ++it)
      mbar_wait(&r.empty_v[it % r.vs], (it / r.vs) & 1);
  }
}

// wgmma m64n32k16 (the split-dv kernel's S: 32 keys a warpgroup), Q from
// shared memory or, for the 64 rope columns, from registers; and m64n256k16
// with P from registers (the wide kernel's P.V, V MN-major)

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


// The split kernels' grid: per (batch row, KV head) `per` blocks, head
// sets fastest, then query blocks, the heaviest (the last rows) first; a
// block serves gh query heads of one KV head (16, 8, 4, 2 or 1, the largest
// that divides the group) at rows / gh positions each. In cluster pairs
// `per` is made even by a block that serves no row.
struct Geometry {
  int g, gh, rows_h, n_qb, per;
};
__host__ __device__ inline Geometry geometry(const Args& a, int rows,
                                             bool pair) {
  Geometry s;
  s.g = a.hq / a.hkv;
  s.gh = s.g % 16 == 0 ? 16 : s.g % 8 == 0 ? 8 : s.g % 4 == 0 ? 4
       : s.g % 2 == 0 ? 2 : 1;
  s.rows_h = rows / s.gh;
  s.n_qb = (a.sq + s.rows_h - 1) / s.rows_h;
  s.per = s.g / s.gh * s.n_qb;
  if (pair) s.per += s.per & 1;
  return s;
}

// This block's work item and its tiles: first and n_tiles cover the keys
// some row of it can see and, in a cluster pair, the keys its peer's rows
// can see (both blocks stage the same tiles; a neighbouring query block's
// differ by at most one at either end). The block that pads a pair (no
// rows, q0 = Sq) takes its peer's tiles.
struct Item {
  int b, hk, h0, q0, rows_h, first, n_tiles, kv_lim, qp_lo, qp_hi;
};
__device__ __forceinline__ Item block_item(const Args& a, int rows,
                                           bool pair) {
  const Geometry s = geometry(a, rows, pair);
  const int sets = s.g / s.gh, real = sets * s.n_qb;
  const int bh = blockIdx.x / s.per, y = blockIdx.x % s.per;
  Item it;
  it.hk = bh % a.hkv;
  it.b = bh / a.hkv;
  it.rows_h = s.rows_h;
  it.kv_lim = min(a.sk, a.kv_valid);
  // the keys [first, end) the rows of block yy (< real) can see
  auto span = [&](int yy, int& first, int& end) {
    const int q0 = (s.n_qb - 1 - yy / sets) * s.rows_h;
    const int lo = a.q_offset + q0;
    const int hi = a.q_offset + min(q0 + s.rows_h, a.sq) - 1;
    end = a.causal ? min(it.kv_lim, hi + 1) : it.kv_lim;
    first = (a.window > 0 ? max(0, lo - a.window + 1) : 0) / kTcKeys *
            kTcKeys;
  };
  const bool pad = y >= real;
  it.q0 = pad ? a.sq : (s.n_qb - 1 - y / sets) * s.rows_h;
  it.h0 = it.hk * s.g + (pad ? 0 : y % sets) * s.gh;
  it.qp_lo = a.q_offset + it.q0;
  it.qp_hi = a.q_offset + min(it.q0 + s.rows_h, a.sq) - 1;
  int first, end;
  span(pad ? y - 1 : y, first, end);
  if (pair && (y ^ 1) < real) {
    int f2, e2;
    span(y ^ 1, f2, e2);
    first = min(first, f2);
    end = max(end, e2);
  }
  it.first = first;
  it.n_tiles = (end - first + kTcKeys - 1) / kTcKeys;
  return it;
}

// The split-dv kernel, MLA's (576, 512). One block of a producer and two
// consumer warpgroups a work item of 64 query rows: gh query heads of one
// KV head at 64 / gh positions (deepseek-v2-lite's g = 16: all 16 heads at
// 4 positions). A 64 x 512 float32 O is 256 registers a thread in one
// warpgroup, so dv is split: warpgroup w owns O's columns 256 w .. 256 w +
// 255 (128 registers). S is split too, by keys: warpgroup w computes S for
// keys 32 w .. 32 w + 31 of each tile (36 wgmma m64n32k16: 32 with Q's
// nope columns from shared memory, 4 with its rope columns from
// registers), so neither waits while the other computes S. The two
// exchange their rows' maxima through shared memory (the 64-key step of
// ref._flash_scan exact: one running max over the whole tile), each writes
// its 32 columns of P (bf16) into the P tile, and each runs O += P.V for
// its half of dv (4 wgmma m64n256k16, P from shared memory, V MN-major).
// A tile's slot is read until P.V of it lands; P.V of tile j - 1 is issued
// before S of tile j, so the slot comes free early in tile j's step and
// the producer has the rest of that step (S, the softmax) to bring tile j +
// 1 into it. Two barriers of the consumers a tile (the maxima, P written).
// The producer keeps a ring of two latent tiles full by TMA (the tile is
// staged once: V is its first 512 columns; a V of its own has a ring of
// its own); pairs of neighbouring blocks form a cluster, and each latent
// tile comes from L2 once for both, multicast.
template <typename TKV, bool kCap>
__global__ void __launch_bounds__(kSdThreads, 1)
    flash_mla_kernel(const __nv_bfloat16* __restrict__ q,
                     const TKV* __restrict__ k, const TKV* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, Args a,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv) {
  constexpr int DK = kMlaDK, DV = kMlaDV;
  constexpr int kRegSteps = 8;             // Q's k-steps from registers
  constexpr int kQs = DK - 16 * kRegSteps;  // Q's columns in shared memory
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);  // 7 boxes
  __nv_bfloat16* ring_base = sQ + kTcKeys * kQs;
  __nv_bfloat16* sP = ring_base + kMlaRing;  // 64 x 64, core matrices
  float* sMax = reinterpret_cast<float*>(sP + kTcKeys * kTcKeys);  // 2 x 64
  uint64_t* bars = reinterpret_cast<uint64_t*>(sMax + 2 * kTcKeys);

  const bool pair = sizeof(TKV) == 2 && a.kv_vec;  // TMA, in cluster pairs
  const Item item = block_item(a, kTcKeys, pair);
  const int rows_h = item.rows_h, q0 = item.q0, b = item.b, h0 = item.h0;
  const int first = item.first, n_tiles = item.n_tiles;
  const Ring ring = make_ring<DK, DV>(ring_base, kMlaRing, a.v_alias, bars);
  const int tid = threadIdx.x;
  const uint32_t rank = blockIdx.x & 1, peer = rank ^ 1;

  if (tid == 0) {
    for (int s = 0; s < ring.ks; ++s) {
      mbar_init(&ring.full_k[s], pair ? 1 : 128);
      mbar_init(&ring.empty_k[s], pair ? 16 : 8);  // every consumer warp
    }
    for (int s = 0; s < ring.vs; ++s) {
      mbar_init(&ring.full_v[s], pair ? 1 : 128);
      mbar_init(&ring.empty_v[s], pair ? 16 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (pair) cluster_sync();
  else __syncthreads();

  if (tid < 128) {
    regs_dec<kProdRegs>();
    produce<DK, DV>(ring, &mk, &mv, k + b * a.k_sb + item.hk * a.k_sh,
                    v + b * a.v_sb + item.hk * a.v_sh, a, b, item.hk, first,
                    n_tiles, item.kv_lim, rank, tid);
    return;
  }
  regs_inc<kConsRegs>();

  const int w = tid / 128 - 1;
  const int lane = tid & 31;
  // this thread's two accumulator rows r_in + 8 i of the 64 (both
  // warpgroups hold the same rows), their positions, its column pair
  const int r_in = 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int col = 2 * (lane & 3);
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = a.q_offset + q0 + (r_in + 8 * i) % rows_h;

  // Q's first 448 columns into shared memory by both warpgroups (positions
  // past Sq as zeros), all of a thread's copies in flight at once; its last
  // 128 (64 nope, the 64 rope) into each warpgroup's registers in the A
  // operand's layout (columns 16 kk .. 16 kk + 15 of the kk-th of the last
  // k-steps): the S products read a sixth less from shared memory
  stage_q<kQs>(sQ, q, a, b, h0, q0, rows_h, 0, tid - 128, 256);
  uint32_t qa[kRegSteps][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_in + 8 * i;
    const int p = q0 + r % rows_h;
    const __nv_bfloat16* qr =
        q + b * a.q_sb + (h0 + r / rows_h) * a.q_sh + p * a.q_ss + kQs + col;
#pragma unroll
    for (int kk = 0; kk < kRegSteps; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 16 * kk + 8 * hf;
        qa[kk][i + 2 * hf] =
            p >= a.sq ? 0u
            : a.q_vec ? __ldg(reinterpret_cast<const unsigned*>(qr + c))
                      : static_cast<uint32_t>(
                            reinterpret_cast<const unsigned short*>(qr)[c]) |
                            static_cast<uint32_t>(
                                reinterpret_cast<const unsigned short*>(
                                    qr)[c + 1])
                                << 16;
      }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_async_smem();
  consumers_sync(1);

  auto wait_k = [&](int it) {
    mbar_wait(&ring.full_k[it % ring.ks], (it / ring.ks) & 1);
  };
  auto wait_v = [&](int it) {
    if (ring.vs) mbar_wait(&ring.full_v[it % ring.vs], (it / ring.vs) & 1);
  };
  // after S of tile it: its K slot, unless V lives there
  auto release_k = [&](int it) {
    if (ring.vs) release_slot(&ring.empty_k[it % ring.ks], lane, pair, peer);
  };
  // after P.V of tile it: its V slot, or the K slot that holds V
  auto release_v = [&](int it) {
    release_slot(ring.vs ? &ring.empty_v[it % ring.vs]
                         : &ring.empty_k[it % ring.ks],
                 lane, pair, peer);
  };

  float acc[DV / 4];  // O's columns 256 w .. 256 w + 255 of the two rows
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) acc[i] = 0.f;
  float sc[16];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

  // S = Q K^T over this warpgroup's 32 keys of tile it, issued: Q's first
  // kQs columns from shared memory, the rest from registers
  auto issue_s = [&](int it) {
    const __nv_bfloat16* kt = ring.k(it) + 32 * w * kBoxCols;
#pragma unroll
    for (int kk = 0; kk < kQs / 16; ++kk)
      wgmma_ss_n32(sc, desc_sw128(sQ + (kk >> 2) * kBox + (kk & 3) * 16),
                   desc_sw128(kt + (kk >> 2) * kBox + (kk & 3) * 16),
                   kk > 0);
#pragma unroll
    for (int kk = kQs / 16; kk < DK / 16; ++kk)
      wgmma_rs_n32(sc, qa[kk - kQs / 16],
                   desc_sw128(kt + (kk >> 2) * kBox + (kk & 3) * 16));
    wgmma_commit();
  };
  // O += P V of tile it over this warpgroup's 256 columns of V
  auto issue_pv = [&](int it) {
    const __nv_bfloat16* vt = ring.v(it) + 4 * w * kBox;
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
      wgmma_ss_n256(acc, gmma_desc(sP + 128 * kk, 128, 16 * kTcKeys),
                    desc_sw128_mn(vt + 16 * kk * kBoxCols,
                                  sizeof(__nv_bfloat16) * kBox));
    wgmma_commit();
  };
  // the online softmax of tile it: t = S log2(e) / sqrt(dk) (or capped) on
  // this warpgroup's keys, masked where the tile straddles a mask edge; the
  // rows' maxima of both warpgroups through sMax give the one running max
  // of the 64-key step; sc becomes p, m, l (this warpgroup's keys) and corr
  // advance
  auto softmax = [&](int it) {
    const int kv0 = first + it * kTcKeys;
    const bool whole = kv0 + kTcKeys <= item.kv_lim &&
                       (!a.causal || kv0 + kTcKeys - 1 <= item.qp_lo) &&
                       (a.window <= 0 || item.qp_hi - kv0 < a.window);
    float mx[2] = {-INFINITY, -INFINITY};
    tile_scores<kCap, 4>(sc, mx, a, !whole, kv0 + 32 * w + col, qpos,
                         item.kv_lim);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    if ((lane & 3) == 0) {
      sMax[kTcKeys * w + r_in] = mx[0];
      sMax[kTcKeys * w + r_in + 8] = mx[1];
    }
    consumers_sync(2);
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_in + 8 * i;
      const float m_new = fmaxf(m[i], fmaxf(sMax[r], sMax[kTcKeys + r]));
      corr[i] = exp2_ftz(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2_ftz(sc[4 * n + 2 * i + j] - m[i]);
          sc[4 * n + 2 * i + j] = p;
          psum[i] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
  };
  // O rescaled by the tile's factors (a warp whose rows all keep their max
  // skips it: x * 1 is x), and this warpgroup's 32 columns of P (bf16) into
  // the P tile
  auto rescale_and_write_p = [&]() {
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
      reg_fence(acc);
#pragma unroll
      for (int n = 0; n < DV / 16; ++n) {
        acc[4 * n] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }
      reg_fence(acc);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(
            sP + cm_off<kTcKeys>(r_in + 8 * i, 32 * w + 8 * n) + col) =
            pack_bf16(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]);
  };

  for (int it = 0; it < n_tiles; ++it) {
    wait_k(it);
    if (it > 0) wait_v(it - 1);
    reg_fence(sc);
    reg_fence(acc);
    wgmma_fence();
    if (it > 0) issue_pv(it - 1);
    issue_s(it);
    if (it > 0) {
      wgmma_wait<1>();  // P.V of tile it - 1 has landed
      reg_fence(acc);
      release_v(it - 1);
    }
    wgmma_wait<0>();  // S of tile it has landed
    reg_fence(sc);
    release_k(it);
    // the maxima's barrier inside also means both warpgroups' P.V of tile
    // it - 1 has landed: the P tile may be written
    softmax(it);
    rescale_and_write_p();
    fence_async_smem();
    consumers_sync(1);  // P of tile it is whole
  }
  wait_v(n_tiles - 1);
  reg_fence(acc);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  reg_fence(acc);
  release_v(n_tiles - 1);

  // the denominator: both warpgroups' sums of their keys' p (sMax is free:
  // its last reads came before the last barrier)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if ((lane & 3) == 0) {
    sMax[kTcKeys * w + r_in] = l[0];
    sMax[kTcKeys * w + r_in + 8] = l[1];
  }
  consumers_sync(2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_in + 8 * i;
    const int p = q0 + r % rows_h;
    if (p >= a.sq) continue;
    const float den = fmaxf(sMax[r] + sMax[kTcKeys + r], 1e-30f);
    if (w == 0 && a.lse != nullptr && (lane & 3) == 0)
      store_lse(a, b, h0 + r / rows_h, p, m[i], den, true);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * a.sq + p) * a.hq + h0 + r / rows_h) *
                a.dv +
        DV / 2 * w + col;
#pragma unroll
    for (int n = 0; n < DV / 16; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] / den,
                                acc[4 * n + 2 * i + 1] / den);
  }
}

// The wide kernel, head dim 256 (dk and dv up to 256, padded into it). One
// block of a producer and two consumer warpgroups a work item of 128 query
// rows, gh heads of one KV head at 128 / gh positions (recurrentgemma-9b's
// g = 16: all 16 heads at 8 positions, so a K/V tile is staged once for
// twice the rows of a 64-row block). Warpgroup w owns rows 64 w .. 64 w +
// 63 whole, as a consumer of flash_tc_kernel does: S = Q.K^T by 16 wgmma
// m64n64k16 (Q and K in shared memory), the online softmax in registers,
// O += P.V by 4 wgmma m64n256k16 with P from registers (the S
// accumulator's layout is the A operand's) and V MN-major; the softmax of
// tile j runs while the tensor cores do P.V of tile j - 1. O (128 float32
// registers), S (32) and P (16) fit under the 232 registers setmaxnreg
// gives a consumer. The warpgroups do not wait on each other: each waits
// for the tiles, and the producer for both to release a slot. K and V have
// rings of two slots each (four K slots when v aliases k): a K slot comes
// free when S has read it, so the producer brings K of tile j + 2 while
// the consumers work on tile j. Pairs of neighbouring blocks form a
// cluster, and each tile comes from L2 once for both, multicast.
template <typename TKV, bool kCap>
__global__ void __launch_bounds__(kSdThreads, 1)
    flash_wide_kernel(const __nv_bfloat16* __restrict__ q,
                      const TKV* __restrict__ k, const TKV* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, Args a,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv) {
  constexpr int D = kWideD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* ring_base = sQ + kTcRows * D;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_base + kWideRing);

  const bool pair = sizeof(TKV) == 2 && a.kv_vec;  // TMA, in cluster pairs
  const Item item = block_item(a, kTcRows, pair);
  const int rows_h = item.rows_h, q0 = item.q0, b = item.b, h0 = item.h0;
  const int first = item.first, n_tiles = item.n_tiles;
  const Ring ring = make_ring<D, D>(ring_base, kWideRing, a.v_alias, bars);
  const int tid = threadIdx.x;
  const uint32_t rank = blockIdx.x & 1, peer = rank ^ 1;

  if (tid == 0) {
    for (int s = 0; s < ring.ks; ++s) {
      mbar_init(&ring.full_k[s], pair ? 1 : 128);
      mbar_init(&ring.empty_k[s], pair ? 16 : 8);  // every consumer warp
    }
    for (int s = 0; s < ring.vs; ++s) {
      mbar_init(&ring.full_v[s], pair ? 1 : 128);
      mbar_init(&ring.empty_v[s], pair ? 16 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (pair) cluster_sync();
  else __syncthreads();

  if (tid < 128) {
    regs_dec<kProdRegs>();
    produce<D, D>(ring, &mk, &mv, k + b * a.k_sb + item.hk * a.k_sh,
                  v + b * a.v_sb + item.hk * a.v_sh, a, b, item.hk, first,
                  n_tiles, item.kv_lim, rank, tid);
    return;
  }
  regs_inc<kConsRegs>();

  // consumers: warpgroup w (0 or 1) owns block rows 64 w .. 64 w + 63,
  // whose positions are wg_p0 .. wg_p0 + wg_n - 1 (wg_n <= 0: none)
  const int w = tid / 128 - 1;
  const int tw = tid & 127;
  const int lane = tid & 31;
  const int wg_p0 = q0 + (rows_h == kTcRows ? 64 * w : 0);
  const int wg_n = min(min(64, rows_h), a.sq - wg_p0);
  const int wp_lo = a.q_offset + wg_p0, wp_hi = wp_lo + wg_n - 1;
  const int r_in = 16 * (tw >> 5) + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = a.q_offset + q0 + (64 * w + r_in + 8 * i) % rows_h;
  const int col = 2 * (lane & 3);

  // this warpgroup's Q rows (positions past Sq, columns past dk as zeros)
  __nv_bfloat16* sQw = sQ + 64 * w * D;
  stage_q<D>(sQw, q, a, b, h0, q0, rows_h, 64 * w, tw, 128);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_async_smem();
  warpgroup_sync(1 + w);

  // The tiles this warpgroup's rows can see are a contiguous run [lo, hi]
  // of the block's: the causal limit cuts from above, the window from
  // below. The others are only waited for and released.
  int lo = 0, hi = n_tiles - 1;
  if (wg_n <= 0) {
    hi = -1;
  } else {
    if (a.causal) hi = min(hi, (wp_hi - first) / kTcKeys);
    if (a.window > 0)
      lo = max(0, (wp_lo - a.window + 1 - first) / kTcKeys);
  }
  auto wait_k = [&](int it) {
    mbar_wait(&ring.full_k[it % ring.ks], (it / ring.ks) & 1);
  };
  auto wait_v = [&](int it) {
    if (ring.vs) mbar_wait(&ring.full_v[it % ring.vs], (it / ring.vs) & 1);
  };
  // after S of tile it: its K slot, unless V lives there
  auto release_k = [&](int it) {
    if (ring.vs) release_slot(&ring.empty_k[it % ring.ks], lane, pair, peer);
  };
  // after P.V of tile it: its V slot, or the K slot that holds V
  auto release_v = [&](int it) {
    release_slot(ring.vs ? &ring.empty_v[it % ring.vs]
                         : &ring.empty_k[it % ring.ks],
                 lane, pair, peer);
  };
  // a tile this warpgroup's rows cannot see
  auto skip = [&](int it) {
    wait_k(it);
    release_k(it);
    wait_v(it);
    release_v(it);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

  // S = Q K^T of tile it (64 x 64, float32 sums of bf16 products), issued
  auto issue_s = [&](int it) {
    const __nv_bfloat16* kt = ring.k(it);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_sw128(sQw + (kk >> 2) * kBox + (kk & 3) * 16),
                   desc_sw128(kt + (kk >> 2) * kBox + (kk & 3) * 16),
                   kk > 0);
    wgmma_commit();
  };
  // O += P V of tile it, V the B operand in its transposed (MN-major) form
  auto issue_pv = [&](int it) {
    const __nv_bfloat16* vt = ring.v(it);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n256(acc, pa[kk],
                    desc_sw128_mn(vt + 16 * kk * kBoxCols,
                                  sizeof(__nv_bfloat16) * kBox));
    wgmma_commit();
  };
  // the online softmax of tile it on sc, as flash_tc_kernel's
  auto softmax = [&](int it) {
    const int kv0 = first + it * kTcKeys;
    const bool whole = kv0 + kTcKeys <= item.kv_lim &&
                       (!a.causal || kv0 + kTcKeys - 1 <= wp_lo) &&
                       (a.window <= 0 || wp_hi - kv0 < a.window);
    float mx[2] = {-INFINITY, -INFINITY};
    tile_scores<kCap, 8>(sc, mx, a, !whole, kv0 + col, qpos, item.kv_lim);
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2_ftz(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2_ftz(sc[4 * n + 2 * i + j] - m[i]);
          sc[4 * n + 2 * i + j] = p;
          psum[i] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
  };
  // after the previous P.V has landed: rescale O (a warp whose rows all
  // keep their max skips it: x * 1 is x), and P into bf16 in the A
  // operand's register layout
  auto rescale_and_pack = [&]() {
    reg_fence(acc);
    reg_fence(sc);
    if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }
      reg_fence(acc);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  for (int it = 0; it < lo && it < n_tiles; ++it) skip(it);
  if (lo <= hi) {
    wait_k(lo);
    reg_fence(sc);
    wgmma_fence();
    issue_s(lo);
    wgmma_wait<0>();
    reg_fence(sc);
    release_k(lo);
    softmax(lo);
    rescale_and_pack();
    for (int it = lo + 1; it <= hi; ++it) {
      wait_k(it);
      wait_v(it - 1);
      reg_fence(sc);
      reg_fence(acc);
      wgmma_fence();
      issue_s(it);
      issue_pv(it - 1);
      wgmma_wait<1>();  // S of tile it has landed
      reg_fence(sc);
      release_k(it);
      softmax(it);
      wgmma_wait<0>();  // P.V of tile it - 1 has landed
      release_v(it - 1);
      rescale_and_pack();
    }
    wait_v(hi);
    reg_fence(acc);
    wgmma_fence();
    issue_pv(hi);
    wgmma_wait<0>();
    reg_fence(acc);
    release_v(hi);
  }
  for (int it = max(hi + 1, lo); it < n_tiles; ++it) skip(it);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 64 * w + r_in + 8 * i;
    const int p = q0 + r % rows_h;
    if (p >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && (lane & 3) == 0)
      store_lse(a, b, h0 + r / rows_h, p, m[i], den, true);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * a.sq + p) * a.hq + h0 + r / rows_h) *
                a.dv +
        col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[4 * n + 2 * i] / den;
      const float x1 = acc[4 * n + 2 * i + 1] / den;
      if (a.dv == D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(x0, x1);
      } else {  // a padded dv: only its real columns, one at a time
        if (8 * n + col < a.dv) orow[8 * n] = __float2bfloat16_rn(x0);
        if (8 * n + col + 1 < a.dv) orow[8 * n + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, found through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 K or V (B, S, H, cols): dims (cols, rows, heads,
// batch) innermost first, element strides in bytes, 64 x 64 boxes in the
// 128-byte swizzle; the rows stop at `rows` (kv_valid_len), so a box's
// rows past it land as zeros. 0, or -2 / -3 when libcuda has no encoder
// or refuses the map.
int tile_map(CUtensorMap* map, const void* base, int cols, int rows,
             int heads, int batch, long long ss, long long sh, long long sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, kTcKeys, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// The split-dv (kMla) or the wide kernel. bf16 K/V with aligned, whole rows
// and positive strides take TMA (their maps made here) in cluster pairs of
// neighbouring blocks; any other K/V the producer's loads, one block a
// cluster.
template <typename TKV, bool kCap, bool kMla>
int launch_split(const void* q, const void* k, const void* v, void* o, int b,
                 Args a, cudaStream_t stream) {
  auto kernel = kMla ? flash_mla_kernel<TKV, kCap>
                     : flash_wide_kernel<TKV, kCap>;
  constexpr size_t smem = kMla ? kMlaSmem : kWideSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.k_sb <= 0 || a.k_ss <= 0 || a.k_sh <= 0 || a.v_sb <= 0 ||
      a.v_ss <= 0 || a.v_sh <= 0)
    a.kv_vec = 0;
  const bool pair = sizeof(TKV) == 2 && a.kv_vec;
  CUtensorMap mk{}, mv{};
  if (pair) {
    const int rows = a.sk < a.kv_valid ? a.sk : a.kv_valid;
    int e = tile_map(&mk, k, a.dk, rows, a.hkv, b, a.k_ss, a.k_sh, a.k_sb);
    if (e == 0 && !a.v_alias)
      e = tile_map(&mv, v, a.dv, rows, a.hkv, b, a.v_ss, a.v_sh, a.v_sb);
    if (e != 0) return e;
  }
  const Geometry s = geometry(a, kMla ? kTcKeys : kTcRows, pair);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * a.hkv * s.per);
  cfg.blockDim = dim3(kSdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = pair ? 2 : 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const TKV*>(k),
                           static_cast<const TKV*>(v),
                           static_cast<__nv_bfloat16*>(o), a, mk, mv);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D, bool kCap>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           const Args& a, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<TQ, TKV, D, D, kCap>;
  constexpr size_t smem = smem_bytes<D, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, int D, bool kCap>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              const Args& a, cudaStream_t stream) {
  auto kernel = flash_tc_kernel<TKV, D, kCap>;
  constexpr size_t smem = tc_smem_bytes<TKV, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = a.hq / a.hkv;
  const int rows_h = kTcRows / (g % 4 == 0 ? 4 : g % 2 == 0 ? 2 : 1);
  const unsigned blocks = static_cast<unsigned>(b) * a.hq /
                          (kTcRows / rows_h) * ((a.sq + rows_h - 1) / rows_h);
  kernel<<<blocks, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<__nv_bfloat16*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, bool kCap>
int launch_d(const void* q, const void* k, const void* v, void* o, int q_bf16,
             int b, int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 64:
      return q_bf16 ? launch_tc<TKV, 64, kCap>(q, k, v, o, b, a, stream)
                    : launch<float, TKV, 64, kCap>(q, k, v, o, b, a, stream);
    case 80:
      return q_bf16 ? launch_tc<TKV, 80, kCap>(q, k, v, o, b, a, stream)
                    : launch<float, TKV, 80, kCap>(q, k, v, o, b, a, stream);
    case 96:
      return q_bf16 ? launch_tc<TKV, 96, kCap>(q, k, v, o, b, a, stream)
                    : launch<float, TKV, 96, kCap>(q, k, v, o, b, a, stream);
    case 128:
      return q_bf16 ? launch_tc<TKV, 128, kCap>(q, k, v, o, b, a, stream)
                    : launch<float, TKV, 128, kCap>(q, k, v, o, b, a, stream);
    case 160:
      return q_bf16 ? launch_tc<TKV, 160, kCap>(q, k, v, o, b, a, stream)
                    : launch<float, TKV, 160, kCap>(q, k, v, o, b, a, stream);
    case kWideD:
      return q_bf16 ? launch_split<TKV, kCap, false>(q, k, v, o, b, a,
                                                     stream)
                    : launch<float, TKV, kWideD, kCap>(q, k, v, o, b, a,
                                                       stream);
    default: return -1;
  }
}

// every route, its softcap a compile-time flag: an uncapped launch runs the
// kernels without a line of the cap (kCap false), so the cap costs the
// uncapped path neither registers nor instructions
template <bool kCap>
int launch_all(const void* q, const void* k, const void* v, void* o,
               int q_bf16, int kv_bf16, int b, bool mla, int d, const Args& a,
               cudaStream_t s) {
  if (mla)
    return kv_bf16
               ? launch_split<__nv_bfloat16, kCap, true>(q, k, v, o, b, a, s)
               : launch_split<float, kCap, true>(q, k, v, o, b, a, s);
  if (kv_bf16)
    return launch_d<__nv_bfloat16, kCap>(q, k, v, o, q_bf16, b, d, a, s);
  return launch_d<float, kCap>(q, k, v, o, q_bf16, b, d, a, s);
}

// 16-byte aligned rows: the base and the batch, sequence and head strides
bool rows_aligned(const void* p, long long sb, long long ss, long long sh,
                  int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb * elem % 16 == 0 &&
         ss * elem % 16 == 0 && sh * elem % 16 == 0;
}

// the instantiation that holds a head of max(dk, dv) columns (0: none)
int padded_dim(int dk, int dv) {
  static const int dims[] = {64, 80, 96, 128, 160, kWideD};
  const int need = dk > dv ? dk : dv;
  for (int d : dims)
    if (need <= d) return d;
  return 0;
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bf16, 0 for float32. bf16 q takes the tensor-core
// kernels, float32 q the CUDA-core one. (dk, dv) = (576, 512) takes the
// latent-attention kernel (bf16 q only); any other dk, dv up to 256 takes
// the instantiation of the smallest head dim of 64, 80, 96, 128, 160 and 256
// that holds both (256: the split-dv kernel for bf16 q), its extra columns
// staged as zeros (through the element loads) and never written out.
// Anything else returns -1 without a launch.
// lse: null, or a float32 (B, Hq, Sq) tensor that takes each row's
// logsumexp of its scaled, masked scores (natural log).
// softcap: 0 for none; > 0 caps each scaled score at softcap tanh(s /
// softcap) before the mask (the lse is then of the capped scores).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int q_bf16,
    int kv_bf16, int b, int sq, int sk, int hq, int hkv, int dk, int dv,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, int q_offset, int kv_valid,
    float sqrt_dk, float softcap, void* stream) {
  if (!(softcap >= 0.f) || isinf(softcap)) return -1;
  const int kv_elem = kv_bf16 ? 2 : 4;
  const bool mla = dk == kMlaDK && dv == kMlaDV;
  const int d = mla ? 0 : padded_dim(dk, dv);
  if (!mla && d == 0) return -1;
  if (mla && !q_bf16) return -1;
  const bool exact = mla || (dk == d && dv == d);
  const bool alias = k == v && k_sb == v_sb && k_ss == v_ss && k_sh == v_sh &&
                     dv <= dk;
  const Args a{sq, sk, hq, hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
               v_ss, v_sh, causal, window, q_offset, kv_valid, sqrt_dk,
               static_cast<float>(1.4426950408889634 / sqrt((double)dk)),
               exact && rows_aligned(q, q_sb, q_ss, q_sh, q_bf16 ? 2 : 4),
               exact && rows_aligned(k, k_sb, k_ss, k_sh, kv_elem) &&
                   rows_aligned(v, v_sb, v_ss, v_sh, kv_elem),
               dk, dv, alias, softcap,
               softcap > 0.f ? static_cast<float>(
                                   1.0 / (sqrt((double)dk) * (double)softcap))
                             : 0.f,
               static_cast<float>(1.4426950408889634 * (double)softcap),
               static_cast<float*>(lse)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.softcap > 0.f) return launch_all<true>(q, k, v, o, q_bf16, kv_bf16,
                                               b, mla, d, a, s);
  return launch_all<false>(q, k, v, o, q_bf16, kv_bf16, b, mla, d, a, s);
}
