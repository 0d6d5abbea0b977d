// flash_attention: the attention forward of every prefill of the LM stack,
// softmax(q k^T / sqrt(dk) + mask) v per query head, online over KV tiles.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (repro/kernels/flash_attn.py, `_flash_fwd_kernel`) and, through the port's
// `attend`, the blockwise scan it stands for (repro/models/attention.py
// `_flash_fwd`). The port's plain version is repro_torch/kernels/ref.py
// `flash_attention_ref`. Beyond the TPU kernel's causal mask and q_offset it
// takes the masks of the function it replaces: key j is valid for the query
// at absolute position p = q_offset + i when j < kv_valid_len, j <= p if
// causal, and p - j < window if window > 0. GQA reads KV head h / g for query
// head h; K and V are not repeated.
//
// Types: q is bf16 or f32, K and V (one type) bf16 or f32, each read in its
// own type. Scores, softmax and the P.V sum are float32 as in both JAX
// versions; the output is written in q's type (round to nearest even).
//
// What bounds it on an H100: at the serving path's prefill shapes (B = 8,
// S = 2048, 32 query heads over 8 KV heads, head_dim 80) operations, 4 *
// B * Hq * hd * (valid keys summed over the rows) ~ 1.7e11 a layer; the bytes
// (q, K, V read once, the output written once) ~ 0.25 GB.
//
// The simple design (making it fast is later work: wgmma, TMA, bf16 tiles):
// one block of 256 threads per (64 query rows, query head, batch row). The
// block keeps its Q tile (scaled) in shared memory and walks the KV tiles of
// 64 keys that its rows can see, from the first tile the window allows to the
// last one the causal limit, kv_valid_len and Sk allow; wholly masked tiles
// are never read. Each thread owns 4 rows x 4 keys of the score tile and 4
// rows x dv/16 columns of the output, all on CUDA cores in float32; a row's
// running (m, l) is reduced across its 16 threads with warp shuffles. A
// masked score contributes p = 0, which gives the reference's result for
// every row with at least one valid key; the wrapper refuses arguments that
// would leave a row with none. Shared memory: Q and K tiles with a stride of
// dk + 1 floats (no bank conflicts), V, and the P tile: 78.6 KB at dk = 80.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: tx picks keys/columns, ty rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  int sq, sk, hq, hkv;
  long long q_sb, q_ss, q_sh;  // element strides of batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, q_offset, kv_valid;
  float sqrt_dk;
};

template <int DK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (DK + 1) + kBK * (DK + 1) + kBK * DV + kBQ * (kBK + 1));
}

template <typename TQ, typename TKV, int DK, int DV>
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
    sQ[r * (DK + 1) + d] =
        q0 + r < a.sq ? to_float(qb[(q0 + r) * a.q_ss + d]) / a.sqrt_dk : 0.f;
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
      sK[c * (DK + 1) + d] =
          kv0 + c < a.sk ? to_float(kb[(kv0 + c) * a.k_ss + d]) : 0.f;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int c = i / DV, d = i - c * DV;
      sV[c * DV + d] =
          kv0 + c < a.sk ? to_float(vb[(kv0 + c) * a.v_ss + d]) : 0.f;
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
    TQ* orow = o + ((static_cast<long long>(b) * a.sq + r) * a.hq + h) * DV;
#pragma unroll
    for (int n = 0; n < kCols; ++n) store(orow + tx + 16 * n, acc[i][n] / den);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           const Args& a, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<TQ, TKV, D, D>;
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

template <typename TQ, typename TKV>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<TQ, TKV, 64>(q, k, v, o, b, a, stream);
    case 80: return launch<TQ, TKV, 80>(q, k, v, o, b, a, stream);
    case 96: return launch<TQ, TKV, 96>(q, k, v, o, b, a, stream);
    case 128: return launch<TQ, TKV, 128>(q, k, v, o, b, a, stream);
    default: return -1;
  }
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bf16, 0 for float32. Head dims 64, 80, 96 and 128
// with dk == dv; anything else returns -1 without a launch. Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, int q_bf16,
    int kv_bf16, int b, int sq, int sk, int hq, int hkv, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, int q_offset, int kv_valid,
    float sqrt_dk, void* stream) {
  const Args a{sq,   sk,   hq,   hkv,    q_sb,   q_ss,     q_sh,     k_sb,
               k_ss, k_sh, v_sb, v_ss,   v_sh,   causal,   window,   q_offset,
               kv_valid, sqrt_dk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, b, d, a, s);
  if (q_bf16) return launch_d<__nv_bfloat16, float>(q, k, v, o, b, d, a, s);
  if (kv_bf16) return launch_d<float, __nv_bfloat16>(q, k, v, o, b, d, a, s);
  return launch_d<float, float>(q, k, v, o, b, d, a, s);
}
