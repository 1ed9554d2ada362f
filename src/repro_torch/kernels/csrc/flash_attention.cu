// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_kernel_call`
// (src/repro/kernels/flash_attention.py:85, body `_kernel` :31).  Same
// function: for each query row, softmax(q k^T * dh^-1/2 + mask) v with the
// running max m, running sum l and fp32 accumulator of the TPU kernel, the
// finite mask value -0.7 * FLT_MAX (a fully masked tile is zeroed later by
// corr = exp(m_prev - m_new)), the causal skip of key tiles wholly above
// the diagonal, the sliding window kpos > qpos - window, and the final
// acc / max(l, 1e-30).  All math is fp32 (bf16 inputs are widened as they
// are staged), and the output is written in q's dtype.
//
// Layout: q and o are (B, Sq, H, dh), k and v are (B, Skv, n_kv, dh), each
// addressed through its batch, sequence and head strides (in elements; dh
// contiguous).  Query head h reads kv head h / (H / n_kv) in place, so GQA
// never materialises the reference wrapper's broadcast of K and V.  The
// (BH, S, dh) form of the TPU kernel is the case H = n_kv = 1.
//
// What bounds it on an H100: at the llama3-8b prefill (B=4, S=1024, H=32,
// dh=128, causal) the work is 2*B*H*S^2*dh = 34.4 GFLOP and the bytes are
// 84 MB, so the bound is the tensor cores' (0.035 ms at 989 TFLOP/s bf16).
// This first kernel does not reach them: it runs the fp32 math of the TPU
// kernel on the CUDA cores (67 TFLOP/s peak), which also keeps fp32 inputs
// exact to the reference's 3e-5 (no TF32).  What the design does within
// that: one CTA of 256 threads owns a 64-row query tile for all key tiles
// (the TPU's sequential K grid axis becomes the loop inside the CTA), so
// Q is read from device memory once and K/V once per query tile; each
// thread holds a 4 x 4 block of the score tile and a 4 x dh/16 block of
// the output in registers, with 16-byte shared-memory loads along dh for
// Q K^T; row max and sum are reduced with warp shuffles inside a
// half-warp.  Query tiles are scheduled longest first (causal tiles near
// the end of the sequence have the most key tiles).
//
// Head dims 16..128 in steps of 16 stage at most 116,736 B; dh 256 stages
// 4 * (64*256 + 64*260 + 64*256 + 64*68) = 215,040 B of fp32 tiles, under
// the 232,448 B a block may opt into, so one CTA per SM, each thread
// holding a 4 x 16 output block.  Head dim 8 arrives zero-padded to 16 by
// the wrapper.  This kernel is the fp32 route (dh 256 among it: 3e-5
// rules out TF32) and the bf16 route of dh 8 and 16..112 other than 64.
// bf16 at dh 64/128 goes to flash_attention_wgmma.cu and bf16 at dh 256
// (recurrentgemma-9b's local attention) to flash_attention_wgmma_d256.cu,
// both on the tensor cores.
//
// Plain C interface (bound with ctypes): pointers and the stream are
// passed as void*, and the entry returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // key rows per step
constexpr int kThreads = 256;    // 16 x 16: thread (ty, tx)
constexpr float kNegInf = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, n_kv;
  long long qb, qs, qh;          // element strides of q
  long long kb, ks, kh;          // of k
  long long vb, vs, vh;          // of v
  long long ob, os, oh;          // of o
  int causal;
  int window;                    // <= 0: no window
  float scale;
};

// Stage rows [r0, r0 + 64) of one head of a (B, S, heads, dh) tensor into
// shared memory as fp32, row stride `ld`; rows >= S are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long ss, int r0, int S) {
  for (int idx = threadIdx.x; idx < kBK * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int row = r0 + r;
    dst[r * ld + d] = row < S ? to_f32(src[(long long)row * ss + d]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Params p) {
  constexpr int NC = DH / 16;            // output columns per thread
  constexpr int LDQ = DH;                // sQ row stride (floats)
  constexpr int LDK = DH + 4;            // sK: 16-byte rows, no conflicts
  constexpr int LDV = DH;
  constexpr int LDP = kBK + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LDQ;
  float* sV = sK + kBK * LDK;
  float* sP = sV + kBK * LDV;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - blockIdx.x;    // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.n_kv);
  const int q0 = qt * kBQ;

  const T* q = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* k = static_cast<const T*>(p.k) + b * p.kb + hk * p.kh;
  const T* v = static_cast<const T*>(p.v) + b * p.vb + hk * p.vh;
  T* o = static_cast<T*>(p.o) + b * p.ob + h * p.oh;

  stage<T, DH>(sQ, LDQ, q, p.qs, q0, p.Sq);

  float m_run[4], l_run[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles whose first key is past the tile's last query row
  // are skipped, as the TPU kernel skips its blocks above the diagonal
  int k_end = p.Skv;
  if (p.causal) k_end = min(k_end, q0 + kBQ);

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                      // previous sK/sV/sP reads done
    stage<T, DH>(sK, LDK, k, p.ks, k0, p.Skv);
    stage<T, DH>(sV, LDV, v, p.vs, k0, p.Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LDK + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= p.Skv) {
          s[i][j] = -INFINITY;           // not a key: weight exactly 0
          continue;
        }
        bool ok = true;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = pij;
        sum += pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                      // sP complete

    const int kn = min(kBK, p.Skv - k0);
    for (int j = 0; j < kn; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * i) * LDP + j]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float v0 = sV[(j + 0) * LDV + col];
        const float v1 = sV[(j + 1) * LDV + col];
        const float v2 = sV[(j + 2) * LDV + col];
        const float v3 = sV[(j + 3) * LDV + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] = fmaf(pa[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pa[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pa[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pa[i].w, v3, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      from_f32(&o[(long long)row * p.os + tx + 16 * c], acc[i][c] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LDK = DH + 4;
  constexpr int LDP = kBK + 4;
  const size_t smem =
      sizeof(float) * (kBQ * DH + kBK * LDK + kBK * DH + kBQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(p, s);
    case 32: return launch<T, 32>(p, s);
    case 48: return launch<T, 48>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 80: return launch<T, 80>(p, s);
    case 96: return launch<T, 96>(p, s);
    case 112: return launch<T, 112>(p, s);
    case 128: return launch<T, 128>(p, s);
    case 256: return launch<T, 256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Skv, int H, int n_kv, int dh,
                                   const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || n_kv <= 0 ||
      H % n_kv != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, B, Sq, Skv, H, n_kv,
           strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8],
           strides[9], strides[10], strides[11],
           causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, dh, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, dh, s);
  return (int)cudaErrorInvalidValue;
}
