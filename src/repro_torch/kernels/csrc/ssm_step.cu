// The Mamba2 decode step between the five input projections and out_proj
// (models/ssm.py, ssm_decode_step) for one token of every row: the three
// depthwise conv windows, the state update and readout, the gated norm.
//
// Replaces no TPU kernel.  The reference's decode step is plain jnp
// (src/repro/models/ssm.py, ssm_decode_step), which XLA fuses; in eager
// PyTorch the same chain is some 50 device kernels a layer, and it passes
// over the fp32 state 9 to 10 times.
//
// For row b, head h, channel c = h P + p and state index n, with each
// conv window ending in the new input:
//
//   x_c = silu(sum_k win_x[k, c] w_x[k, c] + b_x[c])   (B_n, C_n alike,
//                                                     over the B, C windows)
//   dt  = softplus(dt_raw[h] + dt_bias[h]),  dA = exp(-exp(A_log[h]) dt)
//   s   = s dA + (dt B_n) x_c                 (the fp32 state, in place)
//   y_c = sum_n s C_n + D[h] x_c
//   z_c = y_c silu(gate_c)
//   out_c = z_c rsqrt(mean_c z_c^2 + eps) (1 + norm[c])
//
// and every window shifted one step on, in place.  Values are rounded to
// the activations' type where the plain chain rounds them: the conv
// outputs, y before the gate, the output.  The rest is fp32.
//
// What bounds it on an H100: the state, read and written once.  It is
// (B, H, P, N) fp32: 2 x 67 MB a layer at mamba2-370m's batch of 64 and
// 2 x 134 MB at granite-4.0-h-small's batch of 32 at 128 heads, 0.040 and
// 0.080 ms at 3.35 TB/s.  At about 0.25 flop a byte it is work for the
// CUDA cores' loads and stores, not for the tensor cores.
//
// What the design does about it.  Three launches.  The first takes a
// thread per channel of a row: the conv outputs of x, B and C and each
// head's dt and decay into a small fp32 scratch, and every window shifted
// in place (no later launch reads the windows; the B and C windows are
// shared by every head of the row, so no launch that reads them per head
// may shift them).  The second, the state pass, takes one CTA of 128
// threads per (head, row).  It issues the loads of its head's first 64
// state rows before anything else: a row's N floats lie across N / 4
// neighbouring lanes, 16 bytes a lane, so a warp reads 512 contiguous
// bytes at each load; while they are in flight it reads its head's conv
// outputs, dt and decay from the scratch.  Then it updates each row,
// stores it once, and reduces y over the row's lanes by shuffles; last,
// the gate, z into a scratch, and the head's sum of z^2 in a fixed order.
// With the conv inside this pass (one launch fewer) each CTA waited on
// the windows' loads and the B and C conv ran once a head: on an H100 the
// pass took 81.6 us at mamba2-370m's shape, 54.4 with the conv taken
// out.  The third takes a CTA per 1024 channels
// of a row: the row's sum over its heads in a fixed order (so every run
// gives the same bits, and a graph replay equals the eager step), then
// the norm and the output.
//
// Nothing is allocated here and nothing waits on the host: the wrapper
// (kernels/ssm_step.py) gives the output and the scratch, the launches go
// to its stream, and the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kConvThreads = 256;
constexpr int kThreads = 128;            // the state kernel's CTA: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // state rows loaded at once
constexpr int kNormThreads = 256;
constexpr int kNormChannels = 1024;      // channels a norm CTA writes
constexpr int kMaxP = 256;
constexpr int kMaxConv = 8;              // taps, the new input's included

// element types, as the wrapper codes them
enum : int { kF32 = 0, kBF16 = 1 };
// each array's entry in Params::types
enum : int { tAct, tConvX, tConvB, tConvC, tWx, tBx, tWb, tBb, tWc, tBc,
             tALog, tD, tDtBias, tNorm, kTypes };

struct Params {
  const void *gate, *x, *b, *c, *dt;   // (B, d_in), (B, d_in), (B, N) x 2,
                                       // (B, H): the activations' type
  void *conv_x, *conv_b, *conv_c;      // (B, K, d_in), (B, K, N) x 2
  float* state;                        // (B, H, P, N)
  const void *wx, *bx, *wb, *bb, *wc, *bc;   // taps (K + 1, C), biases (C)
  const void *a_log, *d, *dt_bias;     // (H)
  const void* norm;                    // (d_in)
  void* out;                           // (B, d_in): the activations' type
  float* u;                            // (B, d_in + 2 N + 2 H) scratch: the
                                       // conv outputs of x, B, C, then dt
                                       // and dA of each head
  float* z;                            // (B, d_in) scratch
  float* part;                         // (B, H) scratch: the heads' sums
  int B, H, P, N, K;                   // K: the windows' depth, d_conv - 1
  float eps;
  int types[kTypes];
};

__device__ __forceinline__ float ld(const void* p, int type, size_t i) {
  if (type == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int type, size_t i, float v) {
  if (type == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// v rounded to `type` and back
__device__ __forceinline__ float rounded(int type, float v) {
  if (type == kBF16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// torch's softplus at beta 1, threshold 20
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

// channel c of row b: the conv over the window (cache (B, K, C) of type tc)
// ending in the new input v, its bias added, through silu
__device__ __forceinline__ float conv(const void* cache, int tc,
                                      const void* w, int tw,
                                      const void* bias, int tb, int b, int K,
                                      int C, int c, float v) {
  const size_t at = (size_t)b * K * C + c;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k)
    acc = fmaf(ld(cache, tc, at + (size_t)k * C), ld(w, tw, (size_t)k * C + c),
               acc);
  acc = fmaf(v, ld(w, tw, (size_t)K * C + c), acc);
  return silu(acc + ld(bias, tb, c));
}

// channel c's window of row b moved one step on: the oldest input out,
// v in
__device__ __forceinline__ void shift(void* cache, int tc, int b, int K,
                                      int C, int c, float v) {
  const size_t at = (size_t)b * K * C + c;
  for (int k = 1; k < K; ++k)
    st(cache, tc, at + (size_t)(k - 1) * C, ld(cache, tc, at + (size_t)k * C));
  st(cache, tc, at + (size_t)(K - 1) * C, v);
}

// one thread a channel of a row: the conv outputs of x, B and C and each
// head's dt and decay into the scratch u, each window shifted one step on
__global__ void __launch_bounds__(kConvThreads) ssm_step_conv_kernel(Params p) {
  const int b = blockIdx.y, c = blockIdx.x * kConvThreads + threadIdx.x;
  const int H = p.H, N = p.N, K = p.K, d_in = H * p.P;
  const auto& ty = p.types;
  float* u = p.u + (size_t)b * (d_in + 2 * N + 2 * H);
  if (c < d_in) {
    const float v = ld(p.x, ty[tAct], (size_t)b * d_in + c);
    u[c] = rounded(ty[tAct], conv(p.conv_x, ty[tConvX], p.wx, ty[tWx], p.bx,
                                  ty[tBx], b, K, d_in, c, v));
    shift(p.conv_x, ty[tConvX], b, K, d_in, c, v);
  } else if (c < d_in + N) {
    const int n = c - d_in;
    const float v = ld(p.b, ty[tAct], (size_t)b * N + n);
    u[c] = rounded(ty[tAct], conv(p.conv_b, ty[tConvB], p.wb, ty[tWb], p.bb,
                                  ty[tBb], b, K, N, n, v));
    shift(p.conv_b, ty[tConvB], b, K, N, n, v);
  } else if (c < d_in + 2 * N) {
    const int n = c - d_in - N;
    const float v = ld(p.c, ty[tAct], (size_t)b * N + n);
    u[c] = rounded(ty[tAct], conv(p.conv_c, ty[tConvC], p.wc, ty[tWc], p.bc,
                                  ty[tBc], b, K, N, n, v));
    shift(p.conv_c, ty[tConvC], b, K, N, n, v);
  } else if (c < d_in + 2 * N + H) {
    const int h = c - d_in - 2 * N;
    const float dt = softplus(ld(p.dt, ty[tAct], (size_t)b * H + h) +
                              ld(p.dt_bias, ty[tDtBias], h));
    u[c] = dt;
    u[c + H] = expf(dt * -expf(ld(p.a_log, ty[tALog], h)));
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads) ssm_step_state_kernel(Params p) {
  constexpr int L = N / 4;                 // lanes a state row, 16 B each
  constexpr int kRows = kThreads / L;      // rows the CTA covers a pass
  constexpr int U = kChunk / kRows;        // passes a chunk
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0 && U >= 1,
                "N / 4 is a power of two of at most 32");
  __shared__ float xs[kMaxP], ys[kMaxP];
  __shared__ __align__(16) float bs[N];
  __shared__ __align__(16) float cs[N];
  __shared__ float red[kWarps];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int H = p.H, P = p.P, d_in = H * P;
  const int sl = tid % L, r0 = tid / L;
  const auto& ty = p.types;
  float4* rows =
      reinterpret_cast<float4*>(p.state + ((size_t)b * H + h) * P * N);
  const float* u = p.u + (size_t)b * (d_in + 2 * N + 2 * H);

  float4 s[U];
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int r = base + i * kRows + r0;
      s[i] = r < P ? rows[(size_t)r * L + sl] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load(0);

  for (int t = tid; t < P; t += kThreads) xs[t] = u[h * P + t];
  for (int n = tid; n < N; n += kThreads) {
    bs[n] = u[d_in + n];
    cs[n] = u[d_in + N + n];
  }
  const float dt = u[d_in + 2 * N + h], dA = u[d_in + 2 * N + H + h];
  const float D = ld(p.d, ty[tD], h);
  __syncthreads();

  float4 db = reinterpret_cast<const float4*>(bs)[sl];
  db.x *= dt; db.y *= dt; db.z *= dt; db.w *= dt;
  const float4 cv = reinterpret_cast<const float4*>(cs)[sl];
  for (int base = 0; base < P; base += kChunk) {
    if (base) load(base);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int r = base + i * kRows + r0;
      const float x = r < P ? xs[r] : 0.0f;
      float4 v = s[i];
      v.x = fmaf(v.x, dA, db.x * x);
      v.y = fmaf(v.y, dA, db.y * x);
      v.z = fmaf(v.z, dA, db.z * x);
      v.w = fmaf(v.w, dA, db.w * x);
      float y = fmaf(v.w, cv.w, fmaf(v.z, cv.z, fmaf(v.y, cv.y, v.x * cv.x)));
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        y += __shfl_xor_sync(0xffffffffu, y, o);
      if (r < P) {
        rows[(size_t)r * L + sl] = v;
        if (sl == 0) ys[r] = y;
      }
    }
  }
  __syncthreads();

  float sq = 0.0f;
  for (int t = tid; t < P; t += kThreads) {
    const size_t i = (size_t)b * d_in + h * P + t;
    const float y = rounded(ty[tAct], ys[t] + D * xs[t]);
    const float z = y * silu(ld(p.gate, ty[tAct], i));
    p.z[i] = z;
    sq = fmaf(z, z, sq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((tid & 31) == 0) red[tid >> 5] = sq;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    p.part[(size_t)b * H + h] = total;
  }
}

// a CTA per kNormChannels channels of a row: the row's sum of squares over
// its heads' sums, always in the same order, then the norm and the output
__global__ void __launch_bounds__(kNormThreads) ssm_step_norm_kernel(Params p) {
  __shared__ float scale;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int H = p.H, d_in = H * p.P;
  const auto& ty = p.types;
  if (tid < 32) {
    float s = 0.0f;
    for (int h = tid; h < H; h += 32) s += p.part[(size_t)b * H + h];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) scale = rsqrtf(s / (float)d_in + p.eps);
  }
  __syncthreads();
  const float r = scale;
  const int c0 = blockIdx.x * kNormChannels;
  const int c1 = min(c0 + kNormChannels, d_in);
  for (int c = c0 + tid; c < c1; c += kNormThreads) {
    const size_t i = (size_t)b * d_in + c;
    st(p.out, ty[tAct], i, p.z[i] * r * (1.0f + ld(p.norm, ty[tNorm], c)));
  }
}

}  // namespace

// ptrs: gate, x, B, C, dt, conv_x, conv_B, conv_C, state, the x, B and C
// taps and biases, A_log, D, dt_bias, norm, out, u, z, part (23 device
// pointers); ints: B, H, P, N, K, then the 14 type codes of Params::types
extern "C" int ssm_step(const void* const* ptrs, const int* ints, float eps,
                        void* stream) {
  Params p;
  p.gate = ptrs[0]; p.x = ptrs[1]; p.b = ptrs[2]; p.c = ptrs[3];
  p.dt = ptrs[4];
  p.conv_x = const_cast<void*>(ptrs[5]);
  p.conv_b = const_cast<void*>(ptrs[6]);
  p.conv_c = const_cast<void*>(ptrs[7]);
  p.state = static_cast<float*>(const_cast<void*>(ptrs[8]));
  p.wx = ptrs[9]; p.bx = ptrs[10]; p.wb = ptrs[11]; p.bb = ptrs[12];
  p.wc = ptrs[13]; p.bc = ptrs[14];
  p.a_log = ptrs[15]; p.d = ptrs[16]; p.dt_bias = ptrs[17];
  p.norm = ptrs[18];
  p.out = const_cast<void*>(ptrs[19]);
  p.u = static_cast<float*>(const_cast<void*>(ptrs[20]));
  p.z = static_cast<float*>(const_cast<void*>(ptrs[21]));
  p.part = static_cast<float*>(const_cast<void*>(ptrs[22]));
  p.B = ints[0]; p.H = ints[1]; p.P = ints[2]; p.N = ints[3]; p.K = ints[4];
  p.eps = eps;
  for (int i = 0; i < kTypes; ++i) {
    p.types[i] = ints[5 + i];
    if (p.types[i] != kF32 && p.types[i] != kBF16)
      return (int)cudaErrorInvalidValue;
  }
  if (p.B < 1 || p.B > 65535 || p.H < 1 || p.P < 1 || p.P > kMaxP ||
      p.K < 1 || p.K >= kMaxConv)
    return (int)cudaErrorInvalidValue;
  if (p.N != 16 && p.N != 32 && p.N != 64 && p.N != 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d_in = p.H * p.P;
  const int channels = d_in + 2 * p.N + p.H;
  ssm_step_conv_kernel<<<dim3((channels + kConvThreads - 1) / kConvThreads,
                              p.B), kConvThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, p.B);
  switch (p.N) {
    case 16: ssm_step_state_kernel<16><<<grid, kThreads, 0, s>>>(p); break;
    case 32: ssm_step_state_kernel<32><<<grid, kThreads, 0, s>>>(p); break;
    case 64: ssm_step_state_kernel<64><<<grid, kThreads, 0, s>>>(p); break;
    case 128: ssm_step_state_kernel<128><<<grid, kThreads, 0, s>>>(p); break;
    default: break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssm_step_norm_kernel<<<dim3((d_in + kNormChannels - 1) / kNormChannels,
                              p.B), kNormThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
