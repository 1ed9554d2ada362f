// Fused Mamba2 SSD chunk scan (one B/C group) for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_kernel_call`
// (src/repro/kernels/ssd_scan.py:84, body `_kernel` :38).  Same function:
// for one (batch b, head h) the sequence is cut into chunks of l steps and,
// chunk by chunk, with xdt = x * dt and acum the inclusive cumulative sum
// of A * dt inside the chunk,
//
//     y_diag = ((C B^T) o L) xdt,   L[i,j] = exp(acum_i - acum_j) if i >= j
//     y_off  = (C state^T) o exp(acum)
//     y      = y_diag + y_off
//     state  = state * exp(acum[l-1]) + (xdt o exp(acum[l-1] - acum))^T B
//
// with the (P, N) fp32 state carried from chunk to chunk.  The TPU kernel
// starts from a zero state; this one takes an optional initial state (the
// model's `ssd_scan` has one).  L is a select, not a product with a 0/1
// mask: exp(acum_i - acum_j) overflows above the diagonal and inf * 0 is
// NaN.  All inputs are fp32 (the wrapper widens bf16 inputs first); y and
// the state are fp32.
//
// Layout (contiguous): x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm
// (B, S, N), init and state (B, H, P, N), y (B, S, H, P); S = nc * l.
//
// What bounds it on an H100: at the mamba2-370m prefill (B=4, S=1024,
// H=32, P=64, N=128, l=256) the function needs about 6.6 GFLOP: the scores
// C B^T once per (b, chunk), shared by the heads, on the l (l + 1) / 2
// pairs on or below the diagonal; per (b, h, chunk) the masked scores
// times xdt on those pairs, C state^T and the state update.  Against about
// 60 MB of inputs and outputs, the bound is the fp32 rate (0.098 ms at the
// 67 TFLOP/s CUDA-core peak); the math stays fp32 to hold the reference's
// 1e-4.  What the design does
// within that: one CTA of 256 threads per (b, h) runs the chunk loop
// itself (the TPU's sequential chunk grid axis), with the state resident
// in shared memory for the whole sequence, so it is never written to
// device memory between chunks.  The l x l score matrix (256 KB at l=256)
// does not fit a CTA's 227 KB, so each chunk is walked in 64-row query
// tiles against 64-row key tiles, only the tiles on or below the diagonal
// (the causal structure of L), with each thread holding a 4 x 4 block of
// the tile in registers and 16-byte shared-memory loads along N.  Only
// B * H CTAs run (128 at B=4 on 132 SMs, one per SM at this shared-memory
// size): the scores C B^T, shared by all heads of a batch row, are
// recomputed by each head's CTA.  bf16 inputs at the mamba2 widths take
// the tensor-core kernel beside this one (ssd_scan_wgmma.cu); this kernel
// keeps fp32 and the other shapes.
//
// Plain C interface (bound with ctypes): pointers and the stream are
// passed as void*, and the entry returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows of a query / key tile
constexpr int kThreads = 256;     // 16 x 16: thread (ty, tx)
constexpr int kPMax = 64;         // head_dim
constexpr int kNMax = 128;        // d_state
constexpr int kLDN = kNMax + 4;   // smem row stride along N (floats)
constexpr int kLDP = kPMax + 4;   // along P
constexpr int kLDT = kT + 4;      // along a key tile

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* init;              // nullptr: zero initial state
  float* y;
  float* state;
  int S, H, P, N, l;
};

// Inclusive prefix sum of a[0..n) into out (one warp; n <= 32 * 64).
__device__ void warp_cumsum(const float* a, float* out, int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n);
  const int hi = min(lo + per, n);
  float tot = 0.f;
  for (int i = lo; i < hi; ++i) tot += a[i];
  float inc = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  float run = inc - tot;
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    out[i] = run;
  }
}

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sState = reinterpret_cast<float*>(smem4);   // [kPMax][kLDN]
  float* sC = sState + kPMax * kLDN;                  // [kT][kLDN]
  float* sB = sC + kT * kLDN;                         // [kT][kLDN]
  float* sX = sB + kT * kLDN;                         // [kT][kLDP]
  float* sW = sX + kT * kLDP;                         // [kT][kLDT]
  float* sAdt = sW + kT * kLDT;                       // [l]
  float* sAcum = sAdt + p.l;                          // [l]
  float* sDt = sAcum + p.l;                           // [l]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = p.H, P = p.P, N = p.N, l = p.l;
  const float A = p.A[h];
  const long long row_x = (long long)H * P;   // x / y stride along S
  const float* xb = p.x + (long long)b * p.S * row_x + (long long)h * P;
  const float* dtb = p.dt + (long long)b * p.S * H + h;
  const float* Bb = p.Bm + (long long)b * p.S * N;
  const float* Cb = p.Cm + (long long)b * p.S * N;
  float* yb = p.y + (long long)b * p.S * row_x + (long long)h * P;
  const long long st_off = ((long long)b * H + h) * P * N;

  for (int idx = tid; idx < kPMax * kNMax; idx += kThreads) {
    const int r = idx / kNMax, n = idx - r * kNMax;
    sState[r * kLDN + n] =
        (r < P && n < N && p.init) ? p.init[st_off + r * N + n] : 0.f;
  }

  const int nc = p.S / l;
  const int nt = (l + kT - 1) / kT;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * l;
    __syncthreads();
    for (int j = tid; j < l; j += kThreads) {
      const float d = dtb[(long long)(c0 + j) * H];
      sDt[j] = d;
      sAdt[j] = A * d;
    }
    __syncthreads();
    if (tid < 32) warp_cumsum(sAdt, sAcum, l);
    __syncthreads();
    const float acum_last = sAcum[l - 1];

    // ---- outputs, one 64-row query tile at a time ----
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      __syncthreads();
      for (int idx = tid; idx < kT * kNMax; idx += kThreads) {
        const int r = idx / kNMax, n = idx - r * kNMax;
        const int i = i0 + r;
        sC[r * kLDN + n] =
            (i < l && n < N) ? Cb[(long long)(c0 + i) * N + n] : 0.f;
      }
      __syncthreads();

      // y_off = (C state^T) o exp(acum): rows i, columns p
      float yo[4][4], yd[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) { yo[a][q] = 0.f; yd[a][q] = 0.f; }
      for (int n = 0; n < N; n += 4) {
        float4 ca[4], sb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          ca[a] = *reinterpret_cast<const float4*>(&sC[(ty + 16 * a) * kLDN + n]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sb[q] = *reinterpret_cast<const float4*>(&sState[(tx + 16 * q) * kLDN + n]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            yo[a][q] = fmaf(ca[a].x, sb[q].x, yo[a][q]);
            yo[a][q] = fmaf(ca[a].y, sb[q].y, yo[a][q]);
            yo[a][q] = fmaf(ca[a].z, sb[q].z, yo[a][q]);
            yo[a][q] = fmaf(ca[a].w, sb[q].w, yo[a][q]);
          }
      }

      // y_diag over the key tiles on or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();               // previous sB / sX / sW reads done
        for (int idx = tid; idx < kT * kNMax; idx += kThreads) {
          const int r = idx / kNMax, n = idx - r * kNMax;
          const int j = j0 + r;
          sB[r * kLDN + n] =
              (j < l && n < N) ? Bb[(long long)(c0 + j) * N + n] : 0.f;
        }
        for (int idx = tid; idx < kT * kPMax; idx += kThreads) {
          const int r = idx / kPMax, q = idx - r * kPMax;
          const int j = j0 + r;
          sX[r * kLDP + q] = (j < l && q < P)
              ? xb[(long long)(c0 + j) * row_x + q] * sDt[j] : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[a][q] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 ca[4], bb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            ca[a] = *reinterpret_cast<const float4*>(&sC[(ty + 16 * a) * kLDN + n]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bb[q] = *reinterpret_cast<const float4*>(&sB[(tx + 16 * q) * kLDN + n]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              s[a][q] = fmaf(ca[a].x, bb[q].x, s[a][q]);
              s[a][q] = fmaf(ca[a].y, bb[q].y, s[a][q]);
              s[a][q] = fmaf(ca[a].z, bb[q].z, s[a][q]);
              s[a][q] = fmaf(ca[a].w, bb[q].w, s[a][q]);
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            // a select: exp overflows above the diagonal (inf * 0 = NaN)
            sW[(ty + 16 * a) * kLDT + tx + 16 * q] =
                (i < l && j < l && i >= j)
                    ? s[a][q] * expf(sAcum[i] - sAcum[j]) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; j += 4) {
          float4 wa[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            wa[a] = *reinterpret_cast<const float4*>(&sW[(ty + 16 * a) * kLDT + j]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = tx + 16 * q;
            const float x0 = sX[(j + 0) * kLDP + col];
            const float x1 = sX[(j + 1) * kLDP + col];
            const float x2 = sX[(j + 2) * kLDP + col];
            const float x3 = sX[(j + 3) * kLDP + col];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              yd[a][q] = fmaf(wa[a].x, x0, yd[a][q]);
              yd[a][q] = fmaf(wa[a].y, x1, yd[a][q]);
              yd[a][q] = fmaf(wa[a].z, x2, yd[a][q]);
              yd[a][q] = fmaf(wa[a].w, x3, yd[a][q]);
            }
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= l) continue;
        const float e = expf(sAcum[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = tx + 16 * q;
          if (col < P)
            yb[(long long)(c0 + i) * row_x + col] = yd[a][q] + yo[a][q] * e;
        }
      }
    }

    // ---- state update: decay to the chunk end, add the chunk's input ----
    float cs[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) cs[a][q] = 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      for (int idx = tid; idx < kT * kNMax; idx += kThreads) {
        const int r = idx / kNMax, n = idx - r * kNMax;
        const int j = j0 + r;
        sB[r * kLDN + n] =
            (j < l && n < N) ? Bb[(long long)(c0 + j) * N + n] : 0.f;
      }
      for (int idx = tid; idx < kT * kPMax; idx += kThreads) {
        const int r = idx / kPMax, q = idx - r * kPMax;
        const int j = j0 + r;
        sX[r * kLDP + q] = (j < l && q < P)
            ? xb[(long long)(c0 + j) * row_x + q] * sDt[j]
                  * expf(acum_last - sAcum[j])
            : 0.f;
      }
      __syncthreads();
      const int jn = min(kT, l - j0);
      for (int j = 0; j < jn; ++j) {
        float xa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xa[a] = sX[j * kLDP + ty + 16 * a];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float bv = sB[j * kLDN + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a) cs[a][q] = fmaf(xa[a], bv, cs[a][q]);
        }
      }
    }
    __syncthreads();                   // every y_off read of sState done
    const float chunk_decay = expf(acum_last);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float* st = &sState[(ty + 16 * a) * kLDN + tx + 16 * q];
        *st = *st * chunk_decay + cs[a][q];
      }
  }

  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    p.state[st_off + idx] = sState[r * kLDN + n];
  }
}

}  // namespace

// All pointers are float32, contiguous; init may be null.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* init,
                            void* y, void* state, int Bsz, int S, int H,
                            int P, int N, int chunk, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 ||
      S % chunk != 0 || P > kPMax || N > kNMax || P % 4 != 0 ||
      N % 4 != 0 || chunk > 2048 || Bsz > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(Bm),
           static_cast<const float*>(Cm), static_cast<const float*>(init),
           static_cast<float*>(y), static_cast<float*>(state),
           S, H, P, N, chunk};
  const size_t smem = sizeof(float) *
      (kPMax * kLDN + 2 * kT * kLDN + kT * kLDP + kT * kLDT + 3 * chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
