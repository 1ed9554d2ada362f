// Layered-resolution int8 digit-plane matmul for Hopper (sm_90a).
//
// The first port (m <= 4) of the TPU kernel `layered_matmul_kernel_call`
// (src/repro/kernels/layered_matmul.py:71, body `_kernel` :39), no longer
// routed: layered_matmul_wgmma.cu takes m <= 3 and
// layered_matmul_wgmma_grouped.cu m >= 4.  It stays reachable through
// `layered_matmul._launch(kernel="layered_matmul")`, so that chip_smoke.py
// holds it against the plain version and times it beside them.  Same
// function: from int8 digit planes A_i (M x K) and B_j (N x K), both
// K-contiguous, it writes the L = 2m-1 exact int32 anti-diagonal partials
//
//     out[l] = sum_{i+j = 2m-2-l} A_i B_j^T          (unscaled, per layer)
//
// What bounds it on an H100: at the LM-head contraction (K=4096, M=64,
// N=128256, m=2) the m*K*N bytes of B planes dominate and the kernel is
// memory-bound (~0.34 ms at 3.35 TB/s); at a square 4096^3 it is
// compute-bound (~0.28 ms at 1979 int8 TOP/s).  What the design does about
// it: each CTA owns one 64x64 output tile for ALL L layers and loops over
// K itself (the TPU's sequential K grid axis becomes this loop).  At each
// K step it stages the m A-plane and m B-plane tiles in shared memory once
// and reuses them for all m^2 plane products, so every plane byte is read
// from device memory once per tile instead of once per plane pair; the
// next K step's tiles are prefetched into registers while the tensor cores
// (mma.sync m16n8k32 s8) work on the current one.  wgmma, TMA and a
// multistage shared-memory ring are the kernels that replaced it.
//
// Numerics: int32 accumulation wraps like the TPU's int32 MXU output; the
// partials are exact while J(l) * K * (2^d - 1)^2 < 2^31.  Ragged M and N
// edges are masked here: out-of-range rows load as zero and out-of-range
// outputs are not stored.  K must be a multiple of 16 and the planes
// 16-byte aligned, so every load is one 16-byte vector; the wrappers pad K
// with zeros, which add nothing to a partial.
//
// Plain C interface (bound with ctypes): pointers and the stream are
// passed as void*, and the entry returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;             // output rows (M) per CTA
constexpr int kBN = 64;             // output cols (N) per CTA
constexpr int kBK = 64;             // K bytes per step
constexpr int kLDS = kBK + 16;      // padded smem row: 80 B = 20 words,
                                    // conflict-free fragment loads
constexpr int kThreads = 256;       // 8 warps: 2 (M) x 4 (N), 32x16 each

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One thread's 16-byte share of a 64 x 64-byte plane tile: row tid/4,
// bytes (tid%4)*16 .. +15.  Rows >= rows_total and bytes >= K read as 0;
// K % 16 == 0, so a chunk is wholly inside K or wholly past it.
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ plane,
                                           int rows_total, int K, int row0,
                                           int k0) {
  const int r = threadIdx.x >> 2;
  const int c = (threadIdx.x & 3) * 16;
  const int gr = row0 + r;
  const int gk = k0 + c;
  if (gr >= rows_total || gk >= K) return make_int4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const int4*>(plane + (size_t)gr * K + gk));
}

__device__ __forceinline__ void store_chunk(int8_t* tile, int4 v) {
  const int r = threadIdx.x >> 2;
  const int c = (threadIdx.x & 3) * 16;
  *reinterpret_cast<int4*>(tile + r * kLDS + c) = v;
}

template <int MP>
__global__ void __launch_bounds__(kThreads)
layered_matmul_kernel(const int8_t* __restrict__ a,   // (MP, M, K)
                      const int8_t* __restrict__ b,   // (MP, N, K)
                      int32_t* __restrict__ out,      // (2MP-1, M, N)
                      int M, int N, int K) {
  constexpr int L = 2 * MP - 1;
  __shared__ __align__(16) int8_t As[MP][kBM * kLDS];
  __shared__ __align__(16) int8_t Bs[MP][kBN * kLDS];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // mma groupID
  const int t = lane & 3;            // mma threadID_in_group
  const int wm = (warp >> 2) * 32;   // warp tile origin in the CTA tile
  const int wn = (warp & 3) * 16;

  int acc[L][2][2][4];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[l][x][y][e] = 0;

  const size_t a_plane = (size_t)M * K;
  const size_t b_plane = (size_t)N * K;
  int4 ra[MP], rb[MP];
#pragma unroll
  for (int p = 0; p < MP; ++p) {
    ra[p] = load_chunk(a + p * a_plane, M, K, m0, 0);
    rb[p] = load_chunk(b + p * b_plane, N, K, n0, 0);
  }
#pragma unroll
  for (int p = 0; p < MP; ++p) {
    store_chunk(As[p], ra[p]);
    store_chunk(Bs[p], rb[p]);
  }
  __syncthreads();

  const int nk = (K + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {  // next step's global loads overlap this step's mma
#pragma unroll
      for (int p = 0; p < MP; ++p) {
        ra[p] = load_chunk(a + p * a_plane, M, K, m0, (kt + 1) * kBK);
        rb[p] = load_chunk(b + p * b_plane, N, K, n0, (kt + 1) * kBK);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[MP][2][4];
      uint32_t bf[MP][2][2];
#pragma unroll
      for (int p = 0; p < MP; ++p) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int8_t* base = As[p] + (wm + x * 16 + g) * kLDS + kk + t * 4;
          af[p][x][0] = *reinterpret_cast<const uint32_t*>(base);
          af[p][x][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLDS);
          af[p][x][2] = *reinterpret_cast<const uint32_t*>(base + 16);
          af[p][x][3] =
              *reinterpret_cast<const uint32_t*>(base + 8 * kLDS + 16);
        }
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int8_t* base = Bs[p] + (wn + y * 8 + g) * kLDS + kk + t * 4;
          bf[p][y][0] = *reinterpret_cast<const uint32_t*>(base);
          bf[p][y][1] = *reinterpret_cast<const uint32_t*>(base + 16);
        }
      }
      // all m^2 plane pairs from the same staged tiles, each into the
      // accumulator of its layer l = 2m-2-(i+j)
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < MP; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y)
              mma_s8(acc[2 * MP - 2 - i - j][x][y], af[i][x], bf[j][y]);
    }
    if (more) {
      __syncthreads();  // every warp is done reading this step's tiles
#pragma unroll
      for (int p = 0; p < MP; ++p) {
        store_chunk(As[p], ra[p]);
        store_chunk(Bs[p], rb[p]);
      }
      __syncthreads();
    }
  }

  // c0,c1 -> row g, cols 2t,2t+1; c2,c3 -> row g+8, same cols
#pragma unroll
  for (int l = 0; l < L; ++l) {
    int32_t* o = out + (size_t)l * M * N;
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + wm + x * 16 + g + (e >> 1) * 8;
          const int col = n0 + wn + y * 8 + t * 2 + (e & 1);
          if (row < M && col < N) o[(size_t)row * N + col] = acc[l][x][y][e];
        }
  }
}

template <int MP>
cudaError_t launch(const int8_t* a, const int8_t* b, int32_t* out, int M,
                   int N, int K, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  layered_matmul_kernel<MP><<<grid, kThreads, 0, stream>>>(a, b, out, M, N,
                                                           K);
  return cudaGetLastError();
}

}  // namespace

// a: (m, M, K) int8, b: (m, N, K) int8, out: (2m-1, M, N) int32; all
// contiguous on the current device, K % 16 == 0 and a, b 16-byte aligned.
// Returns a cudaError_t code (0 = ok).
extern "C" int layered_matmul_s8(const void* a, const void* b, void* out,
                                 int m, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      (uintptr_t)a % 16 != 0 || (uintptr_t)b % 16 != 0 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return (int)launch<1>(pa, pb, po, M, N, K, s);
    case 2: return (int)launch<2>(pa, pb, po, M, N, K, s);
    case 3: return (int)launch<3>(pa, pb, po, M, N, K, s);
    case 4: return (int)launch<4>(pa, pb, po, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Largest plane count the kernel is instantiated for.
extern "C" int layered_matmul_max_planes() { return 4; }
