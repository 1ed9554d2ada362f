// Layered-resolution int8 digit-plane matmul for Hopper (sm_90a), at any
// number of planes m: the layers split into groups, one group per CTA.
//
// The first port past four planes of the TPU kernel
// `layered_matmul_kernel_call` (src/repro/kernels/layered_matmul.py:71,
// body `_kernel` :39), no longer routed: layered_matmul_wgmma_grouped.cu
// takes every m >= 4 on the tensor cores.  It stays reachable through
// `layered_matmul._launch(kernel="layered_matmul_grouped")`, so that
// chip_smoke.py holds it against the plain version and times it beside
// that kernel.  From int8 digit planes A_i (M x K) and
// B_j (N x K), both K-contiguous, it writes the L = 2m-1 exact int32
// anti-diagonal partials
//
//     out[l] = sum_{i+j = 2m-2-l} A_i B_j^T          (unscaled, per layer)
//
// Why groups: the register-resident designs (layered_matmul.cu,
// layered_matmul_wgmma.cu) hold every layer's accumulators of a tile at
// once, 16 int32 a thread a layer for a 64x64 tile of 256 threads; past
// m = 4 (L = 7) that no longer fits the register file.  Here each CTA
// owns one 64x64 output tile and a group of at most kGroup = 7 layers
// (grid.z is the group), and runs only the plane pairs of its layers
// (`layering.layer_minijobs`).  At each 32-byte K step it stages the A and
// B planes its layers use in shared memory, at most kChunk of each at a
// time (so any m fits: more planes are staged chunk by chunk), and every
// warp reads its fragments of both operands of a pair from there before
// its mma.sync m16n8k32 s8.  No prefetch, no TMA: a simple kernel that
// is right.
//
// Numerics as layered_matmul.cu: int32 accumulation wraps like the TPU's
// int32 MXU output; ragged M and N edges are masked (rows past the end
// load as zero, outputs past it are not stored); K % 16 == 0 and 16-byte
// aligned planes, so every load is one 16-byte vector.
//
// Plain C interface (bound with ctypes): pointers and the stream are
// passed as void*, and the entry returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;             // output rows (M) per CTA
constexpr int kBN = 64;             // output cols (N) per CTA
constexpr int kBK = 32;             // K bytes per step: one mma k32
constexpr int kLDS = kBK + 16;      // padded smem row: 48 B = 12 words,
                                    // conflict-free fragment loads
constexpr int kTile = kBM * kLDS;   // bytes of one staged plane tile
constexpr int kThreads = 256;       // 8 warps: 2 (M) x 4 (N), 32x16 each
constexpr int kGroup = 7;           // layers per CTA (7 x 16 accumulators)
constexpr int kChunk = 16;          // planes of each operand staged at once

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage planes [p0, p0 + n) of one operand's 64-row tile at K offset k0:
// 128 threads (`lt` = 0..127), each one 16-byte chunk (row lt/2, bytes
// (lt%2)*16) of every plane.  Rows >= rows_total and bytes >= K read as 0.
__device__ __forceinline__ void stage(int8_t* tiles,
                                      const int8_t* __restrict__ planes,
                                      size_t plane_bytes, int rows_total,
                                      int K, int row0, int k0, int p0, int n,
                                      int lt) {
  const int r = lt >> 1;
  const int c = (lt & 1) * 16;
  const int gr = row0 + r;
  const int gk = k0 + c;
  const bool in = gr < rows_total && gk < K;
  for (int p = 0; p < n; ++p) {
    int4 v = make_int4(0, 0, 0, 0);
    if (in)
      v = __ldg(reinterpret_cast<const int4*>(
          planes + (size_t)(p0 + p) * plane_bytes + (size_t)gr * K + gk));
    *reinterpret_cast<int4*>(tiles + p * kTile + r * kLDS + c) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
layered_matmul_grouped_kernel(const int8_t* __restrict__ a,   // (m, M, K)
                              const int8_t* __restrict__ b,   // (m, N, K)
                              int32_t* __restrict__ out,      // (2m-1, M, N)
                              int m, int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int L = 2 * m - 1;
  const int l0 = blockIdx.z * kGroup;
  const int l1 = min(L, l0 + kGroup);
  // the pair sums s = i + j of this group's layers, and the planes they use
  const int s_lo = 2 * m - 1 - l1;
  const int s_hi = 2 * m - 2 - l0;
  const int plo = max(0, s_lo - (m - 1));
  const int phi = min(m - 1, s_hi);
  const int chunk = min(kChunk, phi - plo + 1);
  int8_t* As = smem;                     // [chunk][kTile]
  int8_t* Bs = smem + chunk * kTile;     // [chunk][kTile]

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;           // mma groupID
  const int t = lane & 3;            // mma threadID_in_group
  const int wm = (warp >> 2) * 32;   // warp tile origin in the CTA tile
  const int wn = (warp & 3) * 16;
  const bool loads_a = threadIdx.x < 128;
  const int lt = threadIdx.x & 127;

  int acc[kGroup][2][2][4];
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][x][y][e] = 0;

  const size_t a_plane = (size_t)M * K;
  const size_t b_plane = (size_t)N * K;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int ia = plo; ia <= phi; ia += chunk) {
      const int na = min(chunk, phi + 1 - ia);
      for (int jb = plo; jb <= phi; jb += chunk) {
        const int nb = min(chunk, phi + 1 - jb);
        // skip a chunk pair none of whose sums lies in this group
        if (ia + jb > s_hi || ia + na - 1 + jb + nb - 1 < s_lo) continue;
        if (loads_a)
          stage(As, a, a_plane, M, K, m0, k0, ia, na, lt);
        else
          stage(Bs, b, b_plane, N, K, n0, k0, jb, nb, lt);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int l = l0 + q;
          if (l >= l1) break;
          const int s = 2 * m - 2 - l;
          const int i_lo = max(ia, s - (jb + nb - 1));
          const int i_hi = min(ia + na - 1, s - jb);
          for (int i = i_lo; i <= i_hi; ++i) {
            const int j = s - i;
            uint32_t af[2][4];
            uint32_t bf[2][2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int8_t* base = As + (i - ia) * kTile +
                                   (wm + x * 16 + g) * kLDS + t * 4;
              af[x][0] = *reinterpret_cast<const uint32_t*>(base);
              af[x][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLDS);
              af[x][2] = *reinterpret_cast<const uint32_t*>(base + 16);
              af[x][3] =
                  *reinterpret_cast<const uint32_t*>(base + 8 * kLDS + 16);
            }
#pragma unroll
            for (int y = 0; y < 2; ++y) {
              const int8_t* base = Bs + (j - jb) * kTile +
                                   (wn + y * 8 + g) * kLDS + t * 4;
              bf[y][0] = *reinterpret_cast<const uint32_t*>(base);
              bf[y][1] = *reinterpret_cast<const uint32_t*>(base + 16);
            }
#pragma unroll
            for (int x = 0; x < 2; ++x)
#pragma unroll
              for (int y = 0; y < 2; ++y) mma_s8(acc[q][x][y], af[x], bf[y]);
          }
        }
        __syncthreads();  // every warp is done reading the staged tiles
      }
    }
  }

  // c0,c1 -> row g, cols 2t,2t+1; c2,c3 -> row g+8, same cols
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    const int l = l0 + q;
    if (l >= l1) break;
    int32_t* o = out + (size_t)l * M * N;
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + wm + x * 16 + g + (e >> 1) * 8;
          const int col = n0 + wn + y * 8 + t * 2 + (e & 1);
          if (row < M && col < N) o[(size_t)row * N + col] = acc[q][x][y][e];
        }
  }
}

}  // namespace

// a: (m, M, K) int8, b: (m, N, K) int8, out: (2m-1, M, N) int32; all
// contiguous on the current device, K % 16 == 0 and a, b 16-byte aligned.
// Any m >= 1.  Returns a cudaError_t code (0 = ok).
extern "C" int layered_matmul_grouped_s8(const void* a, const void* b,
                                         void* out, int m, int M, int N,
                                         int K, void* stream) {
  if (m < 1 || M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      (uintptr_t)a % 16 != 0 || (uintptr_t)b % 16 != 0 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int L = 2 * m - 1;
  const int groups = (L + kGroup - 1) / kGroup;
  // the most planes one group stages at once: a middle group's layers use
  // every plane
  const size_t smem = 2 * (size_t)(m < kChunk ? m : kChunk) * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      layered_matmul_grouped_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, groups);
  layered_matmul_grouped_kernel<<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(out), m, M, N, K);
  return (int)cudaGetLastError();
}
