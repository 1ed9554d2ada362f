// Layered-resolution int8 digit-plane matmul on Hopper's tensor cores
// (sm_90a): int8 wgmma fed by TMA through a multistage mbarrier ring.
//
// Replaces the TPU kernel `layered_matmul_kernel_call`
// (src/repro/kernels/layered_matmul.py:71, body `_kernel` :39) for up to
// three planes; four planes and more go to
// layered_matmul_wgmma_grouped.cu.  Same function: from int8 digit
// planes A_i (M x K) and B_j (N x K), both K-contiguous, it writes the
// L = 2m-1 exact int32 anti-diagonal partials
//
//     out[l] = sum_{i+j = 2m-2-l} A_i B_j^T          (unscaled, per layer)
//
// What bounds it on an H100: at the llama3-8b LM head (K=4096, M=64,
// N=128256, m=2) the m*K*N bytes of B planes (1.05 GB) and the 98.5 MB of
// int32 partials make it memory-bound (0.343 ms at 3.35 TB/s); at a square
// 4096^3 its 2 m^2 M N K int8 operations make it compute-bound (0.278 ms
// at 1979 TOP/s).  What the design does about it:
// - One CTA owns a tile of the output for all L layers and walks K.  At
//   each 128-byte K slice a ring stage holds the m A-plane tiles and the m
//   B-plane tiles, and every staged byte feeds all m^2 plane products.
// - TMA fills the ring (3-D maps: K, rows, plane; 128-byte swizzle), every
//   stage in flight from the start: thread 0 refills a stage with the
//   slice kStages on as soon as every warp has released it through its
//   "empty" mbarrier.  TMA's zero fill covers ragged M and N and the K
//   tail, so the wrappers pad K only to 16 bytes.
// - Two warpgroups, each with a 64 x BN tile of int32 accumulators for
//   every layer (L * BN / 2 registers a thread: 192 at m=2 with BN=128,
//   160 at m=3 with BN=64), both middle-layer products into one
//   accumulator.  For M <= 64 (the LM head) the two sit side by side in N
//   (a 64 x 2BN CTA tile), so A's planes cross L2 once per 256 columns
//   instead of once per 64; otherwise one above the other (a 128 x BN
//   tile, half the L2 traffic of a 64 x 64 tile at the square shape).
// - No producer warp: a ninth warp puts three on one of the SM's four
//   register files, which caps every thread at 168 registers, below the
//   accumulators; with setmaxnreg (producer 40, consumers 232) ptxas
//   still spilled and serialized every wgmma (C7512).  With 256 threads a
//   thread may hold 255.  Each warpgroup waits for its products on a slice
//   before it releases the stage: waiting one slice later, with thread 0's
//   refill then on a divergent path, made ptxas serialize every wgmma
//   (C7518), and it was slower at every shape tried.
// - Epilogue: each warpgroup stages one layer at a time in shared memory
//   (the ring, free by then) and writes whole rows with coalesced,
//   masked stores.
// One CTA per SM: the ring takes most of shared memory.  A persistent
// grid (one tile's epilogue over the next one's loads) and TMA multicast
// across a cluster (A or B shared by neighbouring CTAs) are later work.
//
// Numerics: int32 accumulation wraps like the TPU's int32 MXU output; the
// partials are exact while J(l) * K * (2^d - 1)^2 < 2^31.
//
// Layout: a (m, M, K), b (m, N, K) int8, packed, 16-byte aligned, K a
// multiple of 16; out (2m-1, M, N) int32, packed.
//
// Plain C interface (bound with ctypes).  The entry returns 0, a
// cudaError_t from the launch, kErrNoEncoder if the CUDA driver has no
// cuTensorMapEncodeTiled, or kErrTensorMap + CUresult if a tensor map was
// refused.

#include "hopper_wgmma.cuh"

namespace {

constexpr int kBK = 128;                 // K bytes of a ring stage
constexpr int kConsumers = 2;            // warpgroups, one output tile each
constexpr int kThreads = 128 * kConsumers;
constexpr int kMaxStages = 6;
constexpr uint32_t kSmemLimit = 232448;  // dynamic shared memory of a block

// MP planes; WM x WN warpgroups (1 x 2 or 2 x 1), each with a 64 x BN
// output tile.
template <int MP, int WM, int WN, int BN>
struct Config {
  static_assert(WM * WN == kConsumers, "one tile per warpgroup");
  static constexpr int kL = 2 * MP - 1;
  static constexpr int kBlockM = 64 * WM;
  static constexpr int kBlockN = BN * WN;
  static constexpr uint32_t kATile = kBlockM * kBK;    // one plane's rows
  static constexpr uint32_t kBTile = kBlockN * kBK;
  static constexpr uint32_t kStage = MP * (kATile + kBTile);
  static constexpr int kStages =
      (kSmemLimit - 1024 - 16 * kMaxStages) / kStage < kMaxStages
          ? (kSmemLimit - 1024 - 16 * kMaxStages) / kStage
          : kMaxStages;
  static constexpr uint32_t kBars = kStages * kStage;
  static constexpr uint32_t kSmem = kBars + 16 * kStages + 1024;
  // epilogue staging: a 64 x BN int32 layer a warpgroup, rows padded by 8
  // words (conflict-free 8-byte fragment stores)
  static constexpr int kLd = BN + 8;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kConsumers * 64 * kLd * 4 <= kBars,
                "the epilogue staging fits in the ring");
};

template <int MP, int WM, int WN, int BN>
__global__ void __launch_bounds__(kThreads, 1)
layered_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb,
                            int32_t* __restrict__ out, int M, int N, int K) {
  using C = Config<MP, WM, WN, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  auto full = [&](int s) { return base + C::kBars + 8 * s; };
  auto empty = [&](int s) { return base + C::kBars + 8 * (C::kStages + s); };

  const int m0 = blockIdx.y * C::kBlockM;
  const int n0 = blockIdx.x * C::kBlockN;
  const int nk = (K + kBK - 1) / kBK;
  // the warpgroup, uniform as far as ptxas can tell
  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int wm = c / WN, wn = c % WN;    // its tile within the CTA's
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kThreads / 32);   // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 loads K slice kt into stage kt % kStages: the m A-plane and
  // the m B-plane tiles
  auto produce = [&](int kt) {
    const int s = kt % C::kStages;
    const uint32_t st = base + s * C::kStage;
    mbar_expect_tx(full(s), C::kStage);
#pragma unroll
    for (int p = 0; p < MP; ++p) {
      tma_load3(st + p * C::kATile, &ta, full(s), kt * kBK, m0, p);
      tma_load3(st + MP * C::kATile + p * C::kBTile, &tb, full(s), kt * kBK,
                n0, p);
    }
  };
  if (threadIdx.x == 0)
    for (int kt = 0; kt < C::kStages && kt < nk; ++kt) produce(kt);

  int acc[C::kL][BN / 2];
#pragma unroll
  for (int l = 0; l < C::kL; ++l)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[l][e] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % C::kStages;
    mbar_wait(full(s), (kt / C::kStages) & 1);
    __syncwarp();
    const uint32_t a_st = base + s * C::kStage + wm * 64 * kBK;
    const uint32_t b_st = base + s * C::kStage + MP * C::kATile
                          + wn * BN * kBK;
#pragma unroll
    for (int l = 0; l < C::kL; ++l) fence_regs(acc[l]);
    wgmma_fence();
    // four k32 steps of the 128-byte slice, all m^2 plane pairs each,
    // pair (i, j) into layer 2m-2-(i+j)
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < MP; ++j)
          wgmma_s8(acc[2 * MP - 2 - i - j],
                   sw128_desc(a_st + i * C::kATile + kk * 32, 16, 1024),
                   sw128_desc(b_st + j * C::kBTile + kk * 32, 16, 1024));
    wgmma_commit();
#pragma unroll
    for (int l = 0; l < C::kL; ++l) fence_regs(acc[l]);
    // this slice is done with: release its stage, and thread 0 refills it
    // with the slice kStages on once every warp has released it
    wgmma_wait<0>();
#pragma unroll
    for (int l = 0; l < C::kL; ++l) fence_regs(acc[l]);
    if (lane == 0) mbar_arrive(empty(s));
    if (threadIdx.x == 0 && kt + C::kStages < nk) {
      mbar_wait(empty(s), (kt / C::kStages) & 1);
      produce(kt + C::kStages);
    }
    __syncwarp();
  }

  // epilogue: the ring is free once both warpgroups' last wgmma retired
  __syncthreads();
  int* tile = reinterpret_cast<int*>(gbase) + c * 64 * C::kLd;
  const int r0 = warp * 16 + lane / 4, q = lane % 4;
  const int row0 = m0 + wm * 64, col0 = n0 + wn * BN;
#pragma unroll
  for (int l = 0; l < C::kL; ++l) {
    // accumulator element 4i + 2h (+1): row r0 + 8h, column 8i + 2q (+1)
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(tile + (r0 + 8 * h) * C::kLd + 8 * i
                                 + 2 * q) =
            make_int2(acc[l][4 * i + 2 * h], acc[l][4 * i + 2 * h + 1]);
    __syncthreads();
    int32_t* o = out + (size_t)l * M * N;
    for (int r = warp; r < 64 && row0 + r < M; r += 4) {
      int32_t* orow = o + (size_t)(row0 + r) * N;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const int col = col0 + 32 * j + lane;
        if (col < N) orow[col] = tile[r * C::kLd + 32 * j + lane];
      }
    }
    __syncthreads();
  }
}

template <int MP, int WM, int WN, int BN>
int launch(const void* a, const void* b, int32_t* out, int M, int N, int K,
           cudaStream_t stream) {
  using C = Config<MP, WM, WN, BN>;
  if ((M + C::kBlockM - 1) / C::kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap ta, tb;
  CUresult r = make_map_s8(encode, &ta, a, MP, M, K, C::kBlockM);
  if (r == CUDA_SUCCESS)
    r = make_map_s8(encode, &tb, b, MP, N, K, C::kBlockN);
  if (r != CUDA_SUCCESS) return kErrTensorMap + (int)r;
  auto kernel = layered_matmul_wgmma_kernel<MP, WM, WN, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + C::kBlockN - 1) / C::kBlockN,
            (M + C::kBlockM - 1) / C::kBlockM);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(ta, tb, out, M, N, K);
  return (int)cudaGetLastError();
}

// M <= 64 (one row tile, the LM head): the consumers side by side in N;
// otherwise one above the other.
template <int MP, int BN>
int launch_for(const void* a, const void* b, int32_t* out, int M, int N,
               int K, cudaStream_t stream) {
  return M <= 64 ? launch<MP, 1, 2, BN>(a, b, out, M, N, K, stream)
                 : launch<MP, 2, 1, BN>(a, b, out, M, N, K, stream);
}

}  // namespace

// a: (m, M, K) int8, b: (m, N, K) int8, out: (2m-1, M, N) int32; all
// contiguous on the current device, K % 16 == 0 and a, b 16-byte aligned.
// Returns 0, a cudaError_t, or a tensor-map error (see the top).
extern "C" int layered_matmul_wgmma_s8(const void* a, const void* b,
                                       void* out, int m, int M, int N, int K,
                                       void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      (uintptr_t)a % 16 != 0 || (uintptr_t)b % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int32_t* po = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch_for<1, 128>(a, b, po, M, N, K, s);
    case 2: return launch_for<2, 128>(a, b, po, M, N, K, s);
    case 3: return launch_for<3, 64>(a, b, po, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
