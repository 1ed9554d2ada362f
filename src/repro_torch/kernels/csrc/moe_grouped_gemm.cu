// Products grouped by expert over row counts that only the device holds:
// the dropless expert layer's two SwiGLU products (models/moe.py,
// dropless_moe), on the tensor cores (`mma.sync` m16n8k16, bf16 operands,
// fp32 accumulators).
//
// Replaces no TPU kernel.  The reference's experts are the GShard einsums
// over capacity buffers (src/repro/models/moe.py), which have a dense form;
// the port's dropless layer has none that fits.  Its (token, pick) rows are
// sorted by expert on the device, and each expert's count changes every
// decode step and is never read on the host (a CUDA graph replays the
// step), so a padded `bmm` over the held experts would pad every one to
// every pair of the step: 36 x 320 rows where 320 are real at
// granite-4.0-h-small's decode.  This kernel reads the counts where they
// are.
//
//   out[r] = a[r] W_e               (gated: silu(a[r] W_e) * (a[r] U_e))
//
// for every row r of expert e, offsets[e] <= r < offsets[e + 1] (int32 on
// the device, offsets[E] <= M), W, U stacked (E, K, N), N contiguous; fp32
// sums, the activation in fp32, bf16 out.  Rows offsets[E] .. M - 1 (the
// pairs of experts not held) are written as zeros.
//
// What bounds it on an H100.  In a decode step (batch 32, top 10 of 72,
// 36 held) each touched expert gets about 4.4 rows, so a product reads
// the touched experts' weights once (two 4096 x 768 bf16 matrices an
// expert for gate and up, one 768 x 4096 for down: 680 MB a layer when all
// 36 are touched) for about 2 flops a weight byte: device memory bounds
// it, 0.2 ms a layer at 3.35 TB/s.  In a prefill an expert gets thousands
// of rows and the flops bound it (0.13 TFLOP a layer for 16384 tokens).
//
// What the design does about it.  A fixed grid that a graph can capture:
// blockIdx.y a 64-column tile of N, blockIdx.x a slot of the row tiles
// laid end to end over the experts (an expert of m rows takes ceil(m / BM)
// slots).  ceil(M / BM) + E slots always cover them; warp 0 finds its
// slot's expert by a scan over the counts in shared memory, slots past the
// last tile zero the rows past offsets[E], and an expert with no rows
// takes no slot and reads none of its weights.  Two tile shapes, by the
// rows an expert gets on average: 16 rows (4 warps, each 16 x 16 of the
// output) where each expert gets few, so each weight tile is read once
// with one row tile; 128 rows (8 warps, each 32 x 32) where they get many,
// so a weight tile serves 128 rows.  Operands go through a ring of
// `cp.async` stages (4 small, 3 large) of 64 K-steps into padded shared
// memory (row stride 72 bf16: `ldmatrix` without bank conflicts), B read
// with `ldmatrix.trans` from its [k][n] layout; the gate and up products
// of a tile share its A fragments.  A tile's rows past its expert's end
// are loaded as copies of its last row and never stored.
//
// Nothing is allocated here and nothing waits on the host: the wrapper
// (kernels/moe_grouped_gemm.py) gives the output, the launch goes to its
// stream, and the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 64;            // output columns a tile
constexpr int kBK = 64;            // contraction a stage
constexpr int kLd = 72;            // shared row stride (bf16): 64 + 8
constexpr int kMaxExperts = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + __expf(-x));
}

struct Params {
  const bf16* a;          // (M, K)
  const bf16* w;          // (E, K, N)
  const bf16* u;          // (E, K, N), gated only
  const int* offsets;     // (E + 1,)
  bf16* out;              // (M, N)
  int M, K, N, E;
};

// BM rows a tile over WM x WN warps; STAGES deep; GATED: two products
template <int BM, int WM, int WN, int STAGES, bool GATED>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWTM = BM / WM;          // a warp's rows
  static constexpr int kWTN = kBN / WN;         // a warp's columns
  static constexpr int kMT = kWTM / 16;
  static constexpr int kNT = kWTN / 8;
  static constexpr int kMats = GATED ? 2 : 1;
  static constexpr int kAElems = BM * kLd;
  static constexpr int kBElems = kBK * kLd;
  static constexpr int kStage = kAElems + kMats * kBElems;
  static constexpr int kSmemBytes = STAGES * kStage * 2;
  static_assert(kWTM % 16 == 0 && kWTN % 16 == 0, "warp tile");
};

template <int BM, int WM, int WN, int STAGES, bool GATED>
__global__ void __launch_bounds__(Tile<BM, WM, WN, STAGES, GATED>::kThreads)
moe_grouped_gemm_kernel(Params p) {
  using T = Tile<BM, WM, WN, STAGES, GATED>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int s_expert, s_tile, s_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int E = p.E;
  for (int i = tid; i <= E; i += T::kThreads) s_off[i] = p.offsets[i];
  __syncthreads();

  // warp 0: the expert and row tile of this slot, by a scan of the tiles
  // an expert takes
  if (warp == 0) {
    if (lane == 0) s_expert = -1;
    __syncwarp();
    int base = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int t = e < E ? (s_off[e + 1] - s_off[e] + BM - 1) / BM : 0;
      int inc = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      const int first = base + inc - t;
      if (t > 0 && slot >= first && slot < first + t) {
        s_expert = e;
        s_tile = slot - first;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) s_total = base;
  }
  __syncthreads();

  const int e = s_expert;
  if (e < 0) {
    // past the last tile: zero a tile of the rows of no held expert
    const int r0 = s_off[E] + (slot - s_total) * BM;
    const int r1 = min(r0 + BM, p.M);
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int idx = tid; idx < (r1 - r0) * (kBN / 2); idx += T::kThreads) {
      const int r = r0 + idx / (kBN / 2), c = n0 + 2 * (idx % (kBN / 2));
      *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)r * p.N + c) =
          zero;
    }
    return;
  }
  const int row0 = s_off[e] + s_tile * BM;
  const int rows = min(BM, s_off[e + 1] - row0);
  const int K = p.K, N = p.N;
  const bf16* a = p.a + (long long)row0 * K;
  const bf16* w = p.w + (long long)e * K * N + n0;
  const bf16* u = GATED ? p.u + (long long)e * K * N + n0 : nullptr;

  auto load_stage = [&](int stage, int kt) {
    bf16* sa = smem + stage * T::kStage;
    bf16* sb = sa + T::kAElems;
    const int k0 = kt * kBK;
    for (int idx = tid; idx < BM * (kBK / 8); idx += T::kThreads) {
      const int r = idx / (kBK / 8), c = idx % (kBK / 8);
      const int src = min(r, rows - 1);
      copy16(sa + r * kLd + 8 * c, a + (long long)src * K + k0 + 8 * c);
    }
    for (int idx = tid; idx < kBK * (kBN / 8); idx += T::kThreads) {
      const int r = idx / (kBN / 8), c = idx % (kBN / 8);
      const long long g = (long long)(k0 + r) * N + 8 * c;
      copy16(sb + r * kLd + 8 * c, w + g);
      if (GATED) copy16(sb + T::kBElems + r * kLd + 8 * c, u + g);
    }
  };

  float acc[T::kMT][T::kNT][4];
  float acc2[GATED ? T::kMT : 1][GATED ? T::kNT : 1][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0.f;
        if (GATED) acc2[GATED ? i : 0][GATED ? j : 0][q] = 0.f;
      }

  const int wm = warp / WN, wn = warp % WN;
  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    wait_pending<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    commit();
    const bf16* sa = smem + (kt % STAGES) * T::kStage;
    const bf16* sb = sa + T::kAElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[T::kMT][4];
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt)
        ldsm4(af[mt], sa + (wm * T::kWTM + mt * 16 + (lane & 15)) * kLd + kk
                          + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < T::kNT / 2; ++np) {
        const int col = wn * T::kWTN + 16 * np + 8 * (lane >> 4);
        const int krow = kk + (lane & 7) + 8 * ((lane >> 3) & 1);
        uint32_t bfr[4];
        ldsm4_t(bfr, sb + krow * kLd + col);
#pragma unroll
        for (int mt = 0; mt < T::kMT; ++mt) {
          mma(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
        if (GATED) {
          uint32_t ufr[4];
          ldsm4_t(ufr, sb + T::kBElems + krow * kLd + col);
#pragma unroll
          for (int mt = 0; mt < T::kMT; ++mt) {
            mma(acc2[GATED ? mt : 0][GATED ? 2 * np : 0], af[mt], ufr[0],
                ufr[1]);
            mma(acc2[GATED ? mt : 0][GATED ? 2 * np + 1 : 0], af[mt],
                ufr[2], ufr[3]);
          }
        }
      }
    }
  }
  wait_pending<0>();

  // the accumulators: c0, c1 at row lane / 4, columns 2 (lane % 4) + 0, 1;
  // c2, c3 eight rows below
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::kWTM + mt * 16 + g + 8 * h;
        if (r >= rows) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (GATED) {
          v0 = silu(v0) * acc2[GATED ? mt : 0][GATED ? nt : 0][2 * h];
          v1 = silu(v1) * acc2[GATED ? mt : 0][GATED ? nt : 0][2 * h + 1];
        }
        const int c = n0 + wn * T::kWTN + nt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)(row0 + r) * N
                                           + c) =
            __floats2bfloat162_rn(v0, v1);
      }
}

template <int BM, int WM, int WN, int STAGES, bool GATED>
int launch(const Params& p, cudaStream_t stream) {
  using T = Tile<BM, WM, WN, STAGES, GATED>;
  auto kernel = moe_grouped_gemm_kernel<BM, WM, WN, STAGES, GATED>;
  // always: the static offsets (4 KB) count against the 48 KB a block
  // gets without it, too
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.M + BM - 1) / BM + p.E, p.N / kBN);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, K), w and u (E, K, N) bf16, u null for the plain product; offsets
// (E + 1,) int32; out (M, N) bf16; block_m 16 or 128 (the tile's rows).
extern "C" int moe_grouped_gemm(const void* a, const void* w, const void* u,
                                const void* offsets, void* out, int M, int K,
                                int N, int E, int block_m, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % kBK != 0 || N % kBN != 0 ||
      E <= 0 || E > kMaxExperts || N / kBN > 65535 ||
      (block_m != 16 && block_m != 128))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const bf16*>(a), static_cast<const bf16*>(w),
           static_cast<const bf16*>(u), static_cast<const int*>(offsets),
           static_cast<bf16*>(out), M, K, N, E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gated = u != nullptr;
  if (block_m == 16)
    return gated ? launch<16, 1, 4, 4, true>(p, s)
                 : launch<16, 1, 4, 4, false>(p, s);
  return gated ? launch<128, 4, 2, 3, true>(p, s)
               : launch<128, 4, 2, 3, false>(p, s);
}
