// Layered-resolution int8 digit-plane matmul on Hopper's tensor cores
// (sm_90a) for four planes and more: int8 wgmma fed by TMA through a
// multistage mbarrier ring, the L = 2m-1 layers split into groups.
//
// Replaces the TPU kernel `layered_matmul_kernel_call`
// (src/repro/kernels/layered_matmul.py:71, body `_kernel` :39) for m >= 4,
// where the kernel beside it (layered_matmul_wgmma.cu, m <= 3) runs out of
// registers.  Same function: from int8 digit planes A_i (M x K) and B_j (N x K), both
// K-contiguous, it writes the L exact int32 anti-diagonal partials
//
//     out[l] = sum_{i+j = 2m-2-l} A_i B_j^T          (unscaled, per layer)
//
// What bounds it on an H100: at a square 4096^3 its 2 m^2 M N K int8
// operations (1.111 ms at m = 4, 1.736 at m = 5, 4.445 at m = 8, at
// 1979 TOP/s); at the llama3-8b LM head (K = 4096, M = 64, N = 128256) the
// m K N bytes of B planes and the L M N int32 partials (0.696 ms at m = 4,
// 3.35 TB/s), with the operations (0.544 ms) close behind.  What the design
// does about it:
// - Registers.  A consumer warpgroup keeps a 64 x 128 tile of int32
//   accumulators for each of its layers, 64 registers a thread a layer;
//   every layer at once would need 64 (2m-1) (448 at m = 4).  So a
//   consumer holds one GROUP of at most kG = 3 contiguous layers (192
//   registers) and runs only its layers' plane pairs
//   (`layering.layer_minijobs`).  The groups are made on the host
//   (`layered_matmul.group_plan`) and passed by value: each group's first
//   and last layer and the A- and B-plane ranges its pairs read.  A plan
//   takes the fewest CTAs that hold the layers and, among those, the split
//   whose largest CTA runs the fewest pairs: the pairs per layer are
//   J(l) = min(l+1, 2m-1-l), so CTAs are balanced by pairs, not by
//   layers.  Fewer CTAs a tile mean fewer re-reads of a plane (every CTA
//   reads the planes of its pairs); the imbalance left costs only the last
//   wave, since the CTAs of one tile run side by side.  64-wide tiles (five
//   layers) and 32-wide ones (seven) were slower at every shape measured:
//   a 64 x 64 x 32 wgmma reads 4 KB of shared memory for 32 cycles of
//   work, the SM's whole shared-memory rate.
// - Warp specialisation.  A CTA is three warpgroups: one thread of the
//   first issues every TMA load (setmaxnreg lowers the warpgroup to 40
//   registers), the other two consume (232 registers each).  With thread
//   0 of a consumer refilling the ring inside the loop that issues the
//   wgmma, as the m <= 3 kernel does, ptxas serialized every wgmma
//   (C7520): the pair counts that guard this kernel's wgmma vary from one
//   ring item to the next, and a branch that only some threads take, in
//   that loop, made them divergent in its eyes.  Waits give up instead of
//   trapping (a trap defeats setmaxnreg); a give-up sets a device word.
// - Two CTA layouts (`layout`, chosen by `layered_matmul.grouped_layout`
//   from measurements).  Stacked: both consumers on the CTA's group, one
//   above the other (a 128 x 128 tile).  Layer-split: both on one 64 x 128
//   tile, each with its own group, so a CTA holds six layers: at the head
//   (m = 4) two CTAs a tile against three with the consumers side by side
//   in N (64 x 256, measured 1.68 ms against 1.30, and not kept), and B's
//   planes, the bytes that bound it, cross L2 fewer times.
// - Shared memory.  A ring stage holds, for one 64-byte K slice, the A-
//   and B-plane tiles of one BLOCK of the CTA's pairs: at most kChunk
//   planes of each operand (4 for a 128 x 128 tile, 6 for 64 x 128), so
//   that three stages always fit the 227 KB.  A CTA whose plane
//   range is wider (past m = 4 or 6) walks its pair space block by block
//   within each slice, skipping blocks none of whose pairs is its own.
//   64-byte K slices with the 64-byte swizzle, against the m <= 3 kernel's
//   128-byte ones, halve a stage.
// - Compute.  Every staged plane tile feeds all of its block's pairs
//   before the stage is released, as in the m <= 3 kernel, and each
//   consumer waits for its products on a stage before it releases it.  The
//   extra reads of a plane by the other CTAs of its tile come mostly from
//   L2 (the CTAs of a tile are neighbours in the launch order, and tiles
//   run in bands of eight row tiles); from HBM they would cost about 0.05
//   ms at m = 5, 4096^3, under 3 % of the bound.
// - Epilogue: each consumer stages one layer at a time in shared memory
//   (the ring, free by then) and writes whole rows with coalesced, masked
//   stores; it is not overlapped with the next tile's loads (later work:
//   a persistent grid).  ptxas still injects a warpgroup arrive before
//   many of the guarded wgmma (its note C7519), which costs some overlap.
//
// Numerics: int32 accumulation wraps like the TPU's int32 MXU output; the
// partials are exact while J(l) * K * (2^d - 1)^2 < 2^31.  TMA's zero fill
// covers ragged M and N and the K tail, so the wrappers pad K only to 16
// bytes.
//
// Layout: a (m, M, K), b (m, N, K) int8, packed, 16-byte aligned, K a
// multiple of 16; out (2m-1, M, N) int32, packed.
//
// Plain C interface (bound with ctypes).  The entry returns 0, a
// cudaError_t from the launch (cudaErrorInvalidValue for a plan or shape
// it does not take), kErrNoEncoder if the CUDA driver has no
// cuTensorMapEncodeTiled, or kErrTensorMap + CUresult if a tensor map was
// refused.  layered_matmul_wgmma_grouped_faults reads (and clears) the
// give-up word.

#include "hopper_wgmma.cuh"

namespace {

constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);   // and a producer
constexpr int kBK = 64;                  // K bytes of a ring stage
constexpr int kBN = 128;                 // columns of a consumer's tile
constexpr int kG = 3;                    // layers a consumer holds at most
constexpr int kMaxStages = 6;
constexpr int kMaxGroups = 128;          // entries of a plan
constexpr uint32_t kSmemLimit = 232448;  // dynamic shared memory of a block
// 40 x 128 + 232 x 256 = 64,512 registers: the 168 a thread of a
// 384-thread CTA starts with, moved from the producer to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__host__ __device__ constexpr int imin(int x, int y) { return x < y ? x : y; }
__host__ __device__ constexpr int imax(int x, int y) { return x > y ? x : y; }

// Set (never cleared by a launch) when a wait_phase gave up; read and
// cleared by layered_matmul_wgmma_grouped_faults.
__device__ unsigned int g_wait_gave_up = 0;

// Wait until the phase of `bar` with this parity has completed.  Unlike
// the header's mbar_wait, a wait that outlasts any load by orders of
// magnitude gives up instead of trapping: a trap anywhere in the kernel
// makes ptxas allocate the consumers' registers as if `setmaxnreg` had not
// raised them.  A give-up is recorded in g_wait_gave_up, so that a fault in
// the ring ends in an error the wrapper raises
// (kernels/layered_matmul.py, `check_faults`), never in a hang.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; tries < (1u << 26); ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
  }
  atomicOr(&g_wait_gave_up, 1u);
}

// The consumers' named barrier (id 1, their 256 threads): the producer
// warpgroup takes no part in the epilogue.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
}

struct Group {
  int16_t l0, l1;   // first and last layer
  int16_t a0, a1;   // A planes its pairs read
  int16_t b0, b1;   // B planes its pairs read
};
struct Plan {
  int n;
  Group g[kMaxGroups];
};

// The groups a CTA runs: one for both consumers (stacked), or one each (layer-split: plan rows 2k and 2k + 1, the second empty,
// l0 = l1 + 1, where the CTA has one layer).
__host__ __device__ inline int per_cta(bool split) { return split ? 2 : 1; }

// The layers and planes of the groups CTA group k runs, together.
__host__ __device__ inline Group cta_union(const Plan& plan, int k,
                                           bool split) {
  Group u = plan.g[per_cta(split) * k];
  if (split && 2 * k + 1 < plan.n) {
    const Group& v = plan.g[2 * k + 1];
    u = Group{(int16_t)imin(u.l0, v.l0), (int16_t)imax(u.l1, v.l1),
              (int16_t)imin(u.a0, v.a0), (int16_t)imax(u.a1, v.a1),
              (int16_t)imin(u.b0, v.b0), (int16_t)imax(u.b1, v.b1)};
  }
  return u;
}

// The consumer warpgroups on a CTA tile of 64 WM x kBN: WM = 2 (stacked,
// one above the other) or 1 (layer-split: both on one tile); each holds at
// most kG layers of a 64 x kBN tile.
template <int WM>
struct Config {
  static constexpr bool kSplit = WM == 1;
  static_assert(kSplit || WM == kConsumers, "one tile per consumer");
  static constexpr int kBlockM = 64 * WM;
  static constexpr int kBlockN = kBN;
  static constexpr uint32_t kATile = kBlockM * kBK;   // one plane's rows
  static constexpr uint32_t kBTile = kBlockN * kBK;
  static constexpr uint32_t kPlaneBytes = kATile + kBTile;
  // planes of each operand a stage holds: three stages always fit
  static constexpr int kChunk =
      (kSmemLimit - 1024 - 16 * kMaxStages) / 3 / kPlaneBytes;
  // epilogue staging: a 64 x kBN int32 layer a consumer, rows padded by 8
  // words (conflict-free 8-byte fragment stores)
  static constexpr int kLd = kBN + 8;
  static constexpr uint32_t kStaging = kConsumers * 64 * kLd * 4;
  static_assert(kChunk >= 1, "a plane of each operand fits a stage");
};

// Every ring item of a CTA whose pairs are those of `g`: K slice kt, then
// the blocks of its pairs, A planes [ca, ca + na) and B planes [cb, cb +
// nb), `chunk` planes of each at most, skipping blocks none of whose pairs
// (i + j in [2m-2-l1, 2m-2-l0]) is the CTA's.  The producer and the
// consumers walk the same items in the same order.
template <typename F>
__device__ __forceinline__ void for_each_item(const Group& g, int m,
                                              int chunk, int nk, F&& f) {
  const int s_lo = 2 * m - 2 - g.l1, s_hi = 2 * m - 2 - g.l0;
  int it = 0;
  for (int kt = 0; kt < nk; ++kt)
    for (int ca = g.a0; ca <= g.a1; ca += chunk) {
      const int na = imin(chunk, g.a1 + 1 - ca);
      for (int cb = g.b0; cb <= g.b1; cb += chunk) {
        const int nb = imin(chunk, g.b1 + 1 - cb);
        if (ca + cb > s_hi || ca + na - 1 + cb + nb - 1 < s_lo) continue;
        f(it++, kt, ca, na, cb, nb);
      }
    }
}

template <int WM>
__global__ void __launch_bounds__(kThreads, 1)
layered_matmul_wgmma_grouped_kernel(const __grid_constant__ CUtensorMap ta,
                                    const __grid_constant__ CUtensorMap tb,
                                    const __grid_constant__ Plan plan,
                                    int32_t* __restrict__ out, int m, int M,
                                    int N, int K, int chunk, int stages,
                                    uint32_t ring) {
  using C = Config<WM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t stage_bytes = chunk * C::kPlaneBytes;
  auto full = [&](int s) { return base + ring + 8 * s; };
  auto empty = [&](int s) { return base + ring + 8 * (stages + s); };

  // the launch order: the CTA groups of one tile side by side, then tiles
  // in bands of eight row tiles (a wave's planes stay in L2)
  const int ng = (plan.n + per_cta(C::kSplit) - 1) / per_cta(C::kSplit);
  const int gi = blockIdx.x % ng;
  const int tile = blockIdx.x / ng;
  const int tiles_m = (M + C::kBlockM - 1) / C::kBlockM;
  const int tiles_n = (N + C::kBlockN - 1) / C::kBlockN;
  const int band = tile / (8 * tiles_n);
  const int rows = imin(8, tiles_m - 8 * band);
  const int in_band = tile % (8 * tiles_n);
  const int m0 = (8 * band + in_band % rows) * C::kBlockM;
  const int n0 = (in_band / rows) * C::kBlockN;
  const Group cta = cta_union(plan, gi, C::kSplit);
  const int nk = (K + kBK - 1) / kBK;
  // the warpgroup, uniform as far as ptxas can tell: 0 produces, 1 and 2
  // consume
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every load ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (t == 0)
      for_each_item(cta, m, chunk, nk,
                    [&](int it, int kt, int ca, int na, int cb, int nb) {
        // item it goes to stage it % stages once the item `stages` before
        // it has been released by every consumer warp
        const int s = it % stages;
        if (it >= stages) wait_phase(empty(s), (it / stages - 1) & 1);
        const uint32_t st = base + s * stage_bytes;
        mbar_expect_tx(full(s), na * C::kATile + nb * C::kBTile);
        for (int p = 0; p < na; ++p)
          tma_load3(st + p * C::kATile, &ta, full(s), kt * kBK, m0, ca + p);
        for (int p = 0; p < nb; ++p)
          tma_load3(st + chunk * C::kATile + p * C::kBTile, &tb, full(s),
                    kt * kBK, n0, cb + p);
      });
    return;
  }

  // ---------------- consumers ---------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int c = wg - 1;
  const int wm = C::kSplit ? 0 : c;        // its rows within the CTA's
  const int warp = t / 32, lane = t % 32;
  // this consumer's layers: the CTA's group, or (layer-split) its own row
  // of the plan, which may be empty
  const Group own = plan.g[C::kSplit ? 2 * gi + c : gi];
  const int nl = own.l1 - own.l0 + 1;          // 0 .. kG
  const int s_hi = 2 * m - 2 - own.l0;         // pair sum of acc[0]
  int acc[kG][kBN / 2];
#pragma unroll
  for (int q = 0; q < kG; ++q)
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) acc[q][e] = 0;

  for_each_item(cta, m, chunk, nk,
                [&](int it, int kt, int ca, int na, int cb, int nb) {
    const int s = it % stages;
    wait_phase(full(s), (it / stages) & 1);
    __syncwarp();
    const uint32_t a_st = base + s * stage_bytes + wm * 64 * kBK;
    const uint32_t b_st = base + s * stage_bytes + chunk * C::kATile;
#pragma unroll
    for (int q = 0; q < kG; ++q) fence_regs(acc[q]);
    wgmma_fence();
    // the k32 steps of the slice; at each, every pair (i, j) of the block
    // whose layer is this consumer's, into acc[l - l0].  The pair loop is
    // unrolled to the most pairs a layer has in a block.
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        if (q < nl) {
          const int sum = s_hi - q;
          const int i_lo = imax(ca, sum - (cb + nb - 1));
          const int pairs = imin(ca + na - 1, sum - cb) + 1 - i_lo;
#pragma unroll
          for (int u = 0; u < C::kChunk; ++u)
            if (u < pairs)
              wgmma_s8(acc[q],
                       swizzled_desc(a_st + (i_lo + u - ca) * C::kATile
                                     + kk * 32, kBK),
                       swizzled_desc(b_st + (sum - i_lo - u - cb)
                                     * C::kBTile + kk * 32, kBK));
        }
      }
    wgmma_commit();
#pragma unroll
    for (int q = 0; q < kG; ++q) fence_regs(acc[q]);
    // this stage is done with: every warp releases it to the producer
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < kG; ++q) fence_regs(acc[q]);
    if (lane == 0) mbar_arrive(empty(s));
    __syncwarp();
  });

  // epilogue: the ring is free once both consumers' last wgmma retired
  // (every load was waited for)
  consumers_sync();
  int* stile = reinterpret_cast<int*>(gbase) + c * 64 * C::kLd;
  const int r0 = warp * 16 + lane / 4, qd = lane % 4;
  const int row0 = m0 + wm * 64, col0 = n0;
  // the same number of rounds for both consumers: each round ends in the
  // consumers' barrier
  const int rounds = C::kSplit ? kG : nl;
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    if (q < rounds) {
      // accumulator element 4i + 2h (+1): row r0 + 8h, column 8i + 2qd (+1)
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(stile + (r0 + 8 * h) * C::kLd + 8 * i
                                   + 2 * qd) =
              make_int2(acc[q][4 * i + 2 * h], acc[q][4 * i + 2 * h + 1]);
      consumers_sync();
      if (q < nl) {
        int32_t* o = out + (size_t)(own.l0 + q) * M * N;
        for (int r = warp; r < 64 && row0 + r < M; r += 4) {
          int32_t* orow = o + (size_t)(row0 + r) * N;
#pragma unroll
          for (int j = 0; j < kBN / 32; ++j) {
            const int col = col0 + 32 * j + lane;
            if (col < N) orow[col] = stile[r * C::kLd + 32 * j + lane];
          }
        }
      }
      consumers_sync();
    }
  }
}

template <int WM>
int launch(const void* a, const void* b, int32_t* out, int m, int M, int N,
           int K, const Plan& plan, cudaStream_t stream) {
  using C = Config<WM>;
  // every group within the consumers' layers and the planes; a
  // layer-split CTA's second group may be empty (l1 = l0 - 1)
  if (C::kSplit && plan.n % 2 != 0) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < plan.n; ++g) {
    const Group& x = plan.g[g];
    if (x.l0 < 0 || x.l1 < x.l0 - (C::kSplit && g % 2 == 1 ? 1 : 0) ||
        x.l1 >= 2 * m - 1 || x.l1 - x.l0 >= kG ||
        x.a0 < 0 || x.a1 < x.a0 || x.a1 >= m || x.b0 < 0 || x.b1 < x.b0 ||
        x.b1 >= m)
      return (int)cudaErrorInvalidValue;
  }
  // the widest plane range of a CTA sets a stage
  const int ng = (plan.n + per_cta(C::kSplit) - 1) / per_cta(C::kSplit);
  int widest = 1;
  for (int k = 0; k < ng; ++k) {
    const Group u = cta_union(plan, k, C::kSplit);
    widest = imax(widest, imax(u.a1 - u.a0, u.b1 - u.b0) + 1);
  }
  const int chunk = imin(C::kChunk, widest);
  const uint32_t stage_bytes = chunk * C::kPlaneBytes;
  const int stages = imin(
      kMaxStages, (int)((kSmemLimit - 1024 - 16 * kMaxStages) / stage_bytes));
  const uint32_t ring = stages * stage_bytes > C::kStaging
                            ? stages * stage_bytes : C::kStaging;
  const uint32_t smem = 1024 + ring + 16 * kMaxStages;
  const long long tiles = (long long)((M + C::kBlockM - 1) / C::kBlockM)
                          * ((N + C::kBlockN - 1) / C::kBlockN);
  if (tiles * ng > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap ta, tb;
  CUresult r = make_map_s8(encode, &ta, a, m, M, K, C::kBlockM, kBK);
  if (r == CUDA_SUCCESS)
    r = make_map_s8(encode, &tb, b, m, N, K, C::kBlockN, kBK);
  if (r != CUDA_SUCCESS) return kErrTensorMap + (int)r;
  auto kernel = layered_matmul_wgmma_grouped_kernel<WM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(tiles * ng), kThreads, smem, stream>>>(
      ta, tb, plan, out, m, M, N, K, chunk, stages, ring);
  return (int)cudaGetLastError();
}



}  // namespace

// a: (m, M, K) int8, b: (m, N, K) int8, out: (2m-1, M, N) int32; all
// contiguous on the current device, K % 16 == 0 and a, b 16-byte aligned.
// plan: n_groups rows of six int32 (first layer, last layer, first and
// last A plane, first and last B plane) whose groups cover every layer
// once, at most kG layers each; layout 0: the consumers one above the
// other, on one group a CTA; layout 1: layer-split (both on one 64 x kBN
// tile, plan rows 2k and 2k + 1 in CTA k).  Returns 0, a cudaError_t, or a tensor-map error (see
// the top).
extern "C" int layered_matmul_wgmma_grouped_s8(const void* a, const void* b,
                                               void* out, int m, int M,
                                               int N, int K,
                                               const int32_t* plan_rows,
                                               int n_groups, int layout,
                                               void* stream) {
  if (m < 1 || m > 16384 || M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      (uintptr_t)a % 16 != 0 || (uintptr_t)b % 16 != 0 || n_groups < 1 ||
      n_groups > kMaxGroups || (layout != 0 && layout != 1))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.n = n_groups;
  for (int g = 0; g < kMaxGroups; ++g) {
    const int32_t* r = plan_rows + 6 * (g < n_groups ? g : 0);
    plan.g[g] = Group{(int16_t)r[0], (int16_t)r[1], (int16_t)r[2],
                      (int16_t)r[3], (int16_t)r[4], (int16_t)r[5]};
  }
  int32_t* po = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layout == 1 ? launch<1>(a, b, po, m, M, N, K, plan, s)
                     : launch<2>(a, b, po, m, M, N, K, plan, s);
}

// The give-up word of every launch since the last read, into *word; with
// `clear`, reset to 0.  Synchronous: the copy from the symbol waits for the
// launches queued before it on the legacy default stream.
extern "C" int layered_matmul_wgmma_grouped_faults(unsigned int* word,
                                                   int clear) {
  cudaError_t err =
      cudaMemcpyFromSymbol(word, g_wait_gave_up, sizeof(unsigned int));
  if (err == cudaSuccess && clear && *word != 0) {
    const unsigned int zero = 0;
    err = cudaMemcpyToSymbol(g_wait_gave_up, &zero, sizeof(unsigned int));
  }
  return (int)err;
}
