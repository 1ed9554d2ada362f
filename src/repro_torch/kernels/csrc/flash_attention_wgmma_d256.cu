// Flash attention for bf16 at head dim 256 on Hopper's tensor cores
// (sm_90a): wgmma for both products, K and V staged by TMA through
// mbarrier rings that a producer warpgroup keeps full, and two consumer
// warpgroups sharing every K/V tile.
//
// Replaces the TPU kernel `flash_attention_kernel_call`
// (src/repro/kernels/flash_attention.py:85, body `_kernel` :31) for bf16
// q/k/v with head dim 256: recurrentgemma-9b's local attention (MQA, 16
// query heads on one kv head, window 2048).  Same function as that kernel
// and as the two kernels beside it (flash_attention_wgmma.cu, bf16 dh
// 64/128; flash_attention.cu, fp32 and the other head dims):
// softmax(q k^T * dh^-1/2 + mask) v per query row, with the running max m,
// the running sum l and an fp32 accumulator; the finite mask value
// -0.7 * FLT_MAX for masked keys inside the sequence (a row whose first
// tiles are all masked is zeroed later by corr = exp(m_prev - m_new)),
// -inf for key slots past Skv (weight exactly 0), the causal rule
// kpos <= qpos, the window kpos > qpos - window, and acc / max(l, 1e-30)
// at the end.  The output is bf16.  The wrapper
// (kernels/flash_attention.py, `kernel_for`) routes bf16 with dh 256 here;
// fp32 at dh 256 stays on the CUDA-core kernel, as TF32 would not hold its
// 3e-5.
//
// Precision, as in flash_attention_wgmma.cu: S = Q K^T on the tensor cores
// with fp32 accumulation is the reference's fp32 S up to the order of the
// sum (products of bf16 values are exact in fp32); P for P V is split into
// two bf16 halves, P_hi + P_lo, which keeps P to ~16 bits for half again as
// much tensor-core work; l is summed from the fp32 p.
//
// What bounds it on an H100: at recurrentgemma-9b's prefill (B=4, S=1024,
// H=16, kv=1, dh=256, causal; the window does not bind) the unmasked work
// is 34.4 GFLOP against 35 MB of q, k, v and o, so the tensor cores' 989
// TFLOP/s bf16 set the bound (0.035 ms; 0.052 ms with P split in two).
// The kernel it replaces ran that work on the CUDA cores (67 TFLOP/s) from
// fp32 tiles that left room for one 256-thread CTA per SM, and each of the
// 16 query heads re-read the one K/V head.  The design, for that bound:
// - a CTA is three warpgroups (384 threads).  Warpgroup 0 is the producer:
//   `setmaxnreg` lowers it to 24 registers and one thread issues every TMA
//   load.  Warpgroups 1 and 2 consume, raised to 240 registers: a thread
//   holds the 64 x 256 fp32 output fragment (128 registers), a 64 x 64
//   score tile (32) and P's two bf16 halves (32);
// - the two consumers take the same 64 query rows of two query heads of
//   one kv group (G = H / n_kv even, recurrentgemma's G = 16), so they
//   share every K/V tile and its causal and window bounds; where G is odd
//   (H = n_kv among them) they take two adjacent 64-row tiles of one head,
//   and both walk the union of the two tiles' key ranges (a key tile
//   wholly masked for one of them adds exactly 0 to its rows);
// - S = Q K^T over a tile of 64 keys is 16 `wgmma m64n64k16` from shared
//   memory, both operands K-major (dh contiguous); O += P V is, per 16 keys,
//   four `wgmma m64n128k16` (P_hi and P_lo, each on the two dh halves) with
//   A from registers and V MN-major through the descriptor's transpose bit;
// - S of tile j+1 and P V of tile j are issued together, and the softmax
//   of tile j+1 runs while P V of tile j does; while one consumer runs its
//   softmax the other's products keep the tensor cores busy too.  That
//   holds S, both halves of P and O at once, which ptxas fits in the 240
//   registers with no spill.  The last tile is peeled off the loop,
//   and each wgmma follows its mbarrier wait and a __syncwarp, so that
//   none sits on a divergent path (ptxas would serialize every wgmma of
//   the kernel: its note C7520);
// - shared memory is the two Q tiles (2 x 32 KB) and two-stage rings of K
//   and of V (4 x 32 KB), 192 KB in all, 128-byte swizzled (a 256-wide row
//   is four 64-column swizzle blocks, the swizzle the TMA maps write and
//   the wgmma descriptors name), so one CTA per SM.  The producer refills
//   a stage as soon as all eight consumer warps have released it (K after
//   its S, V after its P V), through full/empty mbarriers.  4-D tensor maps
//   over (B, S, heads, dh) with the tensors' strides read GQA K/V in place
//   and zero-fill rows past Sq/Skv;
// - key tiles wholly masked on either side are skipped: above the causal
//   diagonal, and below the window's start, the latter only where every
//   query row of the CTA keeps a key in [0, Skv) (a row with none takes
//   the mean of V, as the reference's all-masked softmax gives it);
// - the grid is (head pairs, B, query tiles) with the longest causal tiles
//   first, so the short tiles fill the tail: 8 x 4 x 16 = 512 CTAs at
//   recurrentgemma's prefill, 3.9 waves on 132 SMs.
// What limits it now (PERF.md §6, measured by scripts/probe_flash_d256.py):
// a tile takes about twice as long as its products would at the tensor
// cores' peak.  The K/V stream from L2 is hidden (taking it out gains
// nothing); the products and the CUDA-core work of a tile (softmax, P's
// split, the rescale of the 64 x 256 output) add up more than the two
// consumers overlap them.  Next steps: skip the rescale where no row's
// max moved (corr == 1 is exact), fold the scale into the exponent's FMA,
// and a schedule that keeps one consumer's products beside the other's
// softmax.
//
// Layout: q and o are (B, Sq, H, dh), k and v are (B, Skv, n_kv, dh), each
// given by its (batch, seq, head) strides in elements, dh contiguous;
// query head h reads kv head h / (H / n_kv).  TMA needs 16-byte aligned
// bases and strides; the wrapper passes tensors that have them.
//
// Plain C interface (bound with ctypes).  The entry returns 0, a
// cudaError_t from the launch, kErrNoEncoder if the driver has no
// cuTensorMapEncodeTiled, or kErrTensorMap + CUresult if a tensor map was
// refused.  flash_attention_wgmma_d256_faults reads (and clears) the word
// that records a ring wait that gave up.

#include <float.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kDH = 256;
constexpr int kBQ = 64;          // query rows per consumer warpgroup
constexpr int kBK = 64;          // key rows per tile
constexpr int kConsumers = 2;    // consumer warpgroups per CTA
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;       // depth of the K ring and of the V ring
constexpr int kNB = kDH / kCols; // 64-column swizzle blocks along dh
constexpr int kKQ = kDH / 16;    // k-steps of S = Q K^T
constexpr int kKP = kBK / 16;    // k-steps of O += P V
// 24 x 128 + 240 x 256 = 64,512 registers: the 168 a thread of a
// 384-thread CTA starts with, moved from the producer to the consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): each consumer's Q, then the K ring and the V ring, each tile as
// kNB column blocks of (64 rows x 128 bytes), then the mbarriers.
constexpr uint32_t kQBytes = kBQ * kDH * 2;            // one consumer's Q
constexpr uint32_t kTile = kBK * kDH * 2;              // one K or V tile
constexpr uint32_t kOffK = kConsumers * kQBytes;
constexpr uint32_t kOffV = kOffK + kStages * kTile;
constexpr uint32_t kOffBars = kOffV + kStages * kTile;
// full and empty barriers of both rings, and Q's
constexpr uint32_t kSmemBytes = kOffBars + 8 * (4 * kStages + 1) + 1024;

struct Params {
  __nv_bfloat16* o;
  long long ob, os, oh;          // element strides of o
  int Sq, Skv, H, n_kv;
  int causal;
  int window;                    // <= 0: no window
  int pair_heads;                // 1: two heads, same rows; 0: two row tiles
  float scale_log2;              // dh^-1/2 * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Set (never cleared by a launch) when a wait_phase gave up; read and
// cleared by flash_attention_wgmma_d256_faults.
__device__ unsigned int g_wait_gave_up = 0;

// Wait until the phase of `bar` with this parity has completed.  Unlike
// the header's mbar_wait, a wait that outlasts any load by orders of
// magnitude gives up instead of trapping: with a trap anywhere in the
// kernel, ptxas allocated the consumers' registers as if `setmaxnreg` had
// not raised them (spills and its note C7512).  A give-up is recorded in
// g_wait_gave_up, a plain global atomic, so that a fault in the rings ends
// the launch with an error the wrapper raises
// (kernels/flash_attention.py, `check_faults`), never with a hang and
// never with a wrong output that passes unseen.
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

// Online softmax statistics of one score tile in place: mask (only where
// the tile is not wholly unmasked for this warpgroup's rows q0..q0+63),
// scale to log2 units, update the running max and sum of both row halves,
// and leave p = exp2(s - m) in `sc`.  Returns each row half's correction
// exp2(m_prev - m_new) in `corr`.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2], const Params& p,
                                             int k0, int q0, int r0, int col) {
  const bool masked = k0 + kBK > p.Skv
                      || (p.causal && k0 + kBK - 1 > q0)
                      || (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);
  if (masked) {
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * i + col + (e & 1);
        const int qpos = r0 + 8 * (e >> 1);
        float x = sc[4 * i + e] * p.scale_log2;
        if (kpos >= p.Skv)
          x = -INFINITY;                   // not a key: weight exactly 0
        else if ((p.causal && kpos > qpos)
                 || (p.window > 0 && kpos <= qpos - p.window))
          x = kNegInf;
        sc[4 * i + e] = x;
      }
  } else {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] *= p.scale_log2;
  }
  // row half hh holds row r0 + 8 hh; a row lives in 4 lanes
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[hh], mx);
    corr[hh] = ex2(m_run[hh] - m_new);
    m_run[hh] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = ex2(sc[4 * i + 2 * hh + e] - m_new);
        sc[4 * i + 2 * hh + e] = pv;
        sum += pv;
      }
    l_run[hh] = l_run[hh] * corr[hh] + sum;
  }
}

// P in bf16 from the score fragment: keys 16kk..16kk+15 of the accumulator
// fragment are wgmma's A fragment of k-step kk.  P = P_hi + P_lo in two
// bf16 halves (P_lo = bf16(p - P_hi), p - P_hi exact in fp32).
__device__ __forceinline__ void pack_p(const float (&sc)[kBK / 2],
                                       uint32_t (&pa)[kKP][4],
                                       uint32_t (&pl)[kKP][4]) {
#pragma unroll
  for (int kk = 0; kk < kKP; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      pa[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
    }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_d256_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kOffBars;
  auto sK = [&](int s) { return base + kOffK + s * kTile; };
  auto sV = [&](int s) { return base + kOffV + s * kTile; };
  auto kfull = [&](int s) { return bars + 8 * s; };
  auto kempty = [&](int s) { return bars + 8 * (kStages + s); };
  auto vfull = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto vempty = [&](int s) { return bars + 8 * (3 * kStages + s); };
  const uint32_t qbar = bars + 8 * 4 * kStages;

  // the warpgroup, made warp-uniform for the compiler: 0 produces, 1 and 2
  // consume
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;

  // the CTA's two (head, first query row) units, one per consumer
  const int b = blockIdx.y;
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  int h0, h1, q00, q01;
  if (p.pair_heads) {
    const int qt = nq - 1 - blockIdx.z;    // longest causal tiles first
    h0 = 2 * blockIdx.x;
    h1 = h0 + 1;
    q00 = q01 = qt * kBQ;
  } else {
    const int u = (nq + 1) / 2 - 1 - blockIdx.z;
    h0 = h1 = blockIdx.x;
    q00 = 2 * u * kBQ;
    q01 = q00 + kBQ;                       // may lie past Sq: not stored
  }
  const int hk = h0 / (p.H / p.n_kv);
  // key tiles t0 .. t0 + n_tiles - 1: the union of both units' ranges
  const int qa = q00;
  const int qb = min(q01 + kBQ - 1, p.Sq - 1);
  const int k_end = p.causal ? min(p.Skv, qb + 1) : p.Skv;
  int k_begin = 0;
  if (p.window > 0 && qb <= p.Skv + p.window - 2)   // every row keeps a key
    k_begin = max(0, qa - p.window + 1);
  const int t0 = k_begin / kBK;
  const int n_tiles = (k_end + kBK - 1) / kBK - t0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(kempty(s), kConsumers * 4);
      mbar_init(vfull(s), 1);
      mbar_init(vempty(s), kConsumers * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every load -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(qbar, kConsumers * kQBytes);
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        tma_load(base + c * kBQ * 128, &tq, qbar, c * kCols, h0, q00, b);
        tma_load(base + kQBytes + c * kBQ * 128, &tq, qbar, c * kCols, h1,
                 q01, b);
      }
      // tile i goes to stage i % kStages once the tile kStages before it
      // has been released by all eight consumer warps
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int row = (t0 + i) * kBK;
        if (i >= kStages) wait_phase(kempty(s), (i / kStages - 1) & 1);
        mbar_expect_tx(kfull(s), kTile);
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          tma_load(sK(s) + c * kBK * 128, &tk, kfull(s), c * kCols, hk, row,
                   b);
        if (i >= kStages) wait_phase(vempty(s), (i / kStages - 1) & 1);
        mbar_expect_tx(vfull(s), kTile);
#pragma unroll
        for (int c = 0; c < kNB; ++c)
          tma_load(sV(s) + c * kBK * 128, &tv, vfull(s), c * kCols, hk, row,
                   b);
      }
    }
  } else {
    // ---------------- consumers -------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int w = wg - 1;
    const int h = w ? h1 : h0;
    const int q0 = w ? q01 : q00;
    const uint32_t sQ = base + w * kQBytes;
    const int warp = tid / 32;             // 16 rows each
    const int lane = tid % 32;
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);   // this warp is done with it
    };
    auto wait_k = [&](int i) {
      wait_phase(kfull(i % kStages), (i / kStages) & 1);
    };
    auto wait_v = [&](int i) {
      wait_phase(vfull(i % kStages), (i / kStages) & 1);
    };
    // S = Q K_i^T (kBK keys) and O += P V_i, issued (not waited for).
    // Their callers wait on the tiles' mbarriers, then __syncwarp, then
    // wgmma_fence, so that no wgmma sits on a divergent path.
    auto issue_s = [&](float (&acc)[kBK / 2], int i) {
      const int s = i % kStages;
#pragma unroll
      for (int kk = 0; kk < kKQ; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns inside the block
        const uint64_t dq = sw128_desc(sQ + (kk / 4) * kBQ * 128 + off, 16,
                                       1024);
        const uint64_t dk = sw128_desc(sK(s) + (kk / 4) * kBK * 128 + off,
                                       16, 1024);
        wgmma_ss(acc, dq, dk, kk > 0);     // m64n64k16
      }
      wgmma_commit();
    };
    auto issue_pv = [&](float (&o0)[64], float (&o1)[64],
                        const uint32_t (&hi)[kKP][4],
                        const uint32_t (&lo)[kKP][4], int i) {
      const int s = i % kStages;
#pragma unroll
      for (int kk = 0; kk < kKP; ++kk) {
        // V's tile is MN-major (dh contiguous): a k-step is 16 key rows
        // (2048 bytes), a 64-column block of dh is LBO away; dh 128..255
        // start two blocks in
        const uint32_t a = sV(s) + kk * 16 * 128;
        const uint64_t d0 = sw128_desc(a, kBK * 128, 1024);
        const uint64_t d1 = sw128_desc(a + 2 * kBK * 128, kBK * 128, 1024);
        wgmma_rs(o0, hi[kk], d0);          // m64n128k16
        wgmma_rs(o0, lo[kk], d0);
        wgmma_rs(o1, hi[kk], d1);
        wgmma_rs(o1, lo[kk], d1);
      }
      wgmma_commit();
    };

    // This thread's rows: r0 and r0 + 8 of the accumulator fragments.
    const int r0 = q0 + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);        // first of two columns per 8
    float o0[64], o1[64];                  // dh 0..127 and 128..255
#pragma unroll
    for (int i = 0; i < 64; ++i) o0[i] = o1[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};           // this thread's partial row sums
    float corr[2];
    float sc[kBK / 2];
    uint32_t pa[kKP][4];
    uint32_t pl[kKP][4];

    // tile 0: S_0, its softmax and P_0
    wait_phase(qbar, 0);
    wait_k(0);
    __syncwarp();
    wgmma_fence();
    issue_s(sc, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(kempty(0));
    softmax_tile(sc, m_run, l_run, corr, p, t0 * kBK, q0, r0, col);
    pack_p(sc, pa, pl);

    // tiles j < n - 1: S_{j+1} and then P_j V_j go to the tensor cores
    // together; the softmax of tile j+1 runs while P_j V_j does, and O is
    // rescaled once P_j V_j is done
    for (int j = 0; j + 1 < n_tiles; ++j) {
      wait_k(j + 1);
      wait_v(j);
      __syncwarp();
      wgmma_fence();
      issue_s(sc, j + 1);
      issue_pv(o0, o1, pa, pl, j);
      wgmma_wait<1>();                     // S_{j+1} done, P_j V_j may run
      fence_regs(sc);
      release(kempty((j + 1) % kStages));
      softmax_tile(sc, m_run, l_run, corr, p, (t0 + j + 1) * kBK, q0, r0,
                   col);
      wgmma_wait<0>();
      fence_regs(o0);
      fence_regs(o1);
      fence_regs(pa);
      fence_regs(pl);
      release(vempty(j % kStages));
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o0[4 * i + e] *= corr[e >> 1];
          o1[4 * i + e] *= corr[e >> 1];
        }
      pack_p(sc, pa, pl);
    }
    // the last tile's P V
    wait_v(n_tiles - 1);
    __syncwarp();
    wgmma_fence();
    issue_pv(o0, o1, pa, pl, n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);
    fence_regs(pa);
    fence_regs(pl);

    // epilogue: O / max(l, 1e-30) in bf16, rows past Sq not stored
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = r0 + 8 * hh;
      if (row >= p.Sq) continue;
      __nv_bfloat16* out = p.o + b * p.ob + (long long)row * p.os + h * p.oh;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        *reinterpret_cast<uint32_t*>(out + 8 * i + col) =
            pack_bf16(o0[4 * i + 2 * hh] * inv, o0[4 * i + 2 * hh + 1] * inv);
        *reinterpret_cast<uint32_t*>(out + 128 + 8 * i + col) =
            pack_bf16(o1[4 * i + 2 * hh] * inv, o1[4 * i + 2 * hh + 1] * inv);
      }
    }
  }
}

}  // namespace

// bf16 q, k, v and o; dh 256.  strides: 12 element strides, (batch, seq,
// head) for q, k, v, o in turn.
extern "C" int flash_attention_wgmma_d256_fwd(const void* q, const void* k,
                                              const void* v, void* o, int B,
                                              int Sq, int Skv, int H,
                                              int n_kv, int dh,
                                              const long long* strides,
                                              int causal, int window,
                                              float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || n_kv <= 0 ||
      H % n_kv != 0 || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 ||
      dh != kDH)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(encode, &tq, q, B, Sq, H, dh, strides[0], strides[1],
                        strides[2], kBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tk, k, B, Skv, n_kv, dh, strides[3], strides[4],
                 strides[5], kBK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tv, v, B, Skv, n_kv, dh, strides[6], strides[7],
                 strides[8], kBK);
  if (r != CUDA_SUCCESS) return kErrTensorMap + (int)r;
  // two heads of one kv group per CTA where the group size is even, else
  // two adjacent query tiles of one head
  const int pair_heads = (H / n_kv) % 2 == 0;
  Params p{static_cast<__nv_bfloat16*>(o), strides[9], strides[10],
           strides[11], Sq, Skv, H, n_kv, causal, window, pair_heads,
           scale * kLog2e};
  const int nq = (Sq + kBQ - 1) / kBQ;
  const dim3 grid(pair_heads ? H / 2 : H, B, pair_heads ? nq : (nq + 1) / 2);
  auto kernel = flash_attention_wgmma_d256_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&tq, &tk, &tv, &p};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                         dim3(kThreads), args, kSmemBytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The give-up word of every launch since the last read, into *word; with
// `clear`, reset to 0.  Synchronous: the copy from the symbol waits for the
// launches queued before it on the legacy default stream.
extern "C" int flash_attention_wgmma_d256_faults(unsigned int* word,
                                                 int clear) {
  cudaError_t err =
      cudaMemcpyFromSymbol(word, g_wait_gave_up, sizeof(unsigned int));
  if (err == cudaSuccess && clear && *word != 0) {
    const unsigned int zero = 0;
    err = cudaMemcpyToSymbol(g_wait_gave_up, &zero, sizeof(unsigned int));
  }
  return (int)err;
}
