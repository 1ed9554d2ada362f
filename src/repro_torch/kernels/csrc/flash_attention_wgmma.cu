// Flash attention for bf16 on Hopper's tensor cores (sm_90a): wgmma for
// both products, K and V staged by TMA through mbarrier rings.
//
// Replaces the TPU kernel `flash_attention_kernel_call`
// (src/repro/kernels/flash_attention.py:85, body `_kernel` :31) for bf16
// q/k/v with head dims 64 and 128, the heads of every published config
// this kernel takes.  Same function as that kernel and as the CUDA-core
// kernel beside it (flash_attention.cu), which keeps fp32 and the other
// head dims: softmax(q k^T * dh^-1/2 + mask) v per query row, with the
// running max m, the running sum l and an fp32 accumulator; the finite
// mask value -0.7 * FLT_MAX for masked keys inside the sequence (a row
// whose first tiles are all masked is zeroed later by
// corr = exp(m_prev - m_new)), -inf for key slots past Skv (weight exactly
// 0), the causal skip of key tiles wholly above the diagonal, the window
// kpos > qpos - window, and acc / max(l, 1e-30) at the end.  The output is
// bf16.  The wrapper (kernels/flash_attention.py, `kernel_for`) routes
// bf16 with dh 64/128 here and everything else to the CUDA-core kernel.
//
// Precision.  Products of bf16 values are exact in fp32, so S = Q K^T on
// the tensor cores with fp32 accumulation is the reference's fp32 S up to
// the order of the sum.  P for P V is split into two bf16 halves, P_hi +
// P_lo, and multiplied by V twice, which keeps P to ~16 bits for half
// again as much tensor-core work.  At the llama3-8b prefill, P rounded to
// one bf16 (2^-9 relative a term) added a quarter to the output's RMS
// error against the fp32 reference, beyond what rounding the output to
// bf16 costs, and changed 39 % of the output values; with the split the
// output's RMS error is that of the rounded fp32 reference (PERF.md §6).
// l is summed from the fp32 p, as in the reference.
// fp32 inputs stay on the CUDA-core kernel: TF32 would not hold their
// 3e-5.
//
// What bounds it on an H100: at the llama3-8b prefill (B=4, S=1024, H=32,
// kv=8, dh=128, causal) the unmasked work is 34.4 GFLOP against 84 MB of
// q, k, v and o, so the tensor cores' 989 TFLOP/s bf16 set the bound
// (0.035 ms).  The design, for that bound:
// - one CTA is one warpgroup of 128 threads and owns 64 query rows (the
//   wgmma M); Q is loaded once by TMA into shared memory.  A CTA takes
//   81 KB of shared memory, so two CTAs share an SM and each one's loads,
//   softmax and epilogue overlap the other's products;
// - S = Q K^T over a tile of 64 keys is dh/16 `wgmma m64n64k16` from
//   shared memory, both operands K-major (dh contiguous), into 32 fp32
//   registers a thread;
// - the online softmax runs on that accumulator fragment in registers:
//   each row lives in 4 lanes, reduced with __shfl_xor_sync; no shared
//   memory and no block barrier on the math path; tiles wholly inside
//   the unmasked region skip the mask arithmetic;
// - P is packed to bf16 in registers, which is wgmma's A-fragment layout
//   for the accumulator's own layout, and O += P V is 8 (4 for P_hi, 4
//   for P_lo) `wgmma m64n{dh}k16` with A from registers and V from shared
//   memory, MN-major (dh contiguous) through the descriptor's transpose
//   bit;
// - S of tile j+1 and P V of tile j are issued together, and the softmax
//   of tile j+1 runs while P V of tile j does; O is rescaled when P V is
//   done.  The last tile is peeled off the loop, so that no wgmma sits
//   on a divergent path: ptxas would serialize every wgmma of the kernel
//   (its note C7520);
// - K and V come by TMA through separate two-stage rings with full/empty
//   mbarriers: thread 0 refills a stage as soon as all four warps have
//   released it (K after its S, V after its P V).  4-D tensor maps over
//   (B, S, heads, dh) with the tensors' strides read GQA K/V in place
//   (the kv head is a coordinate) and zero-fill rows past Sq/Skv.  Shared
//   memory is 128-byte swizzled, the swizzle the TMA maps write and the
//   wgmma descriptors name;
// - the grid is (H, B, query tiles) with the longest causal tiles
//   scheduled first for every head, so the short tiles fill the tail.
// What limits it now (PERF.md §6): the tensor cores are busy well under
// half of each tile's time.  The softmax and the packing of P for a
// 64 x 64 tile take longer than the tile's products, and two warpgroups
// per SM do not hide that; a producer warp with `setmaxnreg`, wider key
// tiles and ping-pong scheduling of two warpgroups per CTA (FlashAttention
// 3) are the next steps.
//
// Layout: q and o are (B, Sq, H, dh), k and v are (B, Skv, n_kv, dh), each
// given by its (batch, seq, head) strides in elements, dh contiguous;
// query head h reads kv head h / (H / n_kv).  TMA needs 16-byte aligned
// bases and strides; the wrapper passes tensors that have them.
//
// Plain C interface (bound with ctypes).  The entry returns 0, a
// cudaError_t from the launch, kErrNoEncoder if the driver has no
// cuTensorMapEncodeTiled, or kErrTensorMap + CUresult if a tensor map was
// refused.

#include <float.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per CTA: one warpgroup
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;       // depth of the K ring and of the V ring
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  long long ob, os, oh;          // element strides of o
  int Sq, Skv, H, n_kv;
  int causal;
  int window;                    // <= 0: no window
  float scale_log2;              // dh^-1/2 * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): Q as DH/64 column blocks of (kBQ rows x 128 bytes), then the
// K ring and the V ring, kStages tiles each, a tile as DH/64 column blocks
// of (kBK rows x 128 bytes), then the mbarriers.
template <int DH>
struct Smem {
  static constexpr uint32_t kQ = kBQ * DH * 2;
  static constexpr uint32_t kTile = kBK * DH * 2;        // one K or V tile
  static constexpr uint32_t kK = kQ;                     // K ring
  static constexpr uint32_t kV = kK + kStages * kTile;   // V ring
  static constexpr uint32_t kBars = kV + kStages * kTile;
  // full and empty barriers of both rings, and Q's
  static constexpr uint32_t kBytes = kBars + 8 * (4 * kStages + 1) + 1024;
};

// Online softmax statistics of one score tile in place: mask (only where
// the tile is not wholly unmasked), scale to log2 units, update the running
// max and sum of both row halves, and leave p = exp2(s - m) in `sc`.
// Returns each row half's correction exp2(m_prev - m_new) in `corr`.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m_run)[2],
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
    for (int i = 0; i < N; ++i) sc[i] *= p.scale_log2;
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
// bf16 halves (P_lo = bf16(p - P_hi), p - P_hi exact in fp32), so P keeps
// ~16 bits.
template <int N, int KP>
__device__ __forceinline__ void pack_p(const float (&sc)[N],
                                       uint32_t (&pa)[KP][4],
                                       uint32_t (&pl)[KP][4]) {
#pragma unroll
  for (int kk = 0; kk < KP; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      pa[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
    }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Params p) {
  using L = Smem<DH>;
  constexpr int NB = DH / kCols;           // swizzle column blocks along dh
  constexpr int KQ = DH / 16;              // k-steps of S = Q K^T
  constexpr int KP = kBK / 16;             // k-steps of O += P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bars = base + L::kBars;
  auto sK = [&](int s) { return base + L::kK + s * L::kTile; };
  auto sV = [&](int s) { return base + L::kV + s * L::kTile; };
  auto kfull = [&](int s) { return bars + 8 * s; };
  auto kempty = [&](int s) { return bars + 8 * (kStages + s); };
  auto vfull = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto vempty = [&](int s) { return bars + 8 * (3 * kStages + s); };
  const uint32_t qbar = bars + 8 * 4 * kStages;

  const int tid = threadIdx.x;
  const int warp = tid / 32;               // 16 rows each
  const int lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - blockIdx.z;      // longest causal tiles first
  const int hk = h / (p.H / p.n_kv);
  const int q0 = qt * kBQ;
  int k_end = p.Skv;
  if (p.causal) k_end = min(k_end, q0 + kBQ);   // skip tiles above diagonal
  const int n_tiles = (k_end + kBK - 1) / kBK;

  // the producer is thread 0: tile t of K or V goes to stage t % kStages,
  // once the tile kStages before it has been released by all four warps
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                  uint32_t empty, int t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
    mbar_expect_tx(full + 8 * s, L::kTile);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(ring + s * L::kTile + c * kBK * 128, map, full + 8 * s,
               c * kCols, hk, t * kBK, b);
  };
  auto load_k = [&](int t) {
    if (tid == 0 && t < n_tiles) load(&tk, sK(0), kfull(0), kempty(0), t);
  };
  auto load_v = [&](int t) {
    if (tid == 0 && t < n_tiles) load(&tv, sV(0), vfull(0), vempty(0), t);
  };
  auto release = [&](uint32_t empty) {
    if (lane == 0) mbar_arrive(empty);     // this warp is done with it
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(kempty(s), kThreads / 32);
      mbar_init(vfull(s), 1);
      mbar_init(vempty(s), kThreads / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::kQ);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(sQ + c * kBQ * 128, &tq, qbar, c * kCols, h, q0, b);
  }
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    load_k(t);
    load_v(t);
  }

  // S = Q K_t^T (kBK keys) and O += P V_t, issued (not waited for).
  // Their callers wait on the tiles' mbarriers, then __syncwarp, then
  // wgmma_fence, so that no wgmma sits on a divergent path (ptxas would
  // serialize every wgmma of the kernel).
  auto issue_s = [&](float (&acc)[kBK / 2], int t) {
    const int s = t % kStages;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns inside the block
      const uint64_t dq = sw128_desc(sQ + (kk / 4) * kBQ * 128 + off, 16,
                                     1024);
      const uint64_t dk = sw128_desc(sK(s) + (kk / 4) * kBK * 128 + off, 16,
                                     1024);
      wgmma_ss(acc, dq, dk, kk > 0);       // m64n{kBK}k16
    }
    wgmma_commit();
  };
  auto issue_pv = [&](float (&acc)[DH / 2], const uint32_t (&hi)[KP][4],
                      const uint32_t (&lo)[KP][4], int t) {
    const int s = t % kStages;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      // V's tile is MN-major (dh contiguous): a k-step is 16 key rows
      // (2048 bytes), a 64-column block of dh is LBO away
      const uint64_t dv = sw128_desc(sV(s) + kk * 16 * 128, kBK * 128, 1024);
      wgmma_rs(acc, hi[kk], dv);           // m64n{DH}k16
      wgmma_rs(acc, lo[kk], dv);
    }
    wgmma_commit();
  };
  auto wait_k = [&](int t) {
    mbar_wait(kfull(t % kStages), (t / kStages) & 1);
  };
  auto wait_v = [&](int t) {
    mbar_wait(vfull(t % kStages), (t / kStages) & 1);
  };

  // This thread's rows: r0 and r0 + 8 of the accumulator fragments.
  const int r0 = q0 + warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);          // first of two columns per 8
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};             // this thread's partial row sums
  float corr[2];
  float sc[kBK / 2];
  uint32_t pa[KP][4];
  uint32_t pl[KP][4];

  // tile 0: S_0, its softmax and P_0
  mbar_wait(qbar, 0);
  wait_k(0);
  __syncwarp();
  wgmma_fence();
  issue_s(sc, 0);
  wgmma_wait<0>();
  fence_regs(sc);
  release(kempty(0));
  load_k(kStages);
  softmax_tile(sc, m_run, l_run, corr, p, 0, q0, r0, col);
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
    issue_pv(o, pa, pl, j);
    wgmma_wait<1>();                       // S_{j+1} done, P_j V_j may run
    fence_regs(sc);
    release(kempty((j + 1) % kStages));
    load_k(j + 1 + kStages);
    softmax_tile(sc, m_run, l_run, corr, p, (j + 1) * kBK, q0, r0, col);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    fence_regs(pl);
    release(vempty(j % kStages));
    load_v(j + kStages);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] *= corr[e >> 1];
    pack_p(sc, pa, pl);
  }
  // the last tile's P V
  wait_v(n_tiles - 1);
  __syncwarp();
  wgmma_fence();
  issue_pv(o, pa, pl, n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);
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
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + 8 * i + col) =
          pack_bf16(o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

template <int DH>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, int B,
           cudaStream_t stream) {
  auto kernel = flash_attention_wgmma_kernel<DH>;
  const int smem = Smem<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, B, (p.Sq + kBQ - 1) / kBQ);
  void* args[] = {const_cast<CUtensorMap*>(&tq),
                  const_cast<CUtensorMap*>(&tk),
                  const_cast<CUtensorMap*>(&tv), const_cast<Params*>(&p)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                         dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and o; dh 64 or 128.  strides: 12 element strides, (batch,
// seq, head) for q, k, v, o in turn.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Sq, int Skv, int H, int n_kv,
                                         int dh, const long long* strides,
                                         int causal, int window, float scale,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || n_kv <= 0 ||
      H % n_kv != 0 || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535 ||
      (dh != 64 && dh != 128))
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
  Params p{static_cast<__nv_bfloat16*>(o), strides[9], strides[10],
           strides[11], Sq, Skv, H, n_kv, causal, window,
           scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dh == 128 ? launch<128>(tq, tk, tv, p, B, s)
                   : launch<64>(tq, tk, tv, p, B, s);
}
