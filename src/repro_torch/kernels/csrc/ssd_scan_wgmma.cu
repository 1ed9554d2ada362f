// Fused Mamba2 SSD chunk scan for bf16 x, B and C on Hopper's tensor cores
// (sm_90a): every product on `wgmma` with fp32 accumulation, the fp32
// operands split into three bf16 terms, the chunks in parallel.
//
// Replaces the TPU kernel `ssd_scan_kernel_call`
// (src/repro/kernels/ssd_scan.py:84, body `_kernel` :38) for bf16 x/B/C
// with head dim P = 64, state size N = 128 (the mamba2 family's) and
// chunks of 64..256 steps in steps of 64: the model's prefill path.  Same
// function as that kernel and as the CUDA-core kernel beside it
// (ssd_scan.cu), which keeps fp32 and the other shapes.  Per (batch b,
// head h) and chunk c of l steps, with acum the inclusive cumulative sum of
// A dt inside the chunk and s_c the (P, N) state entering it:
//
//     y      = ((C B^T) o L o dt_j) x  +  (C s_c^T) o exp(acum)
//              L[i,j] = exp(acum_i - acum_j) for i >= j, else 0
//     s_c+1  = s_c exp(acum[l-1]) + (x o dt exp(acum[l-1] - acum))^T B
//
// from an optional initial state s_0 (zero when absent); y and the final
// state are fp32.  L is a select, not a product with a 0/1 mask:
// exp(acum_i - acum_j) overflows above the diagonal and inf * 0 is NaN.
//
// Precision.  A product of two bf16 values is exact in fp32, so C B^T runs
// on the tensor cores as it is.  Three products have an fp32 operand: the
// weights W = (C B^T) o L o dt_j against x, C against the state, and
// x o dt exp(..) against B.  Each such operand v is split into three bf16
// terms, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid) (each
// difference exact in fp32), which keeps ~24 bits of v, and the product
// runs once per term into the same fp32 accumulator.  With one term the
// scan misses the reference's atol = rtol = 1e-4; with three it holds it
// with a wide margin (tests/test_torch_kernels.py holds the split's
// arithmetic on the host; PERF.md §6).
//
// What bounds it on an H100: at the mamba2-370m prefill (B=4, S=1024,
// H=32, P=64, N=128, l=256) the function needs 6.59 GFLOP (0.0067 ms at
// the 989 TFLOP/s bf16 peak) against 57.1 MB of inputs and outputs
// (x 16.8 MB bf16, y 33.5 MB fp32, the final state 4.2, B and C 2.1, dt
// 0.5), so device memory bounds it: 0.0171 ms at 3.35 TB/s.  The split
// triples the products with an fp32 operand, and each (b, chunk)'s C B^T
// is recomputed by every head: 26 GFLOP on the tensor cores, 0.026 ms at
// their peak, which is what the design has to keep busy.  No widening
// copy: x, B and C are read as bf16 by TMA.  Two kernels, launched one
// after the other:
// - ssd_wgmma_state_kernel, grid (N / 64, H, B), two warpgroups: each
//   carries a partial 64 x 64 slice of the state in its wgmma accumulator
//   through the whole sequence (the recurrence is linear, so the state is
//   the sum of the two), over its half of every 64-step tile.  At each
//   chunk boundary the two partials are summed through shared memory into
//   the scratch buffer (B, nc, H, P, N) of the states entering the chunks,
//   and at the end into the final state.  Per chunk both scale their
//   accumulators by exp(acum[l-1]) and add (x o w)^T B, w_j = dt_j
//   exp(acum[l-1] - acum_j), as `wgmma m64n64k16` with the split x o w
//   built in registers (A fragments) and B from shared memory (MN-major,
//   through the transpose bit).  x and B come in 64-step tiles by TMA
//   through a four-stage mbarrier ring; dt is fetched a chunk ahead.  This
//   pass is the only one that walks the chunks in sequence.
// - ssd_wgmma_output_kernel, grid (H, B * nc): one CTA per chunk, one
//   warpgroup per 64-row query tile (four at l = 256, 512 CTAs at the
//   prefill shape, one per SM at 216 KB of shared memory).  Every C, B and
//   x tile of the chunk is loaded by TMA at the start, one mbarrier a
//   tile, and the chunk's entering state is split into shared memory
//   (K-major, the 128-byte swizzle the descriptors name), so nothing waits
//   on a refill.  Each warpgroup computes y_off = C_i s^T together with
//   S = C_i B_0^T, scales y_off's rows by exp(acum_i), then for each key
//   tile j <= i forms W in registers on S's accumulator fragment (which is
//   the A fragment of the next product, as P is in
//   flash_attention_wgmma.cu), splits it and runs y += W x_j with x
//   MN-major through the transpose bit, then S of the next tile.  y is
//   written once, in fp32.  W x_j and the next S are issued in turn, not
//   together: together they need y, S and W's three terms live at once,
//   more than the 128 registers a thread of a 512-thread CTA has, and
//   ptxas then serializes every wgmma (its note C7512).
// The diagonal tile's select sits in registers, never around a wgmma; the
// last tile's W x is peeled off the loop: ptxas serializes every wgmma of
// a kernel when one is on a divergent path (C7520).
// What limits it now (PERF.md §6): the state pass's sequential walk (a
// third of the time at B=4, half at B=1) and, in the output pass, one CTA
// per SM whose loads do not overlap another CTA's products.
//
// Layout (contiguous): x (B, S, H, P) bf16, dt (B, S, H) fp32, A (H,) fp32,
// Bm and Cm (B, S, N) bf16, init and state (B, H, P, N) fp32, y (B, S, H, P)
// fp32, states (B, nc, H, P, N) fp32 scratch; S = nc * l.  TMA needs
// 16-byte aligned bases; the wrapper passes tensors that have them.
//
// Plain C interface (bound with ctypes).  The entry returns 0, a
// cudaError_t from a launch, kErrNoEncoder if the driver has no
// cuTensorMapEncodeTiled, or kErrTensorMap + CUresult if a tensor map was
// refused.

#include "hopper_wgmma.cuh"

namespace {

constexpr int kT = 64;                 // steps of a tile; rows of a wgmma
constexpr int kP = 64;                 // head_dim
constexpr int kN = 128;                // d_state
constexpr int kThreads = 128;          // one warpgroup
constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / kT;   // warpgroups of an output CTA
constexpr int kStages = 4;             // ring depth of the state pass
constexpr uint32_t kTile = kT * 128;   // one 64-row x 128-byte tile

struct Params {
  const float* dt;
  const float* A;
  const float* init;                   // nullptr: zero initial state
  float* states;                       // the state entering each chunk
  float* state;                        // the final state
  float* y;
  int S, H, l;
};

// Inclusive prefix sum of a[0..n) in place (one warp; n <= 32 * 64).
__device__ void warp_cumsum(float* a, int n) {
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
    a[i] = run;
  }
}

// dt of the chunk starting at step c0 into sDt, and the inclusive
// cumulative sum of A dt into sAcum.  Starts and ends with a block barrier.
__device__ void chunk_acum(const Params& p, int b, int h, int c0, float* sDt,
                           float* sAcum) {
  const float A = p.A[h];
  const float* dtb = p.dt + ((long long)b * p.S + c0) * p.H + h;
  __syncthreads();
  for (int j = threadIdx.x; j < p.l; j += blockDim.x) {
    const float d = dtb[(long long)j * p.H];
    sDt[j] = d;
    sAcum[j] = A * d;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(sAcum, p.l);
  __syncthreads();
}

// exp(x) for the x <= 0 of the decay mask, as 2^(x log2 e) on the
// multi-function unit (relative error ~2^-22; flushes below 2^-126 to 0).
__device__ __forceinline__ float exp_le0(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) = hi + mid + lo, three packed bf16 pairs: each term the rounded
// rest of the ones before it (the differences are exact in fp32).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
}

// Element (row, col) of a 64-column bf16 tile as TMA writes it with the
// 128-byte swizzle: 16-byte chunk col / 8 of row `row` sits at chunk
// (col / 8) ^ (row % 8).
__device__ __forceinline__ float swz_bf16(const uint8_t* tile, int row,
                                          int col) {
  const int off = row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + off));
}

// The 64 x 64 fp32 accumulator fragment `acc` of rows r0 (+8) and columns
// col0 + 8 i + 2 q (+1) into a row-major matrix with row stride ld.
__device__ __forceinline__ void store_frag(float* out, const float (&acc)[32],
                                           int r0, int col0, long long ld) {
  const int q = threadIdx.x % 4;   // lane % 4
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (r0 + 8 * hh) * ld + col0 + 8 * i
                                 + 2 * q) =
          make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
}

// ---------------------------------------------------------------------------
// Pass 1: the state through the sequence
// ---------------------------------------------------------------------------

constexpr int kStateThreads = 2 * kThreads;   // two warpgroups

// Shared memory, from a 1024-byte aligned base: kStages stages of (x tile,
// B tile), then dt and the weights w of a chunk, the second warpgroup's
// partial state, then the mbarriers.
struct StateSmem {
  static constexpr uint32_t kRing = kStages * 2 * kTile;
  static constexpr uint32_t kDt = kRing;
  static constexpr uint32_t kW = kDt + 4 * kMaxChunk;
  static constexpr uint32_t kPart = kW + 4 * kMaxChunk;
  static constexpr uint32_t kBars = kPart + 4 * 32 * kThreads;
  static constexpr uint32_t kBytes = kBars + 8 * 2 * kStages + 1024;
};

__global__ void __launch_bounds__(kStateThreads)
ssd_wgmma_state_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tb,
                       const Params p) {
  using L = StateSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* sDt = reinterpret_cast<float*>(gbase + L::kDt);
  float* sW = reinterpret_cast<float*>(gbase + L::kW);
  float* sPart = reinterpret_cast<float*>(gbase + L::kPart);
  auto sx = [&](int s) { return base + s * 2 * kTile; };
  auto sb = [&](int s) { return base + s * 2 * kTile + kTile; };
  auto full = [&](int s) { return base + L::kBars + 8 * s; };
  auto empty = [&](int s) { return base + L::kBars + 8 * (kStages + s); };

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;         // k-steps 2 wg, 2 wg + 1 of a tile
  const int wtid = tid % kThreads;
  const int warp = wtid / 32, lane = tid % 32;
  const int nh = blockIdx.x;             // columns 64 nh .. 64 nh + 63 of N
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = p.S / p.l;
  const int tpc = p.l / kT;              // tiles per chunk
  const int n_tiles = p.S / kT;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kStateThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 loads tile t into stage t % kStages once every warp has
  // released the tile kStages before it
  auto load = [&](int t) {
    if (tid == 0 && t < n_tiles) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty(s), (t / kStages - 1) & 1);
      mbar_expect_tx(full(s), 2 * kTile);
      tma_load(sx(s), &tx, full(s), 0, h, t * kT, b);
      tma_load(sb(s), &tb, full(s), nh * kCols, 0, t * kT, b);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages; ++t) load(t);

  // Each warpgroup carries a partial state over its half of every tile's
  // steps; the state is their sum (the recurrence is linear).  This
  // thread's accumulator rows (p) r0 and r0 + 8, columns (n)
  // 64 nh + 8 i + 2 q (+1)
  const int q = lane % 4;
  const int r0 = warp * 16 + lane / 4;
  const long long bh = ((long long)b * p.H + h) * kP * kN;
  float st[32];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[4 * i + e] = p.init && wg == 0
          ? p.init[bh + (r0 + 8 * (e >> 1)) * kN + nh * kCols + 8 * i + 2 * q
                   + (e & 1)]
          : 0.f;
  uint32_t ahi[2][4], amid[2][4], alo[2][4];
  // the state (the sum of the two partials) to out, by the first
  // warpgroup; the caller's next block barrier keeps sPart until read
  auto store_state = [&](float* out) {
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sPart[i * kThreads + wtid] = st[i];
    }
    __syncthreads();
    if (wg == 0) {
      float sum[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = st[i] + sPart[i * kThreads + wtid];
      store_frag(out, sum, r0, nh * kCols, kN);
    }
  };

  // this thread's dt of a chunk, step tid (l <= 256), fetched a chunk
  // ahead so that its latency hides behind the chunk before
  const float A = p.A[h];
  const float* dtb = p.dt + (long long)b * p.S * p.H + h;
  float dnext;
  auto fetch_dt = [&](int c) {
    dnext = c < nc && tid < p.l ? dtb[(long long)(c * p.l + tid) * p.H] : 0.f;
  };
  fetch_dt(0);

  for (int c = 0; c < nc; ++c) {
    // (its barrier also orders every read of the last chunk's w before
    // the writes below)
    store_state(p.states + (((long long)b * nc + c) * p.H + h) * kP * kN);
    if (tid < p.l) {
      sDt[tid] = dnext;
      sW[tid] = A * dnext;
    }
    fetch_dt(c + 1);
    __syncthreads();
    if (tid < 32) warp_cumsum(sW, p.l);
    __syncthreads();
    const float last = sW[p.l - 1];
    __syncthreads();
    if (tid < p.l) sW[tid] = sDt[tid] * expf(last - sW[tid]);
    __syncthreads();
    const float decay = expf(last);
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] *= decay;

    for (int jt = 0; jt < tpc; ++jt) {
      const int t = c * tpc + jt;
      const int s = t % kStages;
      mbar_wait(full(s), (t / kStages) & 1);
      // A = (x o w)^T, rows p, this warpgroup's two k-steps of 16 steps j,
      // split in three
      const uint8_t* xt = gbase + s * 2 * kTile;
      const float* w = sW + jt * kT;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + 8 * (r & 1);
          const int j = 16 * (2 * wg + k2) + 2 * q + 8 * (r >> 1);
          split3(swz_bf16(xt, j, row) * w[j],
                 swz_bf16(xt, j + 1, row) * w[j + 1], ahi[k2][r],
                 amid[k2][r], alo[k2][r]);
        }
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        // B's tile is MN-major (N contiguous): a k-step is 16 step rows
        const uint64_t db =
            sw128_desc(sb(s) + (2 * wg + k2) * 16 * 128, kTile, 1024);
        wgmma_rs(st, ahi[k2], db);
        wgmma_rs(st, amid[k2], db);
        wgmma_rs(st, alo[k2], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(ahi);
      fence_regs(amid);
      fence_regs(alo);
      if (lane == 0) mbar_arrive(empty(s));
      load(t + kStages);
    }
  }
  store_state(p.state + bh);
}

// ---------------------------------------------------------------------------
// Pass 2: the outputs, one chunk per CTA, one query tile per warpgroup
// ---------------------------------------------------------------------------

// Shared memory of a chunk of tpc tiles, from a 1024-byte aligned base:
// C and B (two 64-column blocks a tile), x (one block a tile), the
// entering state as three bf16 terms (two blocks each), dt and acum, and
// one mbarrier a tile (its C, B and x).  Every tile is loaded once, at the
// start: nothing is refilled.
struct OutLayout {
  uint32_t c, b, x, s, dt, acum, bars, bytes;
  __host__ __device__ explicit OutLayout(int tpc) {
    c = 0;
    b = c + tpc * 2 * kTile;
    x = b + tpc * 2 * kTile;
    s = x + tpc * kTile;
    dt = s + 3 * 2 * kTile;
    acum = dt + 4 * kMaxChunk;
    bars = acum + 4 * kMaxChunk;
    bytes = bars + 8 * kMaxTiles + 1024;
  }
};

__global__ void __launch_bounds__(kMaxTiles * kThreads, 1)
ssd_wgmma_output_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tc,
                        const Params p) {
  const int tpc = p.l / kT;
  const OutLayout L(tpc);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* sDt = reinterpret_cast<float*>(gbase + L.dt);
  float* sAcum = reinterpret_cast<float*>(gbase + L.acum);
  const uint32_t sC = base + L.c, sB = base + L.b, sX = base + L.x;
  const uint32_t sS = base + L.s;
  auto bar = [&](int j) { return base + L.bars + 8 * j; };

  const int tid = threadIdx.x;
  const int it = tid / kThreads;         // this warpgroup's query tile
  const int warp = tid % kThreads / 32, lane = tid % 32;
  const int nc = p.S / p.l;
  const int h = blockIdx.x;
  const int b = blockIdx.y / nc;
  const int c = blockIdx.y % nc;
  const int c0 = c * p.l;

  if (tid == 0) {
    for (int j = 0; j < tpc; ++j) mbar_init(bar(j), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < tpc; ++j) {
      const int row = c0 + j * kT;
      mbar_expect_tx(bar(j), 5 * kTile);
      tma_load(sC + j * 2 * kTile, &tc, bar(j), 0, 0, row, b);
      tma_load(sC + j * 2 * kTile + kTile, &tc, bar(j), kCols, 0, row, b);
      tma_load(sB + j * 2 * kTile, &tb, bar(j), 0, 0, row, b);
      tma_load(sB + j * 2 * kTile + kTile, &tb, bar(j), kCols, 0, row, b);
      tma_load(sX + j * kTile, &tx, bar(j), 0, h, row, b);
    }
  }

  // the state entering the chunk as three bf16 terms, each K-major (P rows
  // of N) in two 64-column swizzled blocks, as a K tile of S = Q K^T is
  const float* s_in = p.states + (((long long)b * nc + c) * p.H + h) * kP * kN;
  for (int idx = tid; idx < kP * kN / 8; idx += blockDim.x) {
    const int row = idx / (kN / 8), g = idx % (kN / 8);
    const float4 v0 = __ldg(reinterpret_cast<const float4*>(
        s_in + row * kN + 8 * g));
    const float4 v1 = __ldg(reinterpret_cast<const float4*>(
        s_in + row * kN + 8 * g + 4));
    uint4 hi, mid, lo;
    split3(v0.x, v0.y, hi.x, mid.x, lo.x);
    split3(v0.z, v0.w, hi.y, mid.y, lo.y);
    split3(v1.x, v1.y, hi.z, mid.z, lo.z);
    split3(v1.z, v1.w, hi.w, mid.w, lo.w);
    const uint32_t off =
        (g / 8) * kTile + row * 128 + (((g % 8) ^ (row & 7)) << 4);
    *reinterpret_cast<uint4*>(gbase + L.s + off) = hi;
    *reinterpret_cast<uint4*>(gbase + L.s + 2 * kTile + off) = mid;
    *reinterpret_cast<uint4*>(gbase + L.s + 4 * kTile + off) = lo;
  }
  // the generic-proxy stores above are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  chunk_acum(p, b, h, c0, sDt, sAcum);

  // this thread's accumulator rows (steps of the chunk) i0 and i0 + 8,
  // columns 8 n + 2 q (+1)
  const int q = lane % 4;
  const int i0 = it * kT + warp * 16 + lane / 4;
  const uint32_t sCi = sC + it * 2 * kTile;
  auto desc_c = [&](int kk) {           // k-step kk of C_i (K = N = 128)
    return sw128_desc(sCi + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024);
  };

  auto issue_s = [&](float (&sc)[32], int jt) {   // S = C_i B_jt^T
    const uint32_t sBj = sB + jt * 2 * kTile;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss(sc, desc_c(kk),
               sw128_desc(sBj + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024),
               kk > 0);
  };
  auto issue_wx = [&](float (&y)[32], const uint32_t (&hi)[4][4],
                      const uint32_t (&mid)[4][4], const uint32_t (&lo)[4][4],
                      int jt) {                   // y += W x_jt
    const uint32_t sXj = sX + jt * kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // x's tile is MN-major (P contiguous): a k-step is 16 step rows
      const uint64_t dx = sw128_desc(sXj + kk * 16 * 128, kTile, 1024);
      wgmma_rs(y, hi[kk], dx);
      wgmma_rs(y, mid[kk], dx);
      wgmma_rs(y, lo[kk], dx);
    }
  };
  // W = S o exp(acum_i - acum_j) o dt_j on and below the diagonal (a
  // select: the exponent overflows above it), split in three; keys
  // 16 kk .. 16 kk + 15 of the accumulator fragment are the A fragment of
  // k-step kk
  const float a0 = sAcum[i0], a1 = sAcum[i0 + 8];
  auto weights = [&](float (&sc)[32], uint32_t (&hi)[4][4],
                     uint32_t (&mid)[4][4], uint32_t (&lo)[4][4], int jt) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1);
        const int j = jt * kT + 8 * n + 2 * q + (e & 1);
        const float ai = e >> 1 ? a1 : a0;
        sc[4 * n + e] = i >= j
            ? sc[4 * n + e] * exp_le0(ai - sAcum[j]) * sDt[j] : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r],
               mid[kk][r], lo[kk][r]);
  };

  // y_off = C s^T, issued with S of the first key tile
  float y[32], sc[32];
  uint32_t whi[4][4], wmid[4][4], wlo[4][4];
  mbar_wait(bar(it), 0);
  mbar_wait(bar(0), 0);
  __syncwarp();
  wgmma_fence();
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss(y, desc_c(kk),
               sw128_desc(sS + term * 2 * kTile + (kk / 4) * kTile
                          + (kk % 4) * 32, 16, 1024),
               term > 0 || kk > 0);
  issue_s(sc, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(y);
  fence_regs(sc);
  // y_off o exp(acum_i)
  const float e0 = expf(a0), e1 = expf(a1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    y[4 * n] *= e0;
    y[4 * n + 1] *= e0;
    y[4 * n + 2] *= e1;
    y[4 * n + 3] *= e1;
  }
  weights(sc, whi, wmid, wlo, 0);

  // y_diag over the key tiles on or below the diagonal.  W_j x_j and
  // S_{j+1} in turn: issued together they would need y, S and W's three
  // terms live at once, and ptxas serializes every wgmma when the
  // registers run short (its note C7512).  The last tile's W x is peeled
  // off the loop, so that no wgmma sits on a divergent path
  for (int jt = 0; jt < it; ++jt) {
    __syncwarp();
    wgmma_fence();
    issue_wx(y, whi, wmid, wlo, jt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    fence_regs(whi);
    fence_regs(wmid);
    fence_regs(wlo);
    mbar_wait(bar(jt + 1), 0);
    __syncwarp();
    wgmma_fence();
    issue_s(sc, jt + 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    weights(sc, whi, wmid, wlo, jt + 1);
  }
  __syncwarp();
  wgmma_fence();
  issue_wx(y, whi, wmid, wlo, it);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(y);
  fence_regs(whi);
  fence_regs(wmid);
  fence_regs(wlo);

  // y rows c0 + i of (B, S, H, P), fp32
  store_frag(p.y + (((long long)b * p.S + c0) * p.H + h) * kP, y, i0, 0,
             (long long)p.H * kP);
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem, void** args,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                         dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, Bm, Cm bf16; dt, A, init (may be null) fp32; y, state and the scratch
// `states` (Bsz * S / chunk * H * P * N floats) fp32; all contiguous.
extern "C" int ssd_scan_wgmma_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm,
                                  const void* init, void* y, void* state,
                                  void* states, int Bsz, int S, int H, int P,
                                  int N, int chunk, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P != kP || N != kN || chunk <= 0 ||
      chunk % kT != 0 || chunk > kMaxChunk || S % chunk != 0 ||
      Bsz > 65535 || H > 65535 || (long long)Bsz * (S / chunk) > 65535)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  CUtensorMap tx, tb, tc;
  CUresult r = make_map(encode, &tx, x, Bsz, S, H, kP, (long long)S * H * kP,
                        (long long)H * kP, kP, kT);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tb, Bm, Bsz, S, 1, kN, (long long)S * kN, kN, kN,
                 kT);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tc, Cm, Bsz, S, 1, kN, (long long)S * kN, kN, kN,
                 kT);
  if (r != CUDA_SUCCESS) return kErrTensorMap + (int)r;
  Params p{static_cast<const float*>(dt), static_cast<const float*>(A),
           static_cast<const float*>(init), static_cast<float*>(states),
           static_cast<float*>(state), static_cast<float*>(y), S, H, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* state_args[] = {&tx, &tb, &p};
  int err = launch(ssd_wgmma_state_kernel, dim3(kN / 64, H, Bsz),
                   kStateThreads, StateSmem::kBytes, state_args, s);
  if (err != 0) return err;
  void* out_args[] = {&tx, &tb, &tc, &p};
  return launch(ssd_wgmma_output_kernel, dim3(H, Bsz * (S / chunk)),
                chunk / kT * kThreads, OutLayout(chunk / kT).bytes, out_args,
                s);
}
