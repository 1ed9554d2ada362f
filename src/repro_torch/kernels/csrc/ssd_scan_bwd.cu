// The backward of the fused Mamba2 SSD chunk scan (ssd_scan_wgmma.cu) for
// bf16 x, B and C with head dim P = 64, state size N = 128 and chunks of
// 64..256 steps in steps of 64: the gradients of x, dt, A, B, C and the
// initial state from those of y and the final state, on the tensor cores
// (`mma.sync` m16n8k16, bf16 operands, fp32 accumulators).
//
// Replaces no TPU kernel: the reference trains through the jnp twin of its
// scan kernel (src/repro/kernels/ops.py), and its Pallas kernel has no
// VJP.  Without this kernel the port's backward recomputed the plain
// chunked scan in fp32 with grad enabled and differentiated that: (B, l, l,
// H) decay matrices a chunk, elementwise passes and fp32 GEMMs, 88.6 % of
// mamba2-370m's train step.  It computes the same gradient as that
// recompute (kernels/ssd_scan.py, ssd_scan_backward_plain, holds the
// arithmetic on the host).  Per (batch b, head h) and chunk c of l steps,
// with a = the inclusive cumsum of A dt inside the chunk, L[i,j] =
// exp(a_i - a_j) for i >= j (else 0), s_c the state entering the chunk
// (the forward kernel's scratch, kept for backward) and g_c the gradient
// of the state leaving it:
//
//   g_{c-1} = exp(a_last) g_c + sum_i exp(a_i) dy_i (x) C_i   (from dstate)
//   d(x dt)_j = sum_{i>=j} (C_i.B_j) L_ij dy_i + exp(a_last - a_j) g_c B_j
//   dCB_ij  = sum_h (dy_i.x_j) dt_j L_ij             (one B/C group)
//   dC_i    = sum_j dCB_ij B_j + sum_h exp(a_i) dy_i s_c
//   dB_j    = sum_i dCB_ij C_i + sum_h exp(a_last - a_j) dt_j x_j g_c
//   da_i    = rows and columns of (C B^T) o dCB_h, exp(a_i) dy_i.(C_i s^T),
//             the state's decays; ddt += A rcumsum(da), dA = sum dt rcumsum
//
// Precision.  A product of two bf16 values is exact in fp32.  An fp32
// operand is split into three bf16 terms as the forward kernel splits it
// (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)); a product
// of an fp32 and a bf16 operand runs once per term, one of two fp32
// operands on the six term pairs whose ranks sum to at most 2 (the three
// left out are below 2^-26 of the product), all into fp32 accumulators.
// a is summed and kept in float64, and each decay's argument (a_i - a_j,
// a_last - a_j) is formed there before it is rounded to fp32: from two
// fp32 cumsums it would carry their rounding at |a| (tens of nats at the
// end of a chunk), not at the difference's size: near zero, the
// gradients of x, B and C then missed the float64 function by up to 4e-5,
// up to five times what the plain fp32 path misses by.
// L is a select, not a product with a 0/1 mask, so the gradients stay
// finite where a chunk's decays span hundreds of nats; every other exp
// has a non-positive argument.
//
// Determinism.  No floating-point atomics: every sum across blocks (over
// heads for dB and dC through dCB, over query tiles for the decay
// gradients, over batch and chunks for dA) is a partial in scratch memory
// that a later kernel reduces in a fixed order, so two runs give the same
// bits.  Nothing is allocated here and nothing waits on the host: outputs
// and scratch come from the wrapper, all launches go to its stream (CUDA
// graphs capture them).
//
// What bounds it on an H100: at mamba2-370m's train step (B = 4, S = 2048,
// H = 32, l = 256) the gradient needs 31 GFLOP (0.031 ms at the bf16 peak)
// and about 187 MB of traffic (x, dy, the kept states, dt, A, B, C and
// dstate read; dx, ddt, dA, dB, dC and dinit written; its own scratch not
// counted, as the forward's bound counts none), so device memory bounds
// it: 0.056 ms at 3.35 TB/s.  The splits
// triple or sextuple the products with fp32 operands, and C B^T is formed
// again by each head: about 150 GFLOP on the tensor cores, fewer where the
// cotangent is bf16 (as the model's is: y is cast to bf16 after the scan)
// and its split terms past the first are exact zeros, which are skipped.
// Seven kernels, launched in turn, each parallel over (batch, chunk) and
// tiles of 64 steps or heads, so that the sequential part is an
// elementwise pass:
// 1. state_sum: per (b, c, h) sum_i exp(a_i) dy_i (x) C_i into the scratch
//    g; a (the cumsum every later kernel reads); s_c split into bf16 terms;
// 2. state_pass: the recurrence from the last chunk to the first, g_c split
//    into bf16 terms, <g_c, s_c>, and the initial state's gradient;
// 3. dx: per (b, c, h, key tile J) d(x dt)_J over the query tiles I >= J
//    and the state term, dx, and the state's decay terms of its rows;
// 4. dcb: per (b, c, tile pair J <= I) dCB_IJ over the heads, and the row
//    and column sums of (C B^T) o dCB_h that the decay gradient takes;
// 5. dbc: per (b, c, row tile, dB or dC, half of N) the head sums, each
//    head's product scaled by rows as it is added, then the dCB terms; for
//    dC also the rows' decay term exp(a_i) C_i . (dy_i s);
// 6. ddt: per (b, c, h) da, its reverse cumsum, ddt and dA's partial, in
//    float64 (dA's terms cancel to a few parts in a thousand of their size
//    where the decays span hundreds of nats);
// 7. da: dA, the partials summed in order.
// Operands are staged into shared memory as bf16 planes in their own
// layout, rows padded by 16 bytes: bf16 ones and kernels 1-2's split
// planes by `cp.async`, fp32 tiles loaded into registers first (their
// loads in flight with the step's copies) and split as they are stored;
// `ldmatrix` (transposing where the contraction runs down the rows) reads
// every fragment without bank conflicts.  Each loop over tiles or heads
// stages, then computes: where it is slow, it waits on those loads (the
// kernels keep a few CTAs an SM to cover them; PERF.md, row 3b).
//
// Layout (contiguous): x (B, S, H, P) bf16, dt (B, S, H) fp32, A (H,) fp32,
// Bm and Cm (B, S, N) bf16, states (B, nc, H, P, N) fp32, dy (B, S, H, P)
// fp32, dstate and dinit (B, H, P, N) fp32 (null: zero, not wanted);
// outputs dx (B, S, H, P) bf16, ddt (B, S, H) fp32, dA (H,) fp32, dB and dC
// (B, S, N) bf16.  Every base 16-byte aligned.
//
// Plain C interface (bound with ctypes).  The entry returns 0 or the
// cudaError_t of the first launch that failed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;                 // steps of a tile
constexpr int kP = 64;                 // head_dim
constexpr int kN = 128;                // d_state
constexpr int kMaxChunk = 256;
constexpr int kThreads = 128;          // four warps, 16 rows of a tile each
constexpr int kLdT = kT + 8;           // plane row of 64 bf16, padded
constexpr int kLdN = kN + 8;           // plane row of 128 bf16, padded
constexpr int kTermT = kT * kLdT;      // a 64-row plane of 64 columns
constexpr int kPassThreads = 256;
constexpr int kPassBlocks = kP * kN / (4 * kPassThreads);

using bf16 = __nv_bfloat16;

struct Params {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  const float* states;   // the state entering each chunk
  const float* dy;
  const float* dstate;   // nullptr: zero
  float* g;              // (B, nc, H, P, N): chunk sums of the state pass
  bf16* gpl;             // (B, nc, H, 3, P, N): g_c (leaving) as 3 terms
  bf16* spl;             // (B, nc, H, 3, P, N): s_c (entering) as 3 terms
  float* gs;             // (B, nc, H, kPassBlocks): parts of <g_c, s_c>
  double* acum;          // (B, nc, H, l): a, in float64
  float* dcb;            // (B, nc, l, l): dCB, tiles J <= I
  float* rs;             // (B, nc, H, T, l): row sums of tile J, [J][i]
  float* cs;             // (B, nc, H, T, l): column sums of tile I, [I][j]
  float* ddt_dir;        // (B, nc, H, l): d(x dt)_j . x_j
  float* da3;            // (B, nc, H, l): -u, the state's decay terms
  float* daoff;          // (B, nc, H, 2, l): exp(a_i) dy_i.(C_i s^T) by
                         // half of N
  float* last3;          // (B, nc, H, T): terms of a_last, by key tile
  double* dA_part;       // (B * nc, H)
  bf16* dx;
  float* ddt;
  float* dA;
  bf16* dB;
  bf16* dC;
  float* dinit;          // nullptr: not wanted
  int S, H, l;
};

// ---------------------------------------------------------------------------
// Arithmetic and fragments
// ---------------------------------------------------------------------------

// Inclusive prefix sum of a[0..n) in place (one warp; n <= 32 * 64), as
// the forward kernel computes a.
template <typename V>
__device__ void warp_cumsum(V* a, int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n);
  const int hi = min(lo + per, n);
  V tot = 0;
  for (int i = lo; i < hi; ++i) tot += a[i];
  V inc = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const V t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  V run = inc - tot;
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    a[i] = run;
  }
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// (v0, v1) = hi + mid + lo, three packed bf16 pairs, as the forward splits
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
}

// four values as three 4-wide bf16 terms, stored `term` elements apart;
// true where one needed more than its first term
__device__ __forceinline__ bool store_split4(bf16* dst, long long term,
                                             float4 v) {
  uint2 hi, mid, lo;
  split3(v.x, v.y, hi.x, mid.x, lo.x);
  split3(v.z, v.w, hi.y, mid.y, lo.y);
  *reinterpret_cast<uint2*>(dst) = hi;
  *reinterpret_cast<uint2*>(dst + term) = mid;
  *reinterpret_cast<uint2*>(dst + 2 * term) = lo;
  return (mid.x | mid.y | lo.x | lo.y) != 0u;
}

// exp(x) for the x <= 0 of the decay mask, as the forward kernel takes it:
// 2^(x log2 e) on the multi-function unit (relative error ~2^-22; flushes
// below 2^-126 to 0), with no branch
__device__ __forceinline__ float exp_le0(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

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

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// The A fragment of rows m0 .. m0 + 15 and contraction k0 .. k0 + 15 of a
// plane stored [m][k] (TRANS false) or [k][m] (TRANS true).
template <bool TRANS>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* p, int ld,
                                     int m0, int k0) {
  const int lane = lane_id();
  if (TRANS)
    ldsm4_t(a, p + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0
                   + 8 * ((lane >> 3) & 1));
  else
    ldsm4(a, p + (m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}

// The B fragments of columns n0 .. n0 + 15 (two tiles of 8: b[0], b[1] and
// b[2], b[3]) and contraction k0 .. k0 + 15 of a plane stored [n][k]
// (TRANS false) or [k][n] (TRANS true).
template <bool TRANS>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* p, int ld,
                                     int n0, int k0) {
  const int lane = lane_id();
  if (TRANS)
    ldsm4_t(b, p + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0
                   + 8 * (lane >> 4));
  else
    ldsm4(b, p + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0
                 + 8 * ((lane >> 3) & 1));
}

// This warp's 16 rows from m0 of acc (NT tiles of 8 columns) += A B over
// K from ak0 (A) and bk0 (B): A of TA terms (planes `as` elements apart),
// B of TB terms (`bs` apart), on the term pairs whose ranks sum to at
// most 2, smallest first.  `mma.sync` and `ldmatrix` must run on a
// converged warp: code before them may branch per lane (expf does), so
// the warp reconverges first.
template <int NT, int TA, int TB, int K, bool AT, bool BT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const bf16* a,
                                          int lda, int as, int m0, int ak0,
                                          const bf16* b, int ldb, int bs,
                                          int bk0) {
  __syncwarp();
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[TA][4];
#pragma unroll
    for (int ta = 0; ta < TA; ++ta)
      ld_a<AT>(af[ta], a + ta * as, lda, m0, ak0 + k0);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[TB][4];
#pragma unroll
      for (int tb = 0; tb < TB; ++tb)
        ld_b<BT>(bfr[tb], b + tb * bs, ldb, 16 * np, bk0 + k0);
#pragma unroll
      for (int s = 2; s >= 0; --s)
#pragma unroll
        for (int ta = 0; ta < TA; ++ta)
#pragma unroll
          for (int tb = 0; tb < TB; ++tb)
            if (ta + tb == s) {
              mma(acc[2 * np], af[ta], bfr[tb][0], bfr[tb][1]);
              mma(acc[2 * np + 1], af[ta], bfr[tb][2], bfr[tb][3]);
            }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Sum over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the block in a fixed order; every thread gets it.  `red` holds
// blockDim.x / 32 floats; barriers on both sides.
template <typename V>
__device__ V block_sum(V v, V* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  V s = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// Staging into shared-memory planes (row stride ld bf16)
// ---------------------------------------------------------------------------

// plane[r][c] = src[r * sld + c], rows x cols bf16 (cols a multiple of 8),
// by 16-byte `cp.async` copies.  A staging step issues its copies back to
// back and then waits for them (copy_wait), with nothing in between, and a
// barrier follows before another thread reads them.  Where copies stayed in
// flight across other staging and a barrier, the dx kernel's gradients
// changed from run to run once three CTAs shared an SM (never with one an
// SM), so none does.
__device__ void copy_async(bf16* dst, int ld, const bf16* src, long long sld,
                           int rows, int cols) {
  const int vec = cols / 8;
  for (int idx = threadIdx.x; idx < rows * vec; idx += blockDim.x) {
    const int r = idx / vec, v = idx % vec;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst + r * ld + 8 * v)),
                    "l"(src + r * sld + 8 * v) : "memory");
  }
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ void stage_copy(bf16* dst, int ld, const bf16* src, long long sld,
                           int rows, int cols) {
  copy_async(dst, ld, src, sld, rows, cols);
  copy_wait();
}

// A 64 x 64 fp32 tile in registers, 8 float4 a thread of kThreads:
// load_tile(v, get4) takes columns c .. c + 3 of row r from get4(r, c),
// store_tile splits them into three planes (`term` elements apart) and ends
// in a barrier, so that the tile's loads can be in flight with a step's
// copies.  It returns, the same on every thread, whether any value needed
// more than its first term: where none did (a cotangent that was bf16, as
// the model's is), the products of the other two terms are exact zeros,
// and the callers skip them.
constexpr int kTileVec = kT * kT / 4 / kThreads;

template <class F>
__device__ __forceinline__ void load_tile(float4 (&v)[kTileVec], F get4) {
#pragma unroll
  for (int k = 0; k < kTileVec; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    v[k] = get4(idx / (kT / 4), 4 * (idx % (kT / 4)));
  }
}

__device__ __forceinline__ bool store_tile(bf16* dst, int ld, int term,
                                           const float4 (&v)[kTileVec]) {
  bool rest = false;
#pragma unroll
  for (int k = 0; k < kTileVec; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    rest |= store_split4(dst + (idx / (kT / 4)) * ld + 4 * (idx % (kT / 4)),
                         term, v[k]);
  }
  return __syncthreads_or(rest) != 0;
}

__device__ __forceinline__ long long bch_index(int b, int c, int h, int nc,
                                               int H) {
  return ((long long)b * nc + c) * H + h;
}

// ---------------------------------------------------------------------------
// 1. state_sum: per (b, c, h) sum_i exp(a_i) dy_i (x) C_i, a, s_c's terms
// ---------------------------------------------------------------------------

struct SumSmem {
  static constexpr int kAcum = 0;
  static constexpr int kE = kAcum + 8 * kMaxChunk;
  static constexpr int kDy = kE + 4 * kMaxChunk;               // 3 x [i][q]
  static constexpr int kC = kDy + 3 * kTermT * 2;              // [i][n]
  static constexpr int kBytes = kC + kT * kLdN * 2;
};

__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_sum_kernel(const Params p) {
  using L = SumSmem;
  extern __shared__ __align__(16) uint8_t smem[];
  double* sAcum = reinterpret_cast<double*>(smem + L::kAcum);
  float* sE = reinterpret_cast<float*>(smem + L::kE);
  bf16* sDy = reinterpret_cast<bf16*>(smem + L::kDy);
  bf16* sC = reinterpret_cast<bf16*>(smem + L::kC);
  const int nc = p.S / p.l;
  const int h = blockIdx.x, b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int c0 = c * p.l, w = threadIdx.x / 32;
  const long long bch = bch_index(b, c, h, nc, p.H);
  const long long HP = (long long)p.H * kP;

  const double A = p.A[h];
  for (int j = threadIdx.x; j < p.l; j += blockDim.x)
    sAcum[j] = A * p.dt[((long long)b * p.S + c0 + j) * p.H + h];
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(sAcum, p.l);
  __syncthreads();
  for (int j = threadIdx.x; j < p.l; j += blockDim.x) {
    p.acum[bch * p.l + j] = sAcum[j];
    sE[j] = expf((float)sAcum[j]);
  }
  // s_c as three bf16 terms, for kernels 3 and 5
  const float4* st = reinterpret_cast<const float4*>(p.states
                                                     + bch * kP * kN);
  for (int e = threadIdx.x; e < kP * kN / 4; e += blockDim.x)
    store_split4(p.spl + bch * 3 * kP * kN + 4 * e, kP * kN, __ldg(st + e));

  float acc[16][4];
  zero(acc);
  for (int t = 0; t < p.l / kT; ++t) {
    const long long i0 = (long long)b * p.S + c0 + t * kT;
    const float* dyt = p.dy + i0 * HP + h * kP;
    const float* et = sE + t * kT;
    float4 v[kTileVec];
    load_tile(v, [&](int i, int q) {
      float4 u = __ldg(reinterpret_cast<const float4*>(dyt + i * HP + q));
      const float e = et[i];
      return make_float4(u.x * e, u.y * e, u.z * e, u.w * e);
    });
    __syncthreads();
    stage_copy(sC, kLdN, p.Cm + i0 * kN, kN, kT, kN);
    store_tile(sDy, kLdT, kTermT, v);
    // rows q of (dy o e)^T, stored [i][q]; B = C stored [i][n]
    warp_gemm<16, 3, 1, kT, true, true>(acc, sDy, kLdT, kTermT, 16 * w, 0,
                                        sC, kLdN, 0, 0);
  }
  float* out = p.g + bch * kP * kN;
  const int r = 16 * w + lane_g();
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = 8 * nt + 2 * lane_t();
    *reinterpret_cast<float2*>(out + r * kN + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (r + 8) * kN + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. state_pass: g_{c-1} = exp(a_last,c) g_c + sum_c, g_c's terms, <g, s>
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_pass_kernel(const Params p) {
  __shared__ float sRed[kPassThreads / 32];
  const int nc = p.S / p.l;
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.dstate)
    carry = *reinterpret_cast<const float4*>(
        p.dstate + ((long long)b * p.H + h) * kP * kN + e);
  for (int c = nc - 1; c >= 0; --c) {
    const long long bch = bch_index(b, c, h, nc, p.H);
    const float4 d = *reinterpret_cast<const float4*>(p.g + bch * kP * kN
                                                      + e);
    const float4 s = *reinterpret_cast<const float4*>(p.states
                                                      + bch * kP * kN + e);
    store_split4(p.gpl + bch * 3 * kP * kN + e, kP * kN, carry);
    const float gs = block_sum(carry.x * s.x + carry.y * s.y
                               + carry.z * s.z + carry.w * s.w, sRed);
    if (threadIdx.x == 0) p.gs[bch * kPassBlocks + blockIdx.x] = gs;
    const float dec = expf((float)p.acum[bch * p.l + p.l - 1]);
    carry = make_float4(dec * carry.x + d.x, dec * carry.y + d.y,
                        dec * carry.z + d.z, dec * carry.w + d.w);
  }
  if (p.dinit)
    *reinterpret_cast<float4*>(p.dinit + ((long long)b * p.H + h) * kP * kN
                               + e) = carry;
}

// ---------------------------------------------------------------------------
// 3. dx: per (b, c, h, key tile J)
// ---------------------------------------------------------------------------

// part (16 rows j of this warp, 64 columns q) += W^T dy_I over the tile's
// 64 steps i: W^T from the accumulator fragments st (rows j, columns i),
// split in three in registers; dy_I from its TB planes, stored [i][q]
template <int TB>
__device__ __forceinline__ void wt_dy(float (&part)[8][4],
                                      const float (&st)[8][4],
                                      const bf16* sDy) {
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t w3[3][4];
    split3(st[2 * kk][0], st[2 * kk][1], w3[0][0], w3[1][0], w3[2][0]);
    split3(st[2 * kk][2], st[2 * kk][3], w3[0][1], w3[1][1], w3[2][1]);
    split3(st[2 * kk + 1][0], st[2 * kk + 1][1], w3[0][2], w3[1][2],
           w3[2][2]);
    split3(st[2 * kk + 1][2], st[2 * kk + 1][3], w3[0][3], w3[1][3],
           w3[2][3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b3[TB][4];
#pragma unroll
      for (int term = 0; term < TB; ++term)
        ld_b<true>(b3[term], sDy + term * kTermT, kLdT, 16 * np, 16 * kk);
#pragma unroll
      for (int s = 2; s >= 0; --s)
#pragma unroll
        for (int ta = 0; ta < 3; ++ta)
#pragma unroll
          for (int tb = 0; tb < TB; ++tb)
            if (ta + tb == s) {
              mma(part[2 * np], w3[ta], b3[tb][0], b3[tb][1]);
              mma(part[2 * np + 1], w3[ta], b3[tb][2], b3[tb][3]);
            }
    }
  }
}

// Shared memory: a and dt of the chunk, a reduction buffer, B_J; then
// either g's three planes (the state term) or C_I and dy_I's three planes
// (the query tiles).
struct DxSmem {
  static constexpr int kAcum = 0;
  static constexpr int kDt = kAcum + 8 * kMaxChunk;
  static constexpr int kRed = kDt + 4 * kMaxChunk;
  static constexpr int kBJ = kRed + 4 * 64;                    // [j][n]
  static constexpr int kRegion = kBJ + kT * kLdN * 2;
  static constexpr int kG = kRegion;                           // 3 x [q][n]
  static constexpr int kCI = kRegion;                          // [i][n]
  static constexpr int kDy = kCI + kT * kLdN * 2;              // 3 x [i][q]
  static constexpr int kBytes = kG + 3 * kP * kLdN * 2;
};

// Three CTAs an SM (168 registers, a 32-byte spill) ran it in 0.225 ms at
// the train step's shape against 0.250 ms for two at 246 registers.
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_dx_kernel(const Params p) {
  using L = DxSmem;
  extern __shared__ __align__(16) uint8_t smem[];
  double* sAcum = reinterpret_cast<double*>(smem + L::kAcum);
  float* sDt = reinterpret_cast<float*>(smem + L::kDt);
  float* sRed = reinterpret_cast<float*>(smem + L::kRed);
  bf16* sBJ = reinterpret_cast<bf16*>(smem + L::kBJ);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::kG);
  bf16* sCI = reinterpret_cast<bf16*>(smem + L::kCI);
  bf16* sDy = reinterpret_cast<bf16*>(smem + L::kDy);
  const int nc = p.S / p.l, T = p.l / kT;
  const int J = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * p.l, w = threadIdx.x / 32;
  const int g = lane_g(), t = lane_t();
  const long long bch = bch_index(b, c, h, nc, p.H);
  const long long HP = (long long)p.H * kP;

  for (int j = threadIdx.x; j < p.l; j += blockDim.x) {
    sAcum[j] = p.acum[bch * p.l + j];
    sDt[j] = p.dt[((long long)b * p.S + c0 + j) * p.H + h];
  }
  const long long rowJ = (long long)b * p.S + c0 + J * kT;   // step of row 0
  copy_async(sBJ, kLdN, p.Bm + rowJ * kN, kN, kT, kN);
  for (int term = 0; term < 3; ++term)
    copy_async(sG + term * kP * kLdN, kLdN,
               p.gpl + (bch * 3 + term) * kP * kN, kN, kP, kN);
  copy_wait();
  __syncthreads();

  // this thread's rows of the tile, as chunk steps
  const int jl0 = J * kT + 16 * w + g, jl1 = jl0 + 8;
  const double alast = sAcum[p.l - 1];
  const float dt0 = sDt[jl0], dt1 = sDt[jl1];
  const bf16* x0 = p.x + (rowJ + 16 * w + g) * HP + h * kP;
  const bf16* x1 = x0 + 8 * HP;

  // the state term: v = exp(a_last - a_j) B_j g^T (g stored [q][n]), which
  // starts d(x dt)
  float dxdt[8][4];
  zero(dxdt);
  warp_gemm<8, 1, 3, kN, false, false>(dxdt, sBJ, kLdN, 0, 16 * w, 0, sG,
                                       kLdN, kP * kLdN, 0);
  const float f0 = expf((float)(alast - sAcum[jl0]));
  const float f1 = expf((float)(alast - sAcum[jl1]));
  float u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int q = 8 * nt + 2 * t;
    dxdt[nt][0] *= f0;
    dxdt[nt][1] *= f0;
    dxdt[nt][2] *= f1;
    dxdt[nt][3] *= f1;
    const float2 xa = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x0 + q));
    const float2 xb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x1 + q));
    u0 += xa.x * dxdt[nt][0] + xa.y * dxdt[nt][1];
    u1 += xb.x * dxdt[nt][2] + xb.y * dxdt[nt][3];
  }
  u0 = dt0 * quad_sum(u0);
  u1 = dt1 * quad_sum(u1);
  // a_last's terms from this tile's rows
  const float last = block_sum(t == 0 ? u0 + u1 : 0.f, sRed);

  // the query tiles I >= J: d(x dt)_J += W_IJ^T dy_I, W = (C_I B_J^T) o L
  for (int I = J; I < T; ++I) {
    const long long rowI = (long long)b * p.S + c0 + I * kT;
    const float* dyI = p.dy + rowI * HP + h * kP;
    float4 v[kTileVec];
    load_tile(v, [&](int i, int q) {
      return __ldg(reinterpret_cast<const float4*>(dyI + i * HP + q));
    });
    __syncthreads();
    stage_copy(sCI, kLdN, p.Cm + rowI * kN, kN, kT, kN);
    const bool dy3 = store_tile(sDy, kLdT, kTermT, v);
    float st[8][4];                 // (j, i): C_i . B_j
    zero(st);
    warp_gemm<8, 1, 1, kN, false, false>(st, sBJ, kLdN, 0, 16 * w, 0, sCI,
                                         kLdN, 0, 0);
    const double a0 = sAcum[jl0], a1 = sAcum[jl1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = e >> 1 ? jl1 : jl0;
        const int il = I * kT + 8 * nt + 2 * t + (e & 1);
        // a select, not a 0/1 mask: exp(a_i - a_j) overflows for i < j
        st[nt][e] = il >= jl
            ? st[nt][e] * exp_le0((float)(sAcum[il] - (e >> 1 ? a1 : a0)))
            : 0.f;
      }
    // this tile's part in an accumulator of its own, added to d(x dt) in
    // round-to-nearest: the tensor cores' fp32 accumulation truncates,
    // and a long chain of products into one accumulator would carry that
    // bias
    float part[8][4];
    zero(part);
    if (dy3)
      wt_dy<3>(part, st, sDy);
    else
      wt_dy<1>(part, st, sDy);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxdt[nt][e] += part[nt][e];
  }

  // dx = d(x dt) dt (bf16), d(x dt) . x, and the rows' decay terms
  bf16* dx0 = p.dx + (rowJ + 16 * w + g) * HP + h * kP;
  bf16* dx1 = dx0 + 8 * HP;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int q = 8 * nt + 2 * t;
    *reinterpret_cast<uint32_t*>(dx0 + q) =
        pack_bf16(dxdt[nt][0] * dt0, dxdt[nt][1] * dt0);
    *reinterpret_cast<uint32_t*>(dx1 + q) =
        pack_bf16(dxdt[nt][2] * dt1, dxdt[nt][3] * dt1);
    const float2 xa = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x0 + q));
    const float2 xb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x1 + q));
    r0 += xa.x * dxdt[nt][0] + xa.y * dxdt[nt][1];
    r1 += xb.x * dxdt[nt][2] + xb.y * dxdt[nt][3];
  }
  r0 = quad_sum(r0);
  r1 = quad_sum(r1);
  if (t == 0) {
    p.ddt_dir[bch * p.l + jl0] = r0;
    p.ddt_dir[bch * p.l + jl1] = r1;
    p.da3[bch * p.l + jl0] = -u0;
    p.da3[bch * p.l + jl1] = -u1;
  }
  if (threadIdx.x == 0) p.last3[bch * T + J] = last;
}

// ---------------------------------------------------------------------------
// 4. dcb: per (b, c, tile pair J <= I), over the heads
// ---------------------------------------------------------------------------

// Shared memory: a, dt, the column sums; then C_I and B_J, which the
// heads' dy_I (three planes) and x_J replace once S = C_I B_J^T is in
// registers.
struct DcbSmem {
  static constexpr int kAI = 0;
  static constexpr int kAJ = kAI + 8 * kT;
  static constexpr int kDtJ = kAJ + 8 * kT;
  static constexpr int kCol = kDtJ + 4 * kT;                   // [warp][j]
  static constexpr int kCI = kCol + 4 * 4 * kT;                // [i][n]
  static constexpr int kBJ = kCI + kT * kLdN * 2;              // [j][n]
  static constexpr int kDy = kCI;                              // 3 x [i][q]
  static constexpr int kX = kDy + 3 * kTermT * 2;              // [j][q]
  static constexpr int kBytes = kX + kTermT * 2;
};

// Three CTAs an SM (168 registers, a 20-byte spill): 0.152 ms at the train
// step's shape, against 0.238 ms for two (198 registers) and 0.190 ms for
// four (128 registers, a 144-byte spill).
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_dcb_kernel(const Params p) {
  using L = DcbSmem;
  extern __shared__ __align__(16) uint8_t smem[];
  double* sAI = reinterpret_cast<double*>(smem + L::kAI);
  double* sAJ = reinterpret_cast<double*>(smem + L::kAJ);
  float* sDtJ = reinterpret_cast<float*>(smem + L::kDtJ);
  float* sCol = reinterpret_cast<float*>(smem + L::kCol);
  bf16* sCI = reinterpret_cast<bf16*>(smem + L::kCI);
  bf16* sBJ = reinterpret_cast<bf16*>(smem + L::kBJ);
  bf16* sDy = reinterpret_cast<bf16*>(smem + L::kDy);
  bf16* sX = reinterpret_cast<bf16*>(smem + L::kX);
  const int nc = p.S / p.l, T = p.l / kT;
  int I = 0, J = blockIdx.x;                 // pair blockIdx.x: J <= I
  while (J > I) J -= ++I;
  const int b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int c0 = c * p.l, w = threadIdx.x / 32;
  const int g = lane_g(), t = lane_t();
  const long long HP = (long long)p.H * kP;
  const long long rowI = (long long)b * p.S + c0 + I * kT;
  const long long rowJ = (long long)b * p.S + c0 + J * kT;

  copy_async(sCI, kLdN, p.Cm + rowI * kN, kN, kT, kN);
  copy_async(sBJ, kLdN, p.Bm + rowJ * kN, kN, kT, kN);
  copy_wait();
  __syncthreads();
  float sc[8][4];                  // (i, j): C_i . B_j
  zero(sc);
  warp_gemm<8, 1, 1, kN, false, false>(sc, sCI, kLdN, 0, 16 * w, 0, sBJ,
                                       kLdN, 0, 0);
  float d[8][4];
  zero(d);
  const int il0 = 16 * w + g;      // rows of the tile
  for (int h = 0; h < p.H; ++h) {
    const long long bch = bch_index(b, c, h, nc, p.H);
    const float* dyI = p.dy + rowI * HP + h * kP;
    float4 v[kTileVec];
    load_tile(v, [&](int i, int q) {
      return __ldg(reinterpret_cast<const float4*>(dyI + i * HP + q));
    });
    __syncthreads();
    stage_copy(sX, kLdT, p.x + rowJ * HP + h * kP, HP, kT, kP);
    if (threadIdx.x < kT) {
      sAI[threadIdx.x] = p.acum[bch * p.l + I * kT + threadIdx.x];
      sAJ[threadIdx.x] = p.acum[bch * p.l + J * kT + threadIdx.x];
      sDtJ[threadIdx.x] = p.dt[(rowJ + threadIdx.x) * p.H + h];
    }
    const bool dy3 = store_tile(sDy, kLdT, kTermT, v);
    float q[8][4];                 // (i, j): dy_i . x_j
    zero(q);
    if (dy3)
      warp_gemm<8, 3, 1, kP, false, false>(q, sDy, kLdT, kTermT, 16 * w, 0,
                                           sX, kLdT, 0, 0);
    else
      warp_gemm<8, 1, 1, kP, false, false>(q, sDy, kLdT, kTermT, 16 * w, 0,
                                           sX, kLdT, 0, 0);
    float row0 = 0.f, row1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float col[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = il0 + 8 * (e >> 1);
        const int jl = 8 * nt + 2 * t + (e & 1);
        const bool lower = I > J || il >= jl;
        const float m = lower
            ? q[nt][e] * sDtJ[jl] * exp_le0((float)(sAI[il] - sAJ[jl]))
            : 0.f;
        d[nt][e] += m;
        // the diagonal's term enters a_i's gradient by its row and by its
        // column, with opposite signs: left out of both, exactly
        const float tv = I == J && il == jl ? 0.f : sc[nt][e] * m;
        if (e >> 1) row1 += tv; else row0 += tv;
        if (e >> 1) col[e & 1] += tv; else col[e & 1] = tv;
      }
      // the column sums of this warp's 16 rows: over the 8 row groups
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = col[e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) sCol[w * kT + 8 * nt + 2 * t + e] = v;
      }
    }
    row0 = quad_sum(row0);
    row1 = quad_sum(row1);
    if (t == 0) {
      p.rs[(bch * T + J) * p.l + I * kT + il0] = row0;
      p.rs[(bch * T + J) * p.l + I * kT + il0 + 8] = row1;
    }
    __syncthreads();
    if (threadIdx.x < kT)
      p.cs[(bch * T + I) * p.l + J * kT + threadIdx.x] =
          sCol[threadIdx.x] + sCol[kT + threadIdx.x]
          + sCol[2 * kT + threadIdx.x] + sCol[3 * kT + threadIdx.x];
  }
  float* out = p.dcb + ((long long)blockIdx.y * p.l + I * kT) * p.l + J * kT;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(out + (long long)il0 * p.l + col) =
        make_float2(d[nt][0], d[nt][1]);
    *reinterpret_cast<float2*>(out + (long long)(il0 + 8) * p.l + col) =
        make_float2(d[nt][2], d[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// 5. dbc: per (b, c, row tile R, half of N), dC (blockIdx.y 0, 1) or dB
// (2, 3)
// ---------------------------------------------------------------------------

struct DbcSmem {
  static constexpr int kRow = 0;
  static constexpr int kA = kRow + 4 * kT;                     // 3 x [r][k]
  static constexpr int kB = kA + 3 * kTermT * 2;               // 3 x [k][n]
  static constexpr int kBytes = kB + 3 * kTermT * 2;
};

__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc_kernel(const Params p) {
  using L = DbcSmem;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sRow = reinterpret_cast<float*>(smem + L::kRow);
  bf16* sA = reinterpret_cast<bf16*>(smem + L::kA);
  bf16* sB = reinterpret_cast<bf16*>(smem + L::kB);
  const int nc = p.S / p.l, T = p.l / kT;
  const int R = blockIdx.x;
  const bool is_db = blockIdx.y >= 2;
  const int n0 = (blockIdx.y & 1) * kT;      // this CTA's columns of N
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int c0 = c * p.l, w = threadIdx.x / 32;
  const long long HP = (long long)p.H * kP;
  const long long rowR = (long long)b * p.S + c0 + R * kT;

  float acc[8][4];
  zero(acc);
  // sum over heads of exp(a_i) (dy_i s), or of dt_j exp(a_last - a_j)
  // (x_j g), a head at a time: each head's product in an accumulator of
  // its own (as the dx kernel's tiles), its rows scaled as it is added, so
  // that x (bf16) and a bf16 cotangent enter the products as one term.
  // For dC the head's dy_i s also gives a_i's off-diagonal decay term,
  // exp(a_i) C_i . (dy_i s), over this CTA's half of N.
  const int r0 = 16 * w + lane_g();
  __nv_bfloat162 cr[8][2];         // C at this thread's accumulator places
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      cr[nt][hh] = is_db ? __floats2bfloat162_rn(0.f, 0.f)
          : *reinterpret_cast<const __nv_bfloat162*>(
                p.Cm + (rowR + r0 + 8 * hh) * kN + n0 + 8 * nt
                + 2 * lane_t());
  for (int h = 0; h < p.H; ++h) {
    const long long bch = bch_index(b, c, h, nc, p.H);
    const double* ac = p.acum + bch * p.l;
    const float* dyr = p.dy + rowR * HP + h * kP;
    float4 v[kTileVec];
    if (!is_db)
      load_tile(v, [&](int i, int q) {
        return __ldg(reinterpret_cast<const float4*>(dyr + i * HP + q));
      });
    __syncthreads();
    const bf16* planes = (is_db ? p.gpl : p.spl) + bch * 3 * kP * kN + n0;
    for (int term = 0; term < 3; ++term)
      copy_async(sB + term * kTermT, kLdT, planes + term * kP * kN, kN, kP,
                 kT);
    if (is_db) copy_async(sA, kLdT, p.x + rowR * HP + h * kP, HP, kT, kP);
    copy_wait();
    if (threadIdx.x < kT) {
      const int r = R * kT + threadIdx.x;
      sRow[threadIdx.x] = is_db
          ? p.dt[(rowR + threadIdx.x) * p.H + h]
                * expf((float)(ac[p.l - 1] - ac[r]))
          : expf((float)ac[r]);
    }
    bool a3 = false;
    if (is_db)
      __syncthreads();
    else
      a3 = store_tile(sA, kLdT, kTermT, v);
    // B = the state's planes, stored [q][n]: k rows
    float part[8][4];
    zero(part);
    if (a3)
      warp_gemm<8, 3, 3, kP, false, true>(part, sA, kLdT, kTermT, 16 * w,
                                          0, sB, kLdT, kTermT, 0);
    else
      warp_gemm<8, 1, 3, kP, false, true>(part, sA, kLdT, kTermT, 16 * w,
                                          0, sB, kLdT, kTermT, 0);
    const float f0 = sRow[r0], f1 = sRow[r0 + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] += f0 * part[nt][0];
      acc[nt][1] += f0 * part[nt][1];
      acc[nt][2] += f1 * part[nt][2];
      acc[nt][3] += f1 * part[nt][3];
    }
    if (!is_db) {
      float o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 c0 = __bfloat1622float2(cr[nt][0]);
        const float2 c1 = __bfloat1622float2(cr[nt][1]);
        o0 += c0.x * part[nt][0] + c0.y * part[nt][1];
        o1 += c1.x * part[nt][2] + c1.y * part[nt][3];
      }
      o0 = f0 * quad_sum(o0);
      o1 = f1 * quad_sum(o1);
      if (lane_t() == 0) {
        float* out = p.daoff + (bch * 2 + n0 / kT) * p.l + R * kT + r0;
        out[0] = o0;
        out[8] = o1;
      }
    }
  }
  // the dCB terms: dC_R += dCB_RK B_K (K <= R), dB_R += dCB_KR^T C_K
  // (K >= R)
  const float* dcb = p.dcb + (long long)blockIdx.z * p.l * p.l;
  for (int K = is_db ? R : 0; K < (is_db ? T : R + 1); ++K) {
    const long long rowK = (long long)b * p.S + c0 + K * kT;
    const float* blk = is_db ? dcb + (long long)K * kT * p.l + R * kT
                             : dcb + (long long)R * kT * p.l + K * kT;
    float4 v[kTileVec];
    load_tile(v, [&](int r, int cc) {
      return __ldg(reinterpret_cast<const float4*>(blk + (long long)r * p.l
                                                   + cc));
    });
    __syncthreads();
    stage_copy(sB, kLdT, (is_db ? p.Cm : p.Bm) + rowK * kN + n0, kN, kT,
               kT);
    store_tile(sA, kLdT, kTermT, v);
    // dC: A = dCB_RK stored [i][j]; dB: A = dCB_KR^T, stored [i][j] = k
    // rows; B = B_K or C_K stored [k][n]
    if (is_db)
      warp_gemm<8, 3, 1, kT, true, true>(acc, sA, kLdT, kTermT, 16 * w, 0,
                                         sB, kLdT, 0, 0);
    else
      warp_gemm<8, 3, 1, kT, false, true>(acc, sA, kLdT, kTermT, 16 * w, 0,
                                          sB, kLdT, 0, 0);
  }
  bf16* out = (is_db ? p.dB : p.dC) + rowR * kN + n0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * lane_t();
    *reinterpret_cast<uint32_t*>(out + r0 * kN + col) =
        pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(out + (r0 + 8) * kN + col) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// 6. ddt: per (b, c, h); 7. da: dA
// ---------------------------------------------------------------------------

constexpr int kDdtThreads = kMaxChunk;

// The decay gradient's reverse cumsum and dA's sums in float64: dA sums
// dt r over the sequence, and where the decays span hundreds of nats its
// terms cancel to a few parts in a thousand of their size.
__global__ void __launch_bounds__(kDdtThreads)
ssd_bwd_ddt_kernel(const Params p) {
  __shared__ double sR[kMaxChunk];
  __shared__ double sRed[kDdtThreads / 32];
  const int nc = p.S / p.l, T = p.l / kT;
  const int h = blockIdx.x, b = blockIdx.y / nc, c = blockIdx.y % nc;
  const long long bch = bch_index(b, c, h, nc, p.H);
  const int i = threadIdx.x;
  if (i < p.l) {
    const int ti = i / kT;
    double da = p.da3[bch * p.l + i];
    da += p.daoff[(bch * 2) * p.l + i];
    da += p.daoff[(bch * 2 + 1) * p.l + i];
    for (int J = 0; J <= ti; ++J) da += p.rs[(bch * T + J) * p.l + i];
    for (int I = ti; I < T; ++I) da -= p.cs[(bch * T + I) * p.l + i];
    if (i == p.l - 1) {
      double gs = 0.0;
      for (int k = 0; k < kPassBlocks; ++k) gs += p.gs[bch * kPassBlocks + k];
      da += exp(p.acum[bch * p.l + i]) * gs;
      for (int J = 0; J < T; ++J) da += p.last3[bch * T + J];
    }
    sR[p.l - 1 - i] = da;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(sR, p.l);
  __syncthreads();
  double part = 0.0;
  if (i < p.l) {
    const double r = sR[p.l - 1 - i];            // sum_{k >= i} da_k
    const long long at = ((long long)b * p.S + c * p.l + i) * p.H + h;
    p.ddt[at] = (float)(p.ddt_dir[bch * p.l + i] + (double)p.A[h] * r);
    part = (double)p.dt[at] * r;
  }
  const double tot = block_sum(part, sRed);
  if (threadIdx.x == 0) p.dA_part[(long long)blockIdx.y * p.H + h] = tot;
}

__global__ void ssd_bwd_da_kernel(const Params p, int parts) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.H) return;
  double s = 0.0;
  for (int k = 0; k < parts; ++k) s += p.dA_part[(long long)k * p.H + h];
  p.dA[h] = (float)s;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers as the Params fields are named; dstate and dinit may be null.
extern "C" int ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* states, const void* dy, const void* dstate,
    void* g, void* gpl, void* spl, void* gs, void* acum, void* dcb, void* rs,
    void* cs, void* ddt_dir, void* da3, void* daoff, void* last3,
    void* dA_part, void* dx,
    void* ddt, void* dA, void* dB, void* dC, void* dinit, int Bsz, int S,
    int H, int P, int N, int chunk, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P != kP || N != kN || chunk <= 0 ||
      chunk % kT != 0 || chunk > kMaxChunk || S % chunk != 0 ||
      H > 65535 || (long long)Bsz * (S / chunk) > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const bf16*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const bf16*>(Bm),
           static_cast<const bf16*>(Cm), static_cast<const float*>(states),
           static_cast<const float*>(dy), static_cast<const float*>(dstate),
           static_cast<float*>(g), static_cast<bf16*>(gpl),
           static_cast<bf16*>(spl), static_cast<float*>(gs),
           static_cast<double*>(acum), static_cast<float*>(dcb),
           static_cast<float*>(rs), static_cast<float*>(cs),
           static_cast<float*>(ddt_dir), static_cast<float*>(da3),
           static_cast<float*>(daoff),
           static_cast<float*>(last3), static_cast<double*>(dA_part),
           static_cast<bf16*>(dx), static_cast<float*>(ddt),
           static_cast<float*>(dA), static_cast<bf16*>(dB),
           static_cast<bf16*>(dC), static_cast<float*>(dinit), S, H, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = S / chunk, T = chunk / kT, bc = Bsz * nc;
  int err = launch(ssd_bwd_state_sum_kernel, dim3(H, bc), kThreads,
                   SumSmem::kBytes, s, p);
  if (err == 0)
    err = launch(ssd_bwd_state_pass_kernel, dim3(kPassBlocks, H, Bsz),
                 kPassThreads, 0, s, p);
  if (err == 0)
    err = launch(ssd_bwd_dx_kernel, dim3(T, H, bc), kThreads, DxSmem::kBytes,
                 s, p);
  if (err == 0)
    err = launch(ssd_bwd_dcb_kernel, dim3(T * (T + 1) / 2, bc), kThreads,
                 DcbSmem::kBytes, s, p);
  if (err == 0)
    err = launch(ssd_bwd_dbc_kernel, dim3(T, 4, bc), kThreads,
                 DbcSmem::kBytes, s, p);
  if (err == 0)
    err = launch(ssd_bwd_ddt_kernel, dim3(H, bc), kDdtThreads, 0, s, p);
  if (err == 0)
    err = launch(ssd_bwd_da_kernel, dim3((H + 127) / 128), 128, 0, s, p, bc);
  return err;
}
