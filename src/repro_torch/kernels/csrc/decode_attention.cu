// Single-token attention against a KV cache: the decode step's attention
// (models/layers.py, decode_attention), one query token a row against
// every valid cached position, grouped-query.
//
// Replaces no TPU kernel.  The reference's decode attention is plain jnp
// (src/repro/models/layers.py, decode_attention), which XLA fuses.  In
// eager PyTorch the same function casts the whole K cache to fp32, lets
// einsum copy K and V into batched layouts, and runs two small bmms, a
// bias add, a softmax and a cast: about 450 MB of traffic a layer at
// yi-6b's chat cell, where reading the cache once is 75 MB.
//
//   out[b, 0, h*G + g] = sum_s softmax_s(scale q[b, 0, h*G + g] . k[b, s, h])
//                        v[b, s, h]
//
// over the slots s with lo_b <= s < hi_b: hi_b = min(cache_len[b], S), and
// lo_b = pos[b] - window + 1 with a window (0 without); logits in fp32,
// through tanh(x / softcap) * softcap with a softcap, as the plain path
// takes them; a row with no such slot attends all S slots alike, as the
// plain path's bias leaves it.  cache_len and pos are read on the device,
// so one captured decode graph serves every position.
//
// What bounds it on an H100.  Each cached K/V byte is used by the G query
// heads of its kv head (8 at yi-6b, 4 at granite-4.0-h-small): about 2 G
// flops a byte, far below the tensor cores' 295, so device memory bounds
// it: the valid K and V once, 22.5 us a layer at yi-6b's chat cell (32
// rows over 1152 slots, 4 kv heads of 128, bf16) at 3.35 TB/s.
//
// What the design does about it.  Each byte is read once, in place, from
// the cache's own (B, S, n_kv, Dh) layout: a CTA takes one kv head of one
// row (and up to 16 of its query heads), so the G heads share every K/V
// byte, and one split of the cache's positions; the wrapper chooses the
// split count from B x n_kv x ceil(G / 16) and the capacity so that about
// one CTA runs on each SM (a second split where the pairs already fill
// the SMs only adds partials to combine).  Slices past hi_b (or before
// lo_b) are not read: a CTA whose split holds no valid slot writes an
// empty partial.
// bf16 at head dim 64 or 128 takes the tensor cores (`mma.sync` m16n8k16
// fed by `ldmatrix`, the G rows padded to 16): four warps take 16 slots
// each of a 64-slot stage, streamed from the cache through a ring of
// 16-byte `cp.async` loads (3 stages at 128, 4 at 64; zero-filled where a
// slot is masked), scores into fp32 accumulators (bf16 products are exact
// in fp32, as in the plain path's fp32 einsum), an online softmax in
// fp32, P rounded to bf16 (the plain path rounds the probabilities to v's
// type) straight from the score registers into the A operand of P.V, and
// P.V accumulated in fp32.  The four warps' running (max, sum, acc) are
// merged in a fixed order through shared memory.  Every other type and
// head dim (fp32, the smoke configs' head dims 8 and 16) takes a CUDA-core
// kernel of the same structure, one 16-slot tile at a time.  With more
// than one split each CTA writes an fp32 partial (max, sum, acc) and a
// second small kernel (a CTA a query row) combines them in split order;
// with one split the
// CTA writes the output itself.  No atomics: the same inputs give the
// same bits.
//
// Nothing is allocated here and nothing waits on the host: the wrapper
// (kernels/decode_attention.py) gives the output and the scratch, the
// launches go to its stream, and the entry returns cudaGetLastError()
// after each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;          // query rows a CTA (one m16 tile)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMmaKeys = 16 * kWarps;  // slots a stage, tensor-core route
constexpr int kSimtKeys = 16;      // slots a tile, CUDA-core route
constexpr int kMaxSplits = 128;
constexpr int kMaxHeadDim = 256;

struct Params {
  const void* q;           // (B, 1, H, Dh), contiguous
  const void* k;           // (B, S, n_kv, Dh), strides below, Dh contiguous
  const void* v;
  const long long* pos;    // (B,) at stride pos_stride
  const long long* len;    // (B,) at stride len_stride
  void* out;               // (B, 1, H, Dh)
  float* part_acc;         // (pairs, splits, 16, Dh), splits > 1 only
  float* part_ml;          // (pairs, splits, 16, 2)
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long pos_stride, len_stride;
  int B, S, H, n_kv, G, Dh, row_tiles, splits, window;
  float scale, softcap;    // softcap <= 0: none
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// the probability as P.V takes it: rounded to the type of v
__device__ __forceinline__ float as_v(float x, float) { return x; }
__device__ __forceinline__ float as_v(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
}

// the valid slots [lo, hi) of row b.  A row with none (cache_len 0, or a
// window that ends before it starts) attends every slot alike, as the plain
// version's bias leaves it: [0, S) at a scale of 0, returned.
__device__ __forceinline__ float valid_slots(const Params& p, int b, int& lo,
                                             int& hi) {
  const long long len = p.len[b * p.len_stride];
  const long long h = len < p.S ? len : p.S;
  long long l = 0;
  if (p.window > 0) {
    const long long w = p.pos[b * p.pos_stride] - p.window + 1;
    l = w > 0 ? w : 0;
  }
  if (l < h) {
    lo = (int)l;
    hi = (int)h;
    return p.scale;
  }
  lo = 0;
  hi = p.S;
  return 0.f;
}

// the tiles [t0, t1) of `tiles` that this CTA's split holds and that hold a
// valid slot
__device__ __forceinline__ void split_tiles(const Params& p, int tiles,
                                            int keys, int lo, int hi,
                                            int& t0, int& t1) {
  const int split = blockIdx.y;
  const int a = (int)((long long)split * tiles / p.splits);
  const int b = (int)((long long)(split + 1) * tiles / p.splits);
  t0 = max(a, lo / keys);
  t1 = min(b, (hi + keys - 1) / keys);
  if (t1 < t0) t1 = t0;
}

__device__ __forceinline__ float logit(const Params& p, float scale,
                                      float dot) {
  float x = dot * scale;
  if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
  return x;
}

// the CTA's result for its rows: the output (one split) or its partial
template <typename T>
__device__ __forceinline__ void put_row(const Params& p, int pair, int b,
                                        int head0, int r, int d, float m,
                                        float l, float acc) {
  if (p.splits == 1) {
    T* out = static_cast<T*>(p.out);
    out[((long long)b * p.H + head0 + r) * p.Dh + d] =
        from_f<T>(l > 0.f ? acc / l : 0.f);
    return;
  }
  const long long slot = ((long long)pair * p.splits + blockIdx.y) * kRows + r;
  p.part_acc[slot * p.Dh + d] = acc;
  if (d == 0) {
    p.part_ml[2 * slot] = m;
    p.part_ml[2 * slot + 1] = l;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, head dim 64 or 128
// ---------------------------------------------------------------------------

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

// 16 bytes global -> shared; zeros, and nothing read, where !full
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src,
                                       bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
struct MmaTile {
  static constexpr int kStages = DH == 64 ? 4 : 3;
  static constexpr int kLd = DH + 8;            // bf16: ldmatrix without
                                                // bank conflicts
  static constexpr int kQElems = kRows * kLd;
  static constexpr int kKvElems = kMmaKeys * kLd;  // K or V of a stage
  static constexpr int kSmemBytes =
      2 * (kQElems + kStages * 2 * kKvElems);
  // the warps' (acc, max, sum) for the merge, over the ring
  static constexpr int kMergeBytes = 4 * kWarps * kRows * (DH + 2);
  static_assert(kMergeBytes <= 2 * kStages * 2 * kKvElems, "merge space");
};

template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_mma_kernel(Params p) {
  using T = MmaTile<DH>;
  constexpr int kStages = T::kStages, kLd = T::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = sq + T::kQElems;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = blockIdx.x;
  const int rt = pair % p.row_tiles, bh = pair / p.row_tiles;
  const int h = bh % p.n_kv, b = bh / p.n_kv;
  const int rows = min(kRows, p.G - rt * kRows);
  const int head0 = h * p.G + rt * kRows;

  // the query rows, zero past the group
  const bf16* q = static_cast<const bf16*>(p.q) +
                  ((long long)b * p.H + head0) * DH;
  for (int i = tid; i < kRows * DH / 8; i += kThreads) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(q + r * DH + 8 * c);
    *reinterpret_cast<uint4*>(sq + r * kLd + 8 * c) = val;
  }

  int lo, hi, t0, t1;
  const float scale = valid_slots(p, b, lo, hi);
  split_tiles(p, (p.S + kMmaKeys - 1) / kMmaKeys, kMmaKeys, lo, hi, t0, t1);
  const int n = t1 - t0;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  auto load = [&](int stage, int tile) {
    bf16* dk = ring + stage * 2 * T::kKvElems;
    bf16* dv = dk + T::kKvElems;
    const int key0 = tile * kMmaKeys;
    for (int i = tid; i < kMmaKeys * DH / 8; i += kThreads) {
      const int r = i / (DH / 8), c = i % (DH / 8);
      const int key = key0 + r;
      const bool ok = key >= lo && key < hi;
      const long long s = ok ? key : lo;
      copy16(dk + r * kLd + 8 * c, kb + s * p.k_ss + 8 * c, ok);
      copy16(dv + r * kLd + 8 * c, vb + s * p.v_ss + 8 * c, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, t0 + s);
    commit();
  }
  __syncthreads();                 // the query rows
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm4(qf[kk], sq + (lane & 15) * kLd + 16 * kk + 8 * (lane >> 4));

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8: running max and this lane's share of the sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n; ++i) {
    wait_pending<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n) load(next % kStages, t0 + next);
    commit();
    const bf16* ck = ring + (i % kStages) * 2 * T::kKvElems + warp * 16 * kLd;
    const bf16* cv = ck + T::kKvElems;

    // scores of the warp's 16 slots: two n-tiles of 8
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t kf[4];
      ldsm4(kf, ck + ((lane & 7) + 8 * (lane >> 4)) * kLd + 16 * kk
                    + 8 * ((lane >> 3) & 1));
      mma(s[0], qf[kk], kf[0], kf[1]);
      mma(s[1], qf[kk], kf[2], kf[3]);
    }
    const int key0 = (t0 + i) * kMmaKeys + warp * 16 + 2 * t;
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * nt + e;
        const bool ok = key >= lo && key < hi;
        s[nt][e] = ok ? logit(p, scale, s[nt][e]) : -INFINITY;
        s[nt][2 + e] = ok ? logit(p, scale, s[nt][2 + e]) : -INFINITY;
        x0 = fmaxf(x0, s[nt][e]);
        x1 = fmaxf(x1, s[nt][2 + e]);
      }
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    // a row with no valid slot yet keeps 0 for its base: exp(-inf) = 0
    const float base0 = n0 == -INFINITY ? 0.f : n0;
    const float base1 = n1 == -INFINITY ? 0.f : n1;
    const float a0 = expf(m0 - base0), a1 = expf(m1 - base1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = expf(s[nt][e] - base0);
        s[nt][2 + e] = expf(s[nt][2 + e] - base1);
        l0 += s[nt][e];
        l1 += s[nt][2 + e];
      }
    // the scores' accumulator layout is P's A operand of P.V
    const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t vf[4];
      ldsm4_t(vf, cv + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 16 * np
                      + 8 * (lane >> 4));
      mma(o[2 * np], pf, vf[0], vf[1]);
      mma(o[2 * np + 1], pf, vf[2], vf[3]);
    }
  }
  wait_pending<0>();
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();                 // the ring is free: merge over it

  float* so = reinterpret_cast<float*>(ring);        // [warp][row][DH]
  float* sm = so + kWarps * kRows * DH;               // [warp][row]
  float* sl = sm + kWarps * kRows;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    float* r0 = so + (warp * kRows + g) * DH + 8 * j + 2 * t;
    r0[0] = o[j][0];
    r0[1] = o[j][1];
    r0[8 * DH] = o[j][2];
    r0[8 * DH + 1] = o[j][3];
  }
  if (t == 0) {
    sm[warp * kRows + g] = m0;
    sm[warp * kRows + g + 8] = m1;
    sl[warp * kRows + g] = l0;
    sl[warp * kRows + g + 8] = l1;
  }
  __syncthreads();
  for (int i = tid; i < rows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm[w * kRows + r]);
    const float base = m == -INFINITY ? 0.f : m;
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm[w * kRows + r] - base);
      l += sl[w * kRows + r] * e;
      acc += so[(w * kRows + r) * DH + d] * e;
    }
    put_row<bf16>(p, pair, b, head0, r, d, m, l, acc);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core route: fp32, and bf16 at the other head dims
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_simt_kernel(Params p) {
  const int DH = p.Dh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);     // [16][DH]
  float* sk = sq + kRows * DH;                         // [16][DH + 1]
  float* sv = sk + kSimtKeys * (DH + 1);               // [16][DH]
  float* sacc = sv + kSimtKeys * DH;                   // [16][DH]
  float* ss = sacc + kRows * DH;                       // [16][16]
  float* sm = ss + kRows * kSimtKeys;
  float* sl = sm + kRows;
  float* sa = sl + kRows;

  const int tid = threadIdx.x;
  const int pair = blockIdx.x;
  const int rt = pair % p.row_tiles, bh = pair / p.row_tiles;
  const int h = bh % p.n_kv, b = bh / p.n_kv;
  const int rows = min(kRows, p.G - rt * kRows);
  const int head0 = h * p.G + rt * kRows;
  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.H + head0) * DH;
  for (int i = tid; i < rows * DH; i += kThreads) {
    sq[i] = to_f(q[i]);
    sacc[i] = 0.f;
  }
  if (tid < kRows) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
  }

  int lo, hi, t0, t1;
  const float scale = valid_slots(p, b, lo, hi);
  split_tiles(p, (p.S + kSimtKeys - 1) / kSimtKeys, kSimtKeys, lo, hi, t0,
              t1);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int tile = t0; tile < t1; ++tile) {
    const int key0 = tile * kSimtKeys;
    __syncthreads();
    for (int i = tid; i < kSimtKeys * DH; i += kThreads) {
      const int j = i / DH, d = i % DH, key = key0 + j;
      const bool ok = key >= lo && key < hi;
      sk[j * (DH + 1) + d] = ok ? to_f(kb[key * p.k_ss + d]) : 0.f;
      sv[j * DH + d] = ok ? to_f(vb[key * p.v_ss + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < rows * kSimtKeys; i += kThreads) {
      const int r = i / kSimtKeys, j = i % kSimtKeys, key = key0 + j;
      float dot = 0.f;
      for (int d = 0; d < DH; ++d)
        dot = fmaf(sq[r * DH + d], sk[j * (DH + 1) + d], dot);
      ss[i] = key >= lo && key < hi ? logit(p, scale, dot) : -INFINITY;
    }
    __syncthreads();
    if (tid < rows) {
      float x = -INFINITY;
      for (int j = 0; j < kSimtKeys; ++j)
        x = fmaxf(x, ss[tid * kSimtKeys + j]);
      const float m = fmaxf(sm[tid], x);
      const float base = m == -INFINITY ? 0.f : m;
      const float a = expf(sm[tid] - base);
      float l = sl[tid] * a;
      for (int j = 0; j < kSimtKeys; ++j) {
        const float e = expf(ss[tid * kSimtKeys + j] - base);
        l += e;
        ss[tid * kSimtKeys + j] = as_v(e, T());
      }
      sm[tid] = m;
      sl[tid] = l;
      sa[tid] = a;
    }
    __syncthreads();
    for (int i = tid; i < rows * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      float acc = sacc[i] * sa[r];
      for (int j = 0; j < kSimtKeys; ++j)
        acc = fmaf(ss[r * kSimtKeys + j], sv[j * DH + d], acc);
      sacc[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * DH; i += kThreads) {
    const int r = i / DH;
    put_row<T>(p, pair, b, head0, r, i % DH, sm[r], sl[r], sacc[i]);
  }
}

// ---------------------------------------------------------------------------
// The splits' partials combined in split order
// ---------------------------------------------------------------------------

// one CTA a (pair, query row): the row's max and sum over the splits,
// then each of its Dh outputs a thread, over the splits in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine_kernel(Params p) {
  __shared__ float se[kMaxSplits], sle[kMaxSplits];
  const int tid = threadIdx.x, pair = blockIdx.x, r = blockIdx.y;
  const int S = p.splits;
  const int rt = pair % p.row_tiles, bh = pair / p.row_tiles;
  const int h = bh % p.n_kv, b = bh / p.n_kv;
  if (r >= min(kRows, p.G - rt * kRows)) return;
  const int head = h * p.G + rt * kRows + r;
  const long long row0 = (long long)pair * S * kRows + r;  // split 0's slot
  for (int s = tid; s < S; s += kThreads)
    se[s] = p.part_ml[2 * (row0 + s * kRows)];
  __syncthreads();
  float m = -INFINITY;
  for (int s = 0; s < S; ++s) m = fmaxf(m, se[s]);
  const float base = m == -INFINITY ? 0.f : m;
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) {
    const float e = expf(se[s] - base);
    se[s] = e;
    sle[s] = p.part_ml[2 * (row0 + s * kRows) + 1] * e;
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < S; ++s) l += sle[s];
  T* out = static_cast<T*>(p.out) + ((long long)b * p.H + head) * p.Dh;
  for (int d = tid; d < p.Dh; d += kThreads) {
    const float* acc = p.part_acc + row0 * p.Dh + d;
    float num = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s)
      num += acc[(long long)s * kRows * p.Dh] * se[s];
    out[d] = from_f<T>(l > 0.f ? num / l : 0.f);
  }
}

template <typename K>
int launch(K kernel, dim3 grid, int smem, const Params& p,
           cudaStream_t stream) {
  // always: the attribute is per kernel, and a smaller request is free
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int combine(const Params& p, int pairs, cudaStream_t stream) {
  if (p.splits == 1) return 0;
  const dim3 grid(pairs, min(p.G, kRows));
  decode_attention_combine_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// the sizes the wrapper plans with: query rows a CTA, slots a tile on the
// tensor-core and the CUDA-core route, most splits, largest head dim
extern "C" void decode_attention_sizes(int* out) {
  out[0] = kRows;
  out[1] = kMmaKeys;
  out[2] = kSimtKeys;
  out[3] = kMaxSplits;
  out[4] = kMaxHeadDim;
}

// ptrs: q, k, v, pos, cache_len, out, part_acc, part_ml (the partials null
// with one split).  ints: B, S, H, n_kv, Dh, k strides (b, s, head), v
// strides, pos stride, cache_len stride, window (0: none), splits, route
// (0 CUDA cores, 1 tensor cores), type (0 float32, 1 bfloat16).
extern "C" int decode_attention(const void* const* ptrs,
                                const long long* ints, float scale,
                                float softcap, void* stream) {
  Params p{};
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.pos = static_cast<const long long*>(ptrs[3]);
  p.len = static_cast<const long long*>(ptrs[4]);
  p.out = const_cast<void*>(ptrs[5]);
  p.part_acc = static_cast<float*>(const_cast<void*>(ptrs[6]));
  p.part_ml = static_cast<float*>(const_cast<void*>(ptrs[7]));
  p.B = (int)ints[0];
  p.S = (int)ints[1];
  p.H = (int)ints[2];
  p.n_kv = (int)ints[3];
  p.Dh = (int)ints[4];
  p.k_sb = ints[5];
  p.k_ss = ints[6];
  p.k_sh = ints[7];
  p.v_sb = ints[8];
  p.v_ss = ints[9];
  p.v_sh = ints[10];
  p.pos_stride = ints[11];
  p.len_stride = ints[12];
  p.window = (int)ints[13];
  p.splits = (int)ints[14];
  const int route = (int)ints[15], type = (int)ints[16];
  p.scale = scale;
  p.softcap = softcap;
  if (p.B <= 0 || p.S <= 0 || p.n_kv <= 0 || p.H % p.n_kv != 0 ||
      p.Dh <= 0 || p.Dh > kMaxHeadDim || p.splits <= 0 ||
      p.splits > kMaxSplits || p.window < 0 || (type != 0 && type != 1) ||
      (p.splits > 1 && (p.part_acc == nullptr || p.part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  p.G = p.H / p.n_kv;
  p.row_tiles = (p.G + kRows - 1) / kRows;
  const long long pairs = (long long)p.B * p.n_kv * p.row_tiles;
  const int keys = route == 1 ? kMmaKeys : kSimtKeys;
  if (pairs > 0x7fffffffLL || p.splits > (p.S + keys - 1) / keys)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)pairs, (unsigned)p.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (route == 1) {
    if (type != 1) return (int)cudaErrorInvalidValue;
    if (p.Dh == 64)
      err = launch(decode_attention_mma_kernel<64>, grid,
                   MmaTile<64>::kSmemBytes, p, s);
    else if (p.Dh == 128)
      err = launch(decode_attention_mma_kernel<128>, grid,
                   MmaTile<128>::kSmemBytes, p, s);
    else
      return (int)cudaErrorInvalidValue;
    return err ? err : combine<bf16>(p, (int)pairs, s);
  }
  const int smem = 4 * (kRows * p.Dh + kSimtKeys * (p.Dh + 1) +
                        kSimtKeys * p.Dh + kRows * p.Dh +
                        kRows * kSimtKeys + 3 * kRows);
  if (type == 0) {
    err = launch(decode_attention_simt_kernel<float>, grid, smem, p, s);
    return err ? err : combine<float>(p, (int)pairs, s);
  }
  err = launch(decode_attention_simt_kernel<bf16>, grid, smem, p, s);
  return err ? err : combine<bf16>(p, (int)pairs, s);
}
