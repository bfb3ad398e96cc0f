/*
 * Flash attention forward and backward, written by hand for Hopper
 * (sm_90a).  Three kernels, each replacing one Pallas TPU kernel of
 * torchacc_tpu/ops/flash_attention.py:
 *
 *   fwd_*kernel      B1  _fwd_kernel      (:176, pallas_call :351 in _fwd)
 *                        online-softmax forward -> o and the f32 row LSE
 *   bwd_dq_*kernel   B2  _bwd_dq_kernel   (:432, pallas_call :602)
 *                        dq of one q tile over its visible kv tiles
 *   bwd_dkv_*kernel  B3  _bwd_dkv_kernel  (:481, pallas_call :653)
 *                        dk and dv of one kv tile, summed over the group
 *                        q heads of its kv head and their visible q tiles
 *
 * Semantics are those of the JAX kernels and of the plain version
 * (ops/attention.py): q [b, sq, hq, d], k/v [b, sk, hk, d] (BSHD, as
 * the model layer holds them; no transpose to BHSD), GQA q head h reads
 * kv head h / (hq / hk); query i sits at position i + (sk - sq) (bottom
 * right alignment); key j is visible to it when causal j <= pos, left
 * window j >= pos - left, right window j <= pos + right, and equal
 * segment ids; scores are scale * q.k, then softcap c * tanh(s / c).  A
 * row that sees no key writes o = 0 and lse = NEG_INF (-1e30) and gets
 * zero gradients.  The backward rebuilds P = exp(s - lse) from the
 * saved LSE and takes dS = P * (dO.V - delta) * (1 - (s/c)^2) * scale
 * with delta = rowsum(dO * O), computed by the caller (as the JAX
 * wrapper does at :555).  ALiBi adds -slope[h] * |i + (sk - sq) - j| to
 * the score after the scale and the softcap (_alibi_bias, :108), on
 * every tile; the slopes get no gradient.  Dropout keeps a pair when a
 * hash of (seed, batch, q head, i, j) — the murmur3-finalizer hash of
 * ops/_common.py dropout_keep, bit for bit the JAX package's — is at
 * least p * 2^32, and scales the kept P by 1 / (1 - p) for P.V only:
 * l and the LSE stay undropped (:240-250), and the backward takes
 * dS = (P~ * dO.V - P * delta) * ... and dV = P~^T dO with the same keep
 * bits (_recompute_p, :382); B3 keys the hash by the q head of the
 * group, not the kv head (:494).  Both are compiled into kernels of
 * their own (the EXTRA template flag), so the kernels of the plain
 * training path carry none of their code or registers: with the code
 * inline, B1 ran 28% slower on an H100 (chip_smoke.py).  The context-parallel offsets are not
 * ported; the wrapper refuses them.
 *
 * What bounds them on an H100 (3.35 TB/s; 989 TFLOP/s bf16 on tensor
 * cores, 67 TFLOP/s f32 on CUDA cores): at the training shape
 * (b 2, s 4096, 32 q / 8 kv heads, d 128) the forward does 4 * d flops
 * per visible (q, k) pair and head over ~100 MB of q/k/v/o, so it is
 * bound by arithmetic by two orders of magnitude; the backward does
 * 2.5x the forward's flops over twice the bytes, bound by arithmetic
 * too.  So the products belong on the tensor cores.
 *
 * Two implementations of each kernel, chosen by the input dtype:
 *  - bf16 (the training path): fwd_mma_kernel, bwd_dq_mma_kernel and
 *    bwd_dkv_mma_kernel put every product on the tensor cores with
 *    mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16 rows;
 *  - f32 (the exact comparison with the plain version, which the card
 *    cannot make in bf16): fwd_kernel, bwd_dq_kernel and bwd_dkv_kernel
 *    run the dots on CUDA cores in f32, 256 threads each computing a
 *    4x4 block of scores from float4 shared-memory reads (8 loads per
 *    64 FMAs), rows padded to d + 4 floats so the 16 column threads hit
 *    distinct banks.
 * wgmma, TMA and a producer/consumer pipeline are later work.
 *
 * What the design does about it, in both:
 *  - grid order: the TPU's kv axis (B1, B2) and (group, q) axes (B3)
 *    were sequential grid axes carrying VMEM scratch.  Here each CTA
 *    owns its output tile and loops over the other axis itself: one CTA
 *    per (batch, q head, 64 query rows) for B1/B2 and one per (batch,
 *    kv head, 64 keys) for B3, which sums dk/dv over every q head of
 *    its group and every visible q tile in registers and writes them
 *    once (no atomics, no per-q-head dk/dv in device memory);
 *  - only visible tiles are loaded: causality ends B1/B2's kv walk at
 *    the diagonal and starts B3's q walk there, the window bounds the
 *    other end, and a tile pair whose segment-id ranges do not meet is
 *    skipped (packed documents) — the work follows the visible pairs;
 *  - heavy tiles first: under causality the last q tiles (B1/B2) and
 *    the first kv tiles (B3) see the most, so they are scheduled first;
 *  - online softmax in f32 with m, l and the output rows in registers;
 *  - the TPU's 1024^2 tiles and its 128-lane broadcasts of LSE and
 *    segment ids are not carried over: LSE [b, h, s] f32 and segment
 *    ids [b, s] int32 are read as they are, ragged edges are masked in
 *    the kernel, and nothing is padded or allocated here.
 */

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kPad = 4;            // floats of row padding (bank spread)
constexpr int kLdP = kTile + kPad; // row stride of the score tiles
constexpr float kNegInf = -1e30f;

struct Geom {
  const int* qseg;      // [b, sq] or null
  const int* kseg;      // [b, sk] or null
  const float* alibi;   // [hq] slopes or null
  int sq, sk, hq, hk, causal, wl, wr, shift;
  float scale, softcap;
  int drop_on;          // dropout on P.V
  uint32_t drop_seed, drop_thresh;   // keep where hash >= thresh
  float drop_scale;     // 1 / (1 - p)
};

// murmur3 finalizer, and the dropout hash of ops/_common.py: a pair is
// kept when mix32(mix32(base ^ q) ^ mix32(k * K')) >= thresh, with
// base = mix32(seed + batch * B' + q head)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t drop_base(const Geom& g, int bi, int h) {
  return mix32(g.drop_seed + uint32_t(bi) * 0x85EBCA6Bu + uint32_t(h));
}
__device__ __forceinline__ uint32_t drop_row(uint32_t base, int qi) {
  return mix32(base ^ uint32_t(qi));
}
__device__ __forceinline__ uint32_t drop_col(int kj) {
  return mix32(uint32_t(kj) * 0x9E3779B9u);
}
// the factor on a kept / dropped P entry: 1 / (1 - p) or 0
__device__ __forceinline__ float drop_factor(const Geom& g, uint32_t row, uint32_t col) {
  return mix32(row ^ col) >= g.drop_thresh ? g.drop_scale : 0.f;
}
// dS without the softcap and scale factors: P * (dP - delta), or with
// dropout P~ * dP - P * delta
__device__ __forceinline__ float ds_core(bool drop_on, float p, float f, float dp,
                                         float delta) {
  return drop_on ? (p * f) * dp - p * delta : p * (dp - delta);
}

// the CUDA-core kernels are instantiated for float only (bf16 goes to
// the tensor-core kernels); T stays a parameter of their tile code
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x) { return x; }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// reductions over the 16 column threads of a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + 64) of head h of a BSHD tensor with S rows and H
// heads, into dst [64][D + kPad] as f32; rows past S read as zeros.
// Every 16-byte load of the tile is issued before any is stored.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int bi,
                                          int row0, int S, int H, int h) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  constexpr int LD = D + kPad;
  constexpr int N = kTile * CPR / kThreads;
  static_assert(kTile * CPR % kThreads == 0, "tile loads must split evenly");
  uint4 raw[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int row = row0 + i / CPR;
    raw[n] = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      raw[n] = *reinterpret_cast<const uint4*>(
          src + ((size_t(bi) * S + row) * H + h) * D + (i % CPR) * VEC);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = threadIdx.x + n * kThreads;
    float* out = dst + (i / CPR) * LD + (i % CPR) * VEC;
    const T* e = reinterpret_cast<const T*>(&raw[n]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_float(e[j]);
  }
}

// segment ids of rows [row0, row0 + ROWS) into dst[ROWS] (threads
// 0..ROWS-1)
template <int ROWS>
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int bi,
                                         int row0, int S) {
  if (threadIdx.x < ROWS) {
    const int row = row0 + threadIdx.x;
    dst[threadIdx.x] = row < S ? seg[size_t(bi) * S + row] : 0;
  }
}

// [min, max] of the segment ids of the valid rows of a tile; every warp
// computes it redundantly, so the answer is uniform with no extra sync
template <int ROWS>
__device__ __forceinline__ int2 seg_range(const int* seg_s, int row0, int S) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int c = 0; c < ROWS / 32; ++c) {
    const int r = lane + 32 * c;
    if (row0 + r < S) {
      lo = min(lo, seg_s[r]);
      hi = max(hi, seg_s[r]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// acc[i][j] = A[ty*4 + i] . B[tx + 16*j] over D, A and B [64][D + kPad]
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(a[i].x, b[j].x,
                         fmaf(a[i].y, b[j].y,
                              fmaf(a[i].z, b[j].z,
                                   fmaf(a[i].w, b[j].w, acc[i][j]))));
  }
}

// the output columns a thread owns: (e * 16 + tx) * VW + w
template <int D>
struct Cols {
  static constexpr int DPT = D / 16;              // columns per thread
  static constexpr int VW = DPT >= 4 ? 4 : DPT;   // vector width
  static constexpr int NV = DPT / VW;             // vectors per row
  __device__ static int col(int e, int w, int tx) { return (e * 16 + tx) * VW + w; }
};

// acc[i][c] += sum_k P[ty*4 + i][k] * V[k][col c], P [64][kLdP],
// V [64][D + kPad]
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[4][D / 16],
                                        const float* P, const float* V,
                                        int ty, int tx) {
  using C = Cols<D>;
  constexpr int LD = D + kPad;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * kLdP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* vrow = V + (k + kk) * LD;
#pragma unroll
      for (int e = 0; e < C::NV; ++e) {
        float vv[C::VW];
        if constexpr (C::VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + C::col(e, 0, tx));
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vrow + C::col(e, 0, tx));
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = comp(p[i], kk);
#pragma unroll
          for (int w = 0; w < C::VW; ++w)
            acc[i][e * C::VW + w] = fmaf(pk, vv[w], acc[i][e * C::VW + w]);
        }
      }
    }
  }
}

__device__ __forceinline__ bool visible(const Geom& g, int qi, int kj) {
  const int qp = qi + g.shift;
  return qi < g.sq && kj < g.sk && (!g.causal || kj <= qp) &&
         (g.wl < 0 || kj >= qp - g.wl) && (g.wr < 0 || kj <= qp + g.wr);
}

// kv range [begin, end) some row of q tile [q0, q0 + 64) can see
__device__ __forceinline__ int2 kv_range(const Geom& g, int q0) {
  const int qlo = q0 + g.shift;
  const int qhi = min(q0 + kTile, g.sq) - 1 + g.shift;
  int begin = g.wl >= 0 ? max(0, qlo - g.wl) : 0;
  int end = g.sk;
  if (g.causal) end = min(end, qhi + 1);
  if (g.wr >= 0) end = min(end, qhi + g.wr + 1);
  return make_int2((begin / kTile) * kTile, end);
}

// q range [begin, end) of the rows that can see some key of kv tile
// [k0, k0 + 64)
__device__ __forceinline__ int2 q_range(const Geom& g, int k0) {
  const int khi = min(k0 + kTile, g.sk) - 1;
  int begin = 0;
  if (g.causal) begin = max(begin, k0 - g.shift);
  if (g.wr >= 0) begin = max(begin, k0 - g.wr - g.shift);
  int end = g.sq;
  if (g.wl >= 0) end = min(end, khi + g.wl - g.shift + 1);
  return make_int2((begin / kTile) * kTile, end);
}

// score after scale, softcap and the ALiBi bias of pair (qi, kj), and
// the softcap chain factor (taken before the bias lands)
__device__ __forceinline__ float cap_score(const Geom& g, float dot, bool has_alibi,
                                           float slope, int qi, int kj, float* dcap) {
  float x = dot * g.scale;
  *dcap = 1.f;
  if (g.softcap > 0.f) {
    const float t = tanhf(x / g.softcap);
    x = g.softcap * t;
    *dcap = 1.f - t * t;
  }
  if (has_alibi) x -= slope * fabsf(float(qi + g.shift - kj));
  return x;
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * size_t(kTile) * (D + kPad) + size_t(kTile) * kLdP) +
         sizeof(int) * 2 * kTile;
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * size_t(kTile) * (D + kPad) + size_t(kTile) * kLdP) +
         sizeof(int) * 2 * kTile;
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * size_t(kTile) * (D + kPad) + 2 * size_t(kTile) * kLdP +
                          2 * kTile) +
         sizeof(int) * 2 * kTile;
}

// ---------------------------------------------------------------------------
// B1: forward
// ---------------------------------------------------------------------------

template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, Geom g) {
  using C = Cols<D>;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;
  int* qseg_s = reinterpret_cast<int*>(p_s + kTile * kLdP);
  int* kseg_s = qseg_s + kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;   // heavy tiles first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (g.hq / g.hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool has_seg = g.qseg != nullptr;
  // ALiBi and dropout compile away from the EXTRA = false kernels
  const bool has_alibi = EXTRA && g.alibi != nullptr;
  const bool drop_on = EXTRA && g.drop_on;
  const float slope = has_alibi ? g.alibi[h] : 0.f;
  uint32_t drow[4] = {0u, 0u, 0u, 0u};
  if (drop_on) {
    const uint32_t base = drop_base(g, bi, h);
#pragma unroll
    for (int i = 0; i < 4; ++i) drow[i] = drop_row(base, q0 + ty * 4 + i);
  }

  load_tile<T, D>(q_s, q, bi, q0, g.sq, g.hq, h);
  int2 qsr = make_int2(0, 0);
  if (has_seg) {
    load_seg<kTile>(qseg_s, g.qseg, bi, q0, g.sq);
    __syncthreads();
    qsr = seg_range<kTile>(qseg_s, q0, g.sq);
  }

  float m[4], l[4], acc[4][C::DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::DPT; ++c) acc[i][c] = 0.f;
  }

  const int2 kr = kv_range(g, q0);
  for (int k0 = kr.x; k0 < kr.y; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    if (has_seg) {
      load_seg<kTile>(kseg_s, g.kseg, bi, k0, g.sk);
      __syncthreads();
      const int2 ksr = seg_range<kTile>(kseg_s, k0, g.sk);
      if (ksr.y < qsr.x || ksr.x > qsr.y) continue;   // no segment in common
    }
    load_tile<T, D>(k_s, k, bi, k0, g.sk, g.hk, kvh);
    load_tile<T, D>(v_s, v, bi, k0, g.sk, g.hk, kvh);
    __syncthreads();

    float s[4][4];
    dot_tile<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float tmax = kNegInf;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float dcap;
        const float x = cap_score(g, s[i][j], has_alibi, slope, q0 + r, k0 + c, &dcap);
        ok[j] = visible(g, q0 + r, k0 + c) && (!has_seg || qseg_s[r] == kseg_s[c]);
        s[i][j] = ok[j] ? x : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float alpha = m[i] == kNegInf ? 0.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;      // l and the LSE stay undropped
        p_s[r * kLdP + tx + 16 * j] =
            drop_on ? p * drop_factor(g, drow[i], drop_col(k0 + tx + 16 * j)) : p;
      }
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<D>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= g.sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    T* orow = o + ((size_t(bi) * g.sq + qi) * g.hq + h) * D;
#pragma unroll
    for (int e = 0; e < C::NV; ++e)
#pragma unroll
      for (int w = 0; w < C::VW; ++w)
        orow[C::col(e, w, tx)] = from_float<T>(acc[i][e * C::VW + w] * inv);
    if (tx == 0)
      lse[(size_t(bi) * g.hq + h) * g.sq + qi] =
          l[i] == 0.f ? kNegInf : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// B2: dq
// ---------------------------------------------------------------------------

template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dq, Geom g) {
  using C = Cols<D>;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;
  int* qseg_s = reinterpret_cast<int*>(ds_s + kTile * kLdP);
  int* kseg_s = qseg_s + kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (g.hq / g.hk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool has_seg = g.qseg != nullptr;
  // ALiBi and dropout compile away from the EXTRA = false kernels
  const bool has_alibi = EXTRA && g.alibi != nullptr;
  const bool drop_on = EXTRA && g.drop_on;
  const float slope = has_alibi ? g.alibi[h] : 0.f;
  uint32_t drow[4] = {0u, 0u, 0u, 0u};
  if (drop_on) {
    const uint32_t base = drop_base(g, bi, h);
#pragma unroll
    for (int i = 0; i < 4; ++i) drow[i] = drop_row(base, q0 + ty * 4 + i);
  }

  load_tile<T, D>(q_s, q, bi, q0, g.sq, g.hq, h);
  load_tile<T, D>(do_s, dout, bi, q0, g.sq, g.hq, h);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const size_t at = (size_t(bi) * g.hq + h) * g.sq + qi;
    lse_r[i] = qi < g.sq ? lse[at] : 0.f;
    delta_r[i] = qi < g.sq ? delta[at] : 0.f;
  }
  int2 qsr = make_int2(0, 0);
  if (has_seg) {
    load_seg<kTile>(qseg_s, g.qseg, bi, q0, g.sq);
    __syncthreads();
    qsr = seg_range<kTile>(qseg_s, q0, g.sq);
  }

  float acc[4][C::DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::DPT; ++c) acc[i][c] = 0.f;

  const int2 kr = kv_range(g, q0);
  for (int k0 = kr.x; k0 < kr.y; k0 += kTile) {
    __syncthreads();
    if (has_seg) {
      load_seg<kTile>(kseg_s, g.kseg, bi, k0, g.sk);
      __syncthreads();
      const int2 ksr = seg_range<kTile>(kseg_s, k0, g.sk);
      if (ksr.y < qsr.x || ksr.x > qsr.y) continue;
    }
    load_tile<T, D>(k_s, k, bi, k0, g.sk, g.hk, kvh);
    load_tile<T, D>(v_s, v, bi, k0, g.sk, g.hk, kvh);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(s, q_s, k_s, ty, tx);
    dot_tile<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float dcap;
        const float x = cap_score(g, s[i][j], has_alibi, slope, q0 + r, k0 + c, &dcap);
        const bool ok = visible(g, q0 + r, k0 + c) &&
                        (!has_seg || qseg_s[r] == kseg_s[c]);
        const float p = ok ? expf(x - lse_r[i]) : 0.f;
        const float f = drop_on ? drop_factor(g, drow[i], drop_col(k0 + c)) : 1.f;
        ds_s[r * kLdP + c] = ds_core(drop_on, p, f, dp[i][j], delta_r[i]) * dcap * g.scale;
      }
    }
    __syncthreads();
    pv_tile<D>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= g.sq) continue;
    T* row = dq + ((size_t(bi) * g.sq + qi) * g.hq + h) * D;
#pragma unroll
    for (int e = 0; e < C::NV; ++e)
#pragma unroll
      for (int w = 0; w < C::VW; ++w)
        row[C::col(e, w, tx)] = from_float<T>(acc[i][e * C::VW + w]);
  }
}

// ---------------------------------------------------------------------------
// B3: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, Geom g) {
  using C = Cols<D>;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* pt_s = do_s + kTile * LD;       // P^T  [key][q row]
  float* dst_s = pt_s + kTile * kLdP;    // dS^T [key][q row]
  float* lse_s = dst_s + kTile * kLdP;
  float* delta_s = lse_s + kTile;
  int* kseg_s = reinterpret_cast<int*>(delta_s + kTile);
  int* qseg_s = kseg_s + kTile;

  const int k0 = blockIdx.x * kTile;     // the first kv tiles see the most
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int group = g.hq / g.hk;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool has_seg = g.qseg != nullptr;
  // ALiBi and dropout compile away from the EXTRA = false kernels
  const bool has_alibi = EXTRA && g.alibi != nullptr;
  const bool drop_on = EXTRA && g.drop_on;

  load_tile<T, D>(k_s, k, bi, k0, g.sk, g.hk, kvh);
  load_tile<T, D>(v_s, v, bi, k0, g.sk, g.hk, kvh);
  int2 ksr = make_int2(0, 0);
  if (has_seg) {
    load_seg<kTile>(kseg_s, g.kseg, bi, k0, g.sk);
    __syncthreads();
    ksr = seg_range<kTile>(kseg_s, k0, g.sk);
  }

  float dk_acc[4][C::DPT], dv_acc[4][C::DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::DPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int2 qr = q_range(g, k0);
  uint32_t dcol[4] = {0u, 0u, 0u, 0u};   // this thread's keys
  if (drop_on) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dcol[i] = drop_col(k0 + ty * 4 + i);
  }
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;       // ALiBi and dropout go by q head
    const float slope = has_alibi ? g.alibi[h] : 0.f;
    const uint32_t dbase = drop_on ? drop_base(g, bi, h) : 0u;
    for (int q0 = qr.x; q0 < qr.y; q0 += kTile) {
      __syncthreads();
      if (has_seg) {
        load_seg<kTile>(qseg_s, g.qseg, bi, q0, g.sq);
        __syncthreads();
        const int2 qsr = seg_range<kTile>(qseg_s, q0, g.sq);
        if (ksr.y < qsr.x || ksr.x > qsr.y) continue;
      }
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        const size_t at = (size_t(bi) * g.hq + h) * g.sq + qi;
        lse_s[threadIdx.x] = qi < g.sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = qi < g.sq ? delta[at] : 0.f;
      }
      load_tile<T, D>(q_s, q, bi, q0, g.sq, g.hq, h);
      load_tile<T, D>(do_s, dout, bi, q0, g.sq, g.hq, h);
      __syncthreads();

      float s[4][4], dp[4][4];
      dot_tile<D>(s, k_s, q_s, ty, tx);     // rows: keys, columns: q rows
      dot_tile<D>(dp, v_s, do_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float dcap;
          const float x = cap_score(g, s[i][j], has_alibi, slope, q0 + c, k0 + r, &dcap);
          const bool ok = visible(g, q0 + c, k0 + r) &&
                          (!has_seg || qseg_s[c] == kseg_s[r]);
          const float p = ok ? expf(x - lse_s[c]) : 0.f;
          const float f =
              drop_on ? drop_factor(g, drop_row(dbase, q0 + c), dcol[i]) : 1.f;
          pt_s[r * kLdP + c] = p * f;      // dV takes the dropped P
          dst_s[r * kLdP + c] = ds_core(drop_on, p, f, dp[i][j], delta_s[c]) * dcap * g.scale;
        }
      }
      __syncthreads();
      pv_tile<D>(dv_acc, pt_s, do_s, ty, tx);
      pv_tile<D>(dk_acc, dst_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= g.sk) continue;
    const size_t base = ((size_t(bi) * g.sk + kj) * g.hk + kvh) * D;
#pragma unroll
    for (int e = 0; e < C::NV; ++e)
#pragma unroll
      for (int w = 0; w < C::VW; ++w) {
        dk[base + C::col(e, w, tx)] = from_float<T>(dk_acc[i][e * C::VW + w]);
        dv[base + C::col(e, w, tx)] = from_float<T>(dv_acc[i][e * C::VW + w]);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate)
// ---------------------------------------------------------------------------
//
// The same three kernels for bf16 inputs, with every product on the
// tensor cores.  Tiles stay bf16 in shared memory (rows padded by 8
// elements, so the fragment loads of a warp hit 32 distinct banks);
// each warp owns 16 rows.  Scores, softmax and the row statistics stay
// f32 in the accumulator registers.  P (and dS in the backward) enter
// the second product as the sum of two bf16 values, hi + lo: where the
// JAX kernels round them to bf16 once (:252, :467), this keeps ~16 bits,
// so the kernels agree with the plain f32 version to one bf16 ulp of
// the output, as the f32 kernels do.  Operands that a product needs
// transposed (V in P.V, K in dS.K, dO and Q in B3) are read with
// ldmatrix.trans from the same row-major tiles.

constexpr int kMmaThreads = 128;   // 4 warps x 16 rows
constexpr int kBqDkv = 32;         // q rows per step of B3's walk

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of head h of a BSHD bf16 tensor into dst
// [ROWS][D + 8] bf16; rows past S read as zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src, int bi,
                                               int row0, int S, int H, int h) {
  constexpr int CPR = D / 8;
  constexpr int LD = D + 8;
  constexpr int N = ROWS * CPR / kMmaThreads;
  static_assert(ROWS * CPR % kMmaThreads == 0, "tile loads must split evenly");
  uint4 raw[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = threadIdx.x + n * kMmaThreads;
    const int row = row0 + i / CPR;
    raw[n] = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      raw[n] = *reinterpret_cast<const uint4*>(
          src + ((size_t(bi) * S + row) * H + h) * D + (i % CPR) * 8);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = threadIdx.x + n * kMmaThreads;
    *reinterpret_cast<uint4*>(dst + (i / CPR) * LD + (i % CPR) * 8) = raw[n];
  }
}

// acc[nt][.] = A[warp's 16 rows] . B[row nt*8 + .]^T over D, for NT
// n-tiles of 8 rows of B; A and B [.][D + 8] bf16, row-major
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int arow, int grp,
                                        int tid) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* pa = A + (arow + grp) * LD + ks * 16 + tid * 2;
    const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LD), ld32(pa + 8),
                           ld32(pa + 8 * LD + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* pb = B + (n * 8 + grp) * LD + ks * 16 + tid * 2;
      mma_bf16(acc[n], a, ld32(pb), ld32(pb + 8));
    }
  }
}

// x0, x1 as the sum of two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[nd][.] += P . V over KS k-steps of 16, where P is held as the
// accumulators of mma_abt (p[2*KS][4]) and V is [16*KS][D + 8] bf16
// row-major (read transposed with ldmatrix).  P goes in as hi + lo, two
// products per step, so it keeps ~16 bits instead of bf16's 8
template <int D, int KS>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4], const float (&p)[2 * KS][4],
                                       const __nv_bfloat16* V, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
    const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, V + row * LD + dn * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dn], hi, b[0], b[1]);
      mma_bf16(acc[2 * dn], lo, b[0], b[1]);
      mma_bf16(acc[2 * dn + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * dn + 1], lo, b[2], b[3]);
    }
  }
}

template <int D>
constexpr size_t fwd_mma_smem() {
  return sizeof(__nv_bfloat16) * 3 * size_t(kTile) * (D + 8) + sizeof(int) * 2 * kTile;
}
template <int D>
constexpr size_t dq_mma_smem() {
  return sizeof(__nv_bfloat16) * 4 * size_t(kTile) * (D + 8) + sizeof(int) * 2 * kTile;
}
template <int D>
constexpr size_t dkv_mma_smem() {
  return sizeof(__nv_bfloat16) * (2 * size_t(kTile) + 2 * kBqDkv) * (D + 8) +
         sizeof(float) * 2 * kBqDkv + sizeof(int) * (kTile + kBqDkv);
}

// B1 on tensor cores
template <int D, bool EXTRA>
__global__ void __launch_bounds__(kMmaThreads)
    fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, Geom g) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kTile * LD;
  __nv_bfloat16* v_s = k_s + kTile * LD;
  int* qseg_s = reinterpret_cast<int*>(v_s + kTile * LD);
  int* kseg_s = qseg_s + kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (g.hq / g.hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tid = lane & 3;
  const int wrow = warp * 16;
  const bool has_seg = g.qseg != nullptr;
  // ALiBi and dropout compile away from the EXTRA = false kernels
  const bool has_alibi = EXTRA && g.alibi != nullptr;
  const bool drop_on = EXTRA && g.drop_on;
  const float slope = has_alibi ? g.alibi[h] : 0.f;
  uint32_t drow[2] = {0u, 0u};
  if (drop_on) {
    const uint32_t base = drop_base(g, bi, h);
    drow[0] = drop_row(base, q0 + wrow + grp);
    drow[1] = drop_row(base, q0 + wrow + grp + 8);
  }

  load_tile_bf16<D, kTile>(q_s, q, bi, q0, g.sq, g.hq, h);
  int2 qsr = make_int2(0, 0);
  if (has_seg) {
    load_seg<kTile>(qseg_s, g.qseg, bi, q0, g.sq);
    __syncthreads();
    qsr = seg_range<kTile>(qseg_s, q0, g.sq);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int2 kr = kv_range(g, q0);
  for (int k0 = kr.x; k0 < kr.y; k0 += kTile) {
    __syncthreads();
    if (has_seg) {
      load_seg<kTile>(kseg_s, g.kseg, bi, k0, g.sk);
      __syncthreads();
      const int2 ksr = seg_range<kTile>(kseg_s, k0, g.sk);
      if (ksr.y < qsr.x || ksr.x > qsr.y) continue;
    }
    load_tile_bf16<D, kTile>(k_s, k, bi, k0, g.sk, g.hk, kvh);
    load_tile_bf16<D, kTile>(v_s, v, bi, k0, g.sk, g.hk, kvh);
    __syncthreads();

    float s[kTile / 8][4];
    mma_abt<D, kTile / 8>(s, q_s, k_s, wrow, grp, tid);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wrow + grp + 8 * half;
      float tmax = kNegInf;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + tid * 2 + e;
          float dcap;
          const float x = cap_score(g, s[n][2 * half + e], has_alibi, slope, q0 + r, k0 + c, &dcap);
          const bool ok = visible(g, q0 + r, k0 + c) &&
                          (!has_seg || qseg_s[r] == kseg_s[c]);
          s[n][2 * half + e] = ok ? x : kNegInf;
          tmax = fmaxf(tmax, s[n][2 * half + e]);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);
      const float alpha = m[half] == kNegInf ? 0.f : expf(m[half] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * half + e];
          x = x == kNegInf ? 0.f : expf(x - m_new);
          psum += x;    // l and the LSE stay undropped
          if (drop_on)
            x *= drop_factor(g, drow[half], drop_col(k0 + n * 8 + tid * 2 + e));
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[half] = alpha * l[half] + psum;
      m[half] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * half] *= alpha;
        acc[n][2 * half + 1] *= alpha;
      }
    }
    mma_pv<D, kTile / 16>(acc, s, v_s, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + wrow + grp + 8 * half;
    if (qi >= g.sq) continue;
    const float inv = l[half] == 0.f ? 0.f : 1.f / l[half];
    __nv_bfloat16* orow = o + ((size_t(bi) * g.sq + qi) * g.hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tid * 2) =
          pack_bf16(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    if (tid == 0)
      lse[(size_t(bi) * g.hq + h) * g.sq + qi] =
          l[half] == 0.f ? kNegInf : m[half] + logf(l[half]);
  }
}

// B2 on tensor cores
template <int D, bool EXTRA>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, Geom g) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kTile * LD;
  __nv_bfloat16* k_s = do_s + kTile * LD;
  __nv_bfloat16* v_s = k_s + kTile * LD;
  int* qseg_s = reinterpret_cast<int*>(v_s + kTile * LD);
  int* kseg_s = qseg_s + kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (g.hq / g.hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tid = lane & 3;
  const int wrow = warp * 16;
  const bool has_seg = g.qseg != nullptr;
  // ALiBi and dropout compile away from the EXTRA = false kernels
  const bool has_alibi = EXTRA && g.alibi != nullptr;
  const bool drop_on = EXTRA && g.drop_on;
  const float slope = has_alibi ? g.alibi[h] : 0.f;
  uint32_t drow[2] = {0u, 0u};
  if (drop_on) {
    const uint32_t base = drop_base(g, bi, h);
    drow[0] = drop_row(base, q0 + wrow + grp);
    drow[1] = drop_row(base, q0 + wrow + grp + 8);
  }

  load_tile_bf16<D, kTile>(q_s, q, bi, q0, g.sq, g.hq, h);
  load_tile_bf16<D, kTile>(do_s, dout, bi, q0, g.sq, g.hq, h);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + wrow + grp + 8 * half;
    const size_t at = (size_t(bi) * g.hq + h) * g.sq + qi;
    lse_r[half] = qi < g.sq ? lse[at] : 0.f;
    delta_r[half] = qi < g.sq ? delta[at] : 0.f;
  }
  int2 qsr = make_int2(0, 0);
  if (has_seg) {
    load_seg<kTile>(qseg_s, g.qseg, bi, q0, g.sq);
    __syncthreads();
    qsr = seg_range<kTile>(qseg_s, q0, g.sq);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int2 kr = kv_range(g, q0);
  for (int k0 = kr.x; k0 < kr.y; k0 += kTile) {
    __syncthreads();
    if (has_seg) {
      load_seg<kTile>(kseg_s, g.kseg, bi, k0, g.sk);
      __syncthreads();
      const int2 ksr = seg_range<kTile>(kseg_s, k0, g.sk);
      if (ksr.y < qsr.x || ksr.x > qsr.y) continue;
    }
    load_tile_bf16<D, kTile>(k_s, k, bi, k0, g.sk, g.hk, kvh);
    load_tile_bf16<D, kTile>(v_s, v, bi, k0, g.sk, g.hk, kvh);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_abt<D, kTile / 8>(s, q_s, k_s, wrow, grp, tid);
    mma_abt<D, kTile / 8>(dp, do_s, v_s, wrow, grp, tid);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int r = wrow + grp + 8 * half;
        const int c = n * 8 + tid * 2 + (e & 1);
        float dcap;
        const float x = cap_score(g, s[n][e], has_alibi, slope, q0 + r, k0 + c, &dcap);
        const bool ok = visible(g, q0 + r, k0 + c) &&
                        (!has_seg || qseg_s[r] == kseg_s[c]);
        const float p = ok ? expf(x - lse_r[half]) : 0.f;
        const float f = drop_on ? drop_factor(g, drow[half], drop_col(k0 + c)) : 1.f;
        s[n][e] = ds_core(drop_on, p, f, dp[n][e], delta_r[half]) * dcap * g.scale;
      }
    mma_pv<D, kTile / 16>(acc, s, k_s, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + wrow + grp + 8 * half;
    if (qi >= g.sq) continue;
    __nv_bfloat16* row = dq + ((size_t(bi) * g.sq + qi) * g.hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + tid * 2) =
          pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// B3 on tensor cores: each warp owns 16 keys, and walks the visible q
// rows 32 at a time
template <int D, bool EXTRA>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       Geom g) {
  constexpr int LD = D + 8;
  constexpr int NQ = kBqDkv / 8;     // n-tiles of q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTile * LD;
  __nv_bfloat16* q_s = v_s + kTile * LD;
  __nv_bfloat16* do_s = q_s + kBqDkv * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + kBqDkv * LD);
  float* delta_s = lse_s + kBqDkv;
  int* kseg_s = reinterpret_cast<int*>(delta_s + kBqDkv);
  int* qseg_s = kseg_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int group = g.hq / g.hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tid = lane & 3;
  const int wrow = warp * 16;
  const bool has_seg = g.qseg != nullptr;
  // ALiBi and dropout compile away from the EXTRA = false kernels
  const bool has_alibi = EXTRA && g.alibi != nullptr;
  const bool drop_on = EXTRA && g.drop_on;

  load_tile_bf16<D, kTile>(k_s, k, bi, k0, g.sk, g.hk, kvh);
  load_tile_bf16<D, kTile>(v_s, v, bi, k0, g.sk, g.hk, kvh);
  int2 ksr = make_int2(0, 0);
  if (has_seg) {
    load_seg<kTile>(kseg_s, g.kseg, bi, k0, g.sk);
    __syncthreads();
    ksr = seg_range<kTile>(kseg_s, k0, g.sk);
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // q rows that can see some key of this tile, in steps of kBqDkv
  const int khi = min(k0 + kTile, g.sk) - 1;
  int qbeg = 0;
  if (g.causal) qbeg = max(qbeg, k0 - g.shift);
  if (g.wr >= 0) qbeg = max(qbeg, k0 - g.wr - g.shift);
  int qend = g.sq;
  if (g.wl >= 0) qend = min(qend, khi + g.wl - g.shift + 1);
  qbeg = (qbeg / kBqDkv) * kBqDkv;

  uint32_t dcol[2] = {0u, 0u};            // this thread's keys
  if (drop_on) {
    dcol[0] = drop_col(k0 + wrow + grp);
    dcol[1] = drop_col(k0 + wrow + grp + 8);
  }
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;       // ALiBi and dropout go by q head
    const float slope = has_alibi ? g.alibi[h] : 0.f;
    const uint32_t dbase = drop_on ? drop_base(g, bi, h) : 0u;
    for (int q0 = qbeg; q0 < qend; q0 += kBqDkv) {
      __syncthreads();
      if (has_seg) {
        load_seg<kBqDkv>(qseg_s, g.qseg, bi, q0, g.sq);
        __syncthreads();
        const int2 qsr = seg_range<kBqDkv>(qseg_s, q0, g.sq);
        if (ksr.y < qsr.x || ksr.x > qsr.y) continue;
      }
      if (threadIdx.x < kBqDkv) {
        const int qi = q0 + threadIdx.x;
        const size_t at = (size_t(bi) * g.hq + h) * g.sq + qi;
        lse_s[threadIdx.x] = qi < g.sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = qi < g.sq ? delta[at] : 0.f;
      }
      load_tile_bf16<D, kBqDkv>(q_s, q, bi, q0, g.sq, g.hq, h);
      load_tile_bf16<D, kBqDkv>(do_s, dout, bi, q0, g.sq, g.hq, h);
      __syncthreads();

      float st[NQ][4], dpt[NQ][4];        // rows: keys, columns: q rows
      mma_abt<D, NQ>(st, k_s, q_s, wrow, grp, tid);
      mma_abt<D, NQ>(dpt, v_s, do_s, wrow, grp, tid);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wrow + grp + 8 * (e >> 1);     // key
          const int c = n * 8 + tid * 2 + (e & 1);     // q row
          float dcap;
          const float x = cap_score(g, st[n][e], has_alibi, slope, q0 + c, k0 + r, &dcap);
          const bool ok = visible(g, q0 + c, k0 + r) &&
                          (!has_seg || qseg_s[c] == kseg_s[r]);
          const float p = ok ? expf(x - lse_s[c]) : 0.f;
          const float f =
              drop_on ? drop_factor(g, drop_row(dbase, q0 + c), dcol[e >> 1]) : 1.f;
          st[n][e] = p * f;                // dV takes the dropped P
          dpt[n][e] = ds_core(drop_on, p, f, dpt[n][e], delta_s[c]) * dcap * g.scale;
        }
      mma_pv<D, kBqDkv / 16>(dv_acc, st, do_s, lane);
      mma_pv<D, kBqDkv / 16>(dk_acc, dpt, q_s, lane);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = k0 + wrow + grp + 8 * half;
    if (kj >= g.sk) continue;
    const size_t base = ((size_t(bi) * g.sk + kj) * g.hk + kvh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + n * 8 + tid * 2) =
          pack_bf16(dk_acc[n][2 * half], dk_acc[n][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + n * 8 + tid * 2) =
          pack_bf16(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int D, bool EXTRA>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int b, const Geom& g, cudaStream_t st) {
  const dim3 grid((g.sq + kTile - 1) / kTile, g.hq, b);
  if constexpr (kMma<T>) {
    constexpr size_t smem = fwd_mma_smem<D>();
    static const cudaError_t attr = set_smem(fwd_mma_kernel<D, EXTRA>, smem);
    if (attr != cudaSuccess) return attr;
    fwd_mma_kernel<D, EXTRA><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), g);
  } else {
    constexpr size_t smem = fwd_smem<D>();
    static const cudaError_t attr = set_smem(fwd_kernel<T, D, EXTRA>, smem);
    if (attr != cudaSuccess) return attr;
    fwd_kernel<T, D, EXTRA><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), g);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool EXTRA>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int b, const Geom& g, cudaStream_t st) {
  const dim3 grid((g.sq + kTile - 1) / kTile, g.hq, b);
  if constexpr (kMma<T>) {
    constexpr size_t smem = dq_mma_smem<D>();
    static const cudaError_t attr = set_smem(bwd_dq_mma_kernel<D, EXTRA>, smem);
    if (attr != cudaSuccess) return attr;
    bwd_dq_mma_kernel<D, EXTRA><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), g);
  } else {
    constexpr size_t smem = dq_smem<D>();
    static const cudaError_t attr = set_smem(bwd_dq_kernel<T, D, EXTRA>, smem);
    if (attr != cudaSuccess) return attr;
    bwd_dq_kernel<T, D, EXTRA><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), g);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool EXTRA>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int b, const Geom& g, cudaStream_t st) {
  const dim3 grid((g.sk + kTile - 1) / kTile, g.hk, b);
  if constexpr (kMma<T>) {
    constexpr size_t smem = dkv_mma_smem<D>();
    static const cudaError_t attr = set_smem(bwd_dkv_mma_kernel<D, EXTRA>, smem);
    if (attr != cudaSuccess) return attr;
    bwd_dkv_mma_kernel<D, EXTRA><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), g);
  } else {
    constexpr size_t smem = dkv_smem<D>();
    static const cudaError_t attr = set_smem(bwd_dkv_kernel<T, D, EXTRA>, smem);
    if (attr != cudaSuccess) return attr;
    bwd_dkv_kernel<T, D, EXTRA><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), g);
  }
  return cudaGetLastError();
}

Geom make_geom(const void* qseg, const void* kseg, const void* alibi, int sq, int sk,
               int hq, int hk, int causal, int wl, int wr, float scale, float softcap,
               int drop_on, unsigned drop_seed, unsigned drop_thresh, float drop_scale) {
  Geom g;
  g.qseg = static_cast<const int*>(qseg);
  g.kseg = static_cast<const int*>(kseg);
  g.alibi = static_cast<const float*>(alibi);
  g.sq = sq; g.sk = sk; g.hq = hq; g.hk = hk;
  g.causal = causal; g.wl = wl; g.wr = wr; g.shift = sk - sq;
  g.scale = scale; g.softcap = softcap;
  g.drop_on = drop_on; g.drop_seed = drop_seed; g.drop_thresh = drop_thresh;
  g.drop_scale = drop_scale;
  return g;
}

}  // namespace

// The C interface.  q/k/v/dout/o/dq/dk/dv are BSHD and contiguous, of
// dtype 0 = float32 or 1 = bfloat16; lse and delta are [b, hq, sq]
// float32; qseg/kseg are [b, sq] / [b, sk] int32, or both null; alibi is
// [hq] float32 slopes or null; with drop_on a pair is kept when its hash
// (drop_seed) is >= drop_thresh and kept P entries are scaled by
// drop_scale.  Each
// returns the cudaError_t of its launch (0 = success), launches on
// `stream` and does not synchronise.
// ALiBi and dropout have kernels of their own (EXTRA), so that the
// kernels of the plain training path carry none of their code
#define FLASH_DISPATCH_D(LAUNCH, T, DD, ...)                               \
  do {                                                                     \
    if (g.alibi != nullptr || g.drop_on) return LAUNCH<T, DD, true>(__VA_ARGS__); \
    return LAUNCH<T, DD, false>(__VA_ARGS__);                              \
  } while (0)
#define FLASH_DISPATCH(LAUNCH, ...)                                        \
  do {                                                                     \
    if (dtype == 0 && d == 32) FLASH_DISPATCH_D(LAUNCH, float, 32, __VA_ARGS__); \
    if (dtype == 0 && d == 128) FLASH_DISPATCH_D(LAUNCH, float, 128, __VA_ARGS__); \
    if (dtype == 1 && d == 32) FLASH_DISPATCH_D(LAUNCH, __nv_bfloat16, 32, __VA_ARGS__); \
    if (dtype == 1 && d == 128) FLASH_DISPATCH_D(LAUNCH, __nv_bfloat16, 128, __VA_ARGS__); \
    return cudaErrorInvalidValue;                                          \
  } while (0)

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* alibi, void* o, void* lse, int b, int sq, int sk,
    int hq, int hk, int d, int causal, int wl, int wr, float scale, float softcap,
    int drop_on, unsigned drop_seed, unsigned drop_thresh, float drop_scale,
    int dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const Geom g = make_geom(qseg, kseg, alibi, sq, sk, hq, hk, causal, wl, wr, scale,
                           softcap, drop_on, drop_seed, drop_thresh, drop_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, b, g, st);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* alibi, const void* dout, const void* lse,
    const void* delta, void* dq, int b, int sq, int sk, int hq, int hk, int d,
    int causal, int wl, int wr, float scale, float softcap, int drop_on,
    unsigned drop_seed, unsigned drop_thresh, float drop_scale, int dtype,
    void* stream) {
  if (b == 0 || sq == 0) return 0;
  const Geom g = make_geom(qseg, kseg, alibi, sq, sk, hq, hk, causal, wl, wr, scale,
                           softcap, drop_on, drop_seed, drop_thresh, drop_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, b, g, st);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* alibi, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int b, int sq, int sk, int hq, int hk,
    int d, int causal, int wl, int wr, float scale, float softcap, int drop_on,
    unsigned drop_seed, unsigned drop_thresh, float drop_scale, int dtype,
    void* stream) {
  if (b == 0 || sk == 0) return 0;
  const Geom g = make_geom(qseg, kseg, alibi, sq, sk, hq, hk, causal, wl, wr, scale,
                           softcap, drop_on, drop_seed, drop_thresh, drop_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, b, g, st);
}
