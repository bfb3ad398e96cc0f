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
 * inline, B1 ran 28% slower on an H100 (chip_smoke.py).
 *
 * The global offsets (B-1, the q/k/h/b entries of JAX's meta operand,
 * _make_meta :734) place the local tensors in the whole call's: every
 * mask, skip and ALiBi test reads Geom::shift = sk - sq + q_off - k_off
 * (JAX :198), and the dropout hash takes (b_off + b, h_off + h,
 * q_off + i, k_off + j) in drop_base/drop_row/drop_col (JAX :247), so
 * that a context-parallel ring step, a head shard or a batch shard draws
 * the masks of the whole call.  The walks bound their ranges by the
 * shift alone, so a large positive shift (every key of a chunk visible)
 * and a negative one (rows that see no key) take the same code.
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
 *  - bf16 (the training path) and f16 (the fp16 step under the loss
 *    scaler), every product on the tensor cores: fwd_wgmma_kernel,
 *    bwd_dq_wgmma_kernel and bwd_dkv_wgmma_kernel on wgmma, templates
 *    on the 16-bit type (wgmma .f32.bf16.bf16 or .f32.f16.f16, TMA maps
 *    of that type), fed by TMA through a ring of shared-memory stages by
 *    a producer warp, with two consumer warpgroups of 64 rows each (the
 *    section "B1, B2 and B3 in bf16 and f16");
 *  - f32 (the exact comparison with the plain version, which the card
 *    cannot make in bf16): fwd_kernel, bwd_dq_kernel and bwd_dkv_kernel
 *    run the dots on CUDA cores in f32, 256 threads each computing a
 *    4x4 block of scores from float4 shared-memory reads (8 loads per
 *    64 FMAs), rows padded to d + 4 floats so the 16 column threads hit
 *    distinct banks.
 *
 * Head dims 32, 64, 80 (Phi-2, Pythia-2.8B), 96 (Phi-3-mini), 128 and
 * 256 (Gemma) are built, one library a head dim (-DFLASH_HEAD_DIM).  At 256 the f32 B2 and B3 keep three tiles in shared memory
 * where they kept four (kReloadF32), and the wgmma kernels take fewer
 * stages and, in B3, half the head dim a consumer warpgroup (WgCfg).
 * At 80 and 96 the wgmma kernels store the head dim as 128 (two boxes,
 * the upper 48 or 32 columns zeros from TMA) and the f32 kernels'
 * threads own 5 columns each, one at a time, or 6, two at a time (Cols).
 *
 * What the design does about it, in both:
 *  - grid order: the TPU's kv axis (B1, B2) and (group, q) axes (B3)
 *    were sequential grid axes carrying VMEM scratch.  Here each CTA
 *    owns its output tile and loops over the other axis itself: one CTA
 *    per (batch, q head, 64 query rows) for the f32 B1 and B2, per
 *    (batch, q head, 128 query rows) for the bf16 B1 and B2, and per
 *    (batch, kv head, 64 keys; 128 in bf16) for B3, which sums dk/dv
 *    over every q head of its group and every visible q tile in
 *    registers and writes them once (no atomics, no per-q-head dk/dv in
 *    device memory, the same bits on every call);
 *  - only visible tiles are loaded: causality ends B1/B2's kv walk at
 *    the diagonal and starts B3's q walk there, the window bounds the
 *    other end, and a tile pair whose segment-id ranges do not meet is
 *    skipped (packed documents) — the work follows the visible pairs;
 *    the bf16 kernels mask only edge tiles (the diagonal, a window
 *    edge, a ragged end, more than one segment id);
 *  - heavy tiles first: under causality the last q tiles (B1/B2) and
 *    the first kv tiles (B3) see the most, so they are scheduled first;
 *  - online softmax in f32 with m, l and the output rows in registers;
 *  - the TPU's 1024^2 tiles and its 128-lane broadcasts of LSE and
 *    segment ids are not carried over: LSE [b, h, s] f32 and segment
 *    ids [b, s] int32 are read as they are, ragged edges are masked in
 *    the kernel, and nothing is padded or allocated here.
 */

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ptx.cuh"   // mbarriers, TMA, wgmma descriptors, the map encoder

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
  int q_off, k_off, h_off, b_off;    // global offsets the hash adds
};

// murmur3 finalizer, and the dropout hash of ops/_common.py: a pair is
// kept when mix32(mix32(base ^ q) ^ mix32(k * K')) >= thresh, with
// base = mix32(seed + batch * B' + q head), at the global coordinates
// (the offsets added to the local ones, in uint32 as JAX's)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t drop_base(const Geom& g, int bi, int h) {
  return mix32(g.drop_seed + uint32_t(g.b_off + bi) * 0x85EBCA6Bu + uint32_t(g.h_off + h));
}
__device__ __forceinline__ uint32_t drop_row(const Geom& g, uint32_t base, int qi) {
  return mix32(base ^ uint32_t(g.q_off + qi));
}
__device__ __forceinline__ uint32_t drop_col(const Geom& g, int kj) {
  return mix32(uint32_t(g.k_off + kj) * 0x9E3779B9u);
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
  // vector width: 4, or 2 at 32 and 96 (6), or 1 where DPT is odd (80: 5)
  static constexpr int VW = DPT % 4 == 0 ? 4 : DPT % 2 == 0 ? 2 : 1;
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
        } else if constexpr (C::VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(vrow + C::col(e, 0, tx));
          vv[0] = t.x; vv[1] = t.y;
        } else {
          vv[0] = vrow[C::col(e, 0, tx)];
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

// B2 and B3 in f32 at head dims past 128 keep three [64][D + kPad] tiles
// resident, not four: at 256 four are 266 KB, past the 227 KB a CTA may
// have.  B2 loads V into K's place for dP and K again for dS K; B3 loads
// dO into Q's place for dP and dV, and Q again for dS^T Q, and keeps one
// score tile (P~^T, then dS^T) where it kept two.  A third load of a tile
// from L2 costs less than the CTAs a larger block would leave idle.
template <int D>
constexpr bool kReloadF32 = D > 128;

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * size_t(kTile) * (D + kPad) + size_t(kTile) * kLdP) +
         sizeof(int) * 2 * kTile;
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((kReloadF32<D> ? 3 : 4) * size_t(kTile) * (D + kPad) +
                          size_t(kTile) * kLdP) +
         sizeof(int) * 2 * kTile;
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((kReloadF32<D> ? 3 : 4) * size_t(kTile) * (D + kPad) +
                          (kReloadF32<D> ? 1 : 2) * size_t(kTile) * kLdP + 2 * kTile) +
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
    for (int i = 0; i < 4; ++i) drow[i] = drop_row(g, base, q0 + ty * 4 + i);
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
            drop_on ? p * drop_factor(g, drow[i], drop_col(g, k0 + tx + 16 * j)) : p;
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
  constexpr bool kReload = kReloadF32<D>;
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = kReload ? k_s : k_s + kTile * LD;   // with kReload V takes K's place
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
    for (int i = 0; i < 4; ++i) drow[i] = drop_row(g, base, q0 + ty * 4 + i);
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
    if constexpr (!kReload) load_tile<T, D>(v_s, v, bi, k0, g.sk, g.hk, kvh);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<D>(s, q_s, k_s, ty, tx);
    if constexpr (kReload) {
      __syncthreads();   // every thread is done with K
      load_tile<T, D>(v_s, v, bi, k0, g.sk, g.hk, kvh);
      __syncthreads();
    }
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
        const float f = drop_on ? drop_factor(g, drow[i], drop_col(g, k0 + c)) : 1.f;
        ds_s[r * kLdP + c] = ds_core(drop_on, p, f, dp[i][j], delta_r[i]) * dcap * g.scale;
      }
    }
    if constexpr (kReload) {
      __syncthreads();   // every thread is done with V: K again for dS K
      load_tile<T, D>(k_s, k, bi, k0, g.sk, g.hk, kvh);
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
  constexpr bool kReload = kReloadF32<D>;
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = kReload ? q_s : q_s + kTile * LD;   // with kReload dO takes Q's place
  float* pt_s = do_s + kTile * LD;       // P^T  [key][q row]
  float* dst_s = kReload ? pt_s : pt_s + kTile * kLdP;   // dS^T [key][q row]
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
    for (int i = 0; i < 4; ++i) dcol[i] = drop_col(g, k0 + ty * 4 + i);
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
      if constexpr (!kReload) load_tile<T, D>(do_s, dout, bi, q0, g.sq, g.hq, h);
      __syncthreads();

      float s[4][4], dp[4][4];
      dot_tile<D>(s, k_s, q_s, ty, tx);     // rows: keys, columns: q rows
      if constexpr (kReload) {
        __syncthreads();   // every thread is done with Q
        load_tile<T, D>(do_s, dout, bi, q0, g.sq, g.hq, h);
        __syncthreads();
      }
      dot_tile<D>(dp, v_s, do_s, ty, tx);
      // P~^T into s, dS^T into dp
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
              drop_on ? drop_factor(g, drop_row(g, dbase, q0 + c), dcol[i]) : 1.f;
          s[i][j] = p * f;                 // dV takes the dropped P
          dp[i][j] = ds_core(drop_on, p, f, dp[i][j], delta_s[c]) * dcap * g.scale;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pt_s[(ty * 4 + i) * kLdP + tx + 16 * j] = s[i][j];
      if constexpr (kReload) {
        __syncthreads();
        pv_tile<D>(dv_acc, pt_s, do_s, ty, tx);
        __syncthreads();   // every thread is done with P~^T and dO: dS^T, and Q again
        load_tile<T, D>(q_s, q, bi, q0, g.sq, g.hq, h);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst_s[(ty * 4 + i) * kLdP + tx + 16 * j] = dp[i][j];
      __syncthreads();
      if constexpr (!kReload) pv_tile<D>(dv_acc, pt_s, do_s, ty, tx);
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
// B1, B2 and B3 in bf16 and f16: wgmma fed by TMA through a ring of
// shared-memory stages
// ---------------------------------------------------------------------------
//
// One CTA of three warpgroups.  Warp 0 is the producer: it walks the
// visible tiles of the CTA's other axis (each lane probes one of the next
// 32 tiles for a segment id in common; B1 reads the 32 tiles' ids from
// one bulk copy into shared memory), brings each in by TMA into the
// next stage of a ring (full/empty mbarrier pairs) with the tile's rows'
// segment ids (and in B3 their LSE and delta) beside it, and ends the
// walk with a stage marked -1.  The two consumer warpgroups own 64 rows
// each of the CTA's 128 and run every product on wgmma: the scores and
// dP from shared memory (both operands K-major), the second products
// with A (P, P~ or dS) from registers and B read through wgmma's
// transpose flag (MN-major).  Only edge tiles (the diagonal, a window
// edge, a ragged end, more than one segment id) take the masks; the
// others run a loop of an fma, an ex2 and the dS arithmetic (B1: the
// online softmax).  setmaxnreg moves registers from the producer
// warpgroup to the consumers.
//
// Tiles lie in shared memory as [rows][64] 16-bit boxes of 128-byte rows
// under the 128-byte swizzle, one box a 64 columns of the head dim (the
// head dims built are 32, 64, 80, 96, 128 and 256: 64 is one box, 128
// two, 256 four; 32 is read as one box of 64 whose upper half TMA fills
// with zeros, so 32 and 64 share shared-memory sizes, and 80 (Phi-2) and
// 96 (Phi-3) as two boxes whose columns 80-127 or 96-127 TMA fills with
// zeros, so they run 128's layout, stages and products, and their
// epilogues store columns < 80 or < 96).
// At 256 (Gemma) the second products are m64n256 and the shared memory
// holds fewer stages (WgCfg), and B3 splits the head dim between its
// consumer warpgroups.  A rank-4 tensor map over [b, s, h, d] cuts a
// head's rows out of the BSHD tensor; rows past s read as zeros.
//
// P, P~ and dS enter the second products as hi + lo, two values of the
// input type each (split2): rounding them once to bf16, as the JAX kernels do,
// leaves dq, dk and dv 2.7-13x and o 1.6-3.2x the one-ulp tolerance from
// the f32 plain versions, and in f16, with 3 more bits, o, dq, dk and dv
// still 1.6-5.5x the two-ulp f16 tolerance (hi + lo: 0.34-0.43x;
// tests/test_torch_flash_attention.py rehearses both on the CPU), so each
// second product is two wgmma.

constexpr int kWgThreads = 384;    // the producer warpgroup and two consumer warpgroups
constexpr int kBlk = 128;          // rows a CTA owns: 64 a consumer warpgroup
constexpr int kStep = 64;          // rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct WgCfg {
  static constexpr int DP = (D + 63) / 64 * 64; // head dim as stored
  static constexpr int NB = DP / 64;            // 128-byte boxes a row spans
  static constexpr int kRes = kBlk * DP * 2;    // a resident [128][DP] tile, bytes
  static constexpr int kTileB = kStep * DP * 2; // a streamed [64][DP] tile, bytes
  // ring stages, chosen on an H100: B3 ran 3-6% faster on 2 than on 3 at
  // heads of 128; at 64, B2 and B3 on 3 and 2 stages ran no faster than
  // on 4 (B3 1.5% slower), so 64 keeps 32's 4.  At 256 a stage is 64 KB:
  // B1 takes 2 beside its 64 KB of Q, B2 1 beside its 128 KB of Q and dO
  // (227 KB a CTA)
  static constexpr int kStagesFwd = DP == 256 ? 2 : 4;
  static constexpr int kStagesDq = DP == 256 ? 1 : DP == 128 ? 3 : 4;
  static constexpr int kStagesDkv = DP == 128 || DP == 256 ? 2 : 4;
  // B3 past 128: dk and dv of 64 keys are 2 x 128 f32 a consumer thread,
  // past the 255 registers a thread has, so a CTA takes 64 keys and each
  // consumer warpgroup half of the head dim of both (kHalf)
  static constexpr bool kHalf = DP > 128;
  static constexpr int kBlkDkv = kHalf ? 64 : kBlk;   // keys a B3 CTA
};

// what the producer leaves beside a stage's tiles
struct StageInfo {
  int pos;              // first row of the tile (B1, B2: a key; B3: a q row); -1: no more
  int head;             // the q head (B3)
  int seg_edge;         // segment ids not one id shared with the CTA's rows
  int seg_lo, seg_hi;   // the least and greatest of the tile's rows' segment ids (B1)
  int meet;             // bit c: the ids meet those of rows [q0 + 64c, + 64) (B1)
  int seg[kStep];       // the tile's rows' segment ids
};

// B3: the stage's q rows' LSE times log2(e), and delta
struct RowStats {
  float lse2[kStep];
  float delta[kStep];
};

// RES resident tiles of RROWS rows, two streamed tiles a stage, the stage
// notes (and for B3 the row statistics), 2 barriers a stage and one, and
// 1 KB to align to the swizzle period
template <int D, int S, bool STATS, int RES = 2, int RROWS = kBlk>
constexpr size_t wg_smem() {
  using C = WgCfg<D>;
  return RES * size_t(RROWS) * C::DP * 2 + 2 * size_t(C::kTileB) * S +
         (sizeof(StageInfo) + (STATS ? sizeof(RowStats) : 0)) * S + 8 * (2 * S + 1) + 1024;
}

// 2^x on the special-function unit; flushes results below 2^-126 to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 16-bit input types of the wgmma kernels: bf16 (the training
// path) and f16 (the fp16 step under the loss scaler); both multiply on
// the tensor cores with f32 sums, at the same dense rate
template <typename T>
constexpr bool kWg16 = std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;

// two f32 -> one register of two T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// x0, x1 as the sum of two pairs of T: hi = T(x), lo = T(x - hi)
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// kv range [begin, end) that some row of q rows [q0, q0 + n) can see,
// begin rounded down to a multiple of kStep
__device__ __forceinline__ int2 kv_span(const Geom& g, int q0, int n) {
  const int qlo = q0 + g.shift;
  const int qhi = min(q0 + n, g.sq) - 1 + g.shift;
  int begin = g.wl >= 0 ? max(0, qlo - g.wl) : 0;
  int end = g.sk;
  if (g.causal) end = min(end, qhi + 1);
  if (g.wr >= 0) end = min(end, qhi + g.wr + 1);
  return make_int2((begin / kStep) * kStep, end);
}

// q range [begin, end) of the rows that can see some key of [k0, k0 + n),
// begin rounded down to a multiple of kStep
__device__ __forceinline__ int2 q_span(const Geom& g, int k0, int n) {
  const int khi = min(k0 + n, g.sk) - 1;
  int begin = 0;
  if (g.causal) begin = max(begin, k0 - g.shift);
  if (g.wr >= 0) begin = max(begin, k0 - g.wr - g.shift);
  int end = g.sq;
  if (g.wl >= 0) end = min(end, khi + g.wl - g.shift + 1);
  return make_int2((begin / kStep) * kStep, end);
}

// does some pair of q rows [q0, q1) and keys [k0, k1) pass the causal and
// window masks (a bounding test: false means none does)
__device__ __forceinline__ bool any_visible(const Geom& g, int q0, int q1, int k0, int k1) {
  q1 = min(q1, g.sq);
  k1 = min(k1, g.sk);
  if (q0 >= q1 || k0 >= k1) return false;
  const int qlo = q0 + g.shift, qhi = q1 - 1 + g.shift;
  if (g.causal && k0 > qhi) return false;
  if (g.wl >= 0 && k1 - 1 < qlo - g.wl) return false;
  if (g.wr >= 0 && k0 > qhi + g.wr) return false;
  return true;
}

// does every pair pass them (no mask needed but the segments')
__device__ __forceinline__ bool all_visible(const Geom& g, int q0, int q1, int k0, int k1) {
  if (q1 > g.sq || k1 > g.sk) return false;
  const int qlo = q0 + g.shift, qhi = q1 - 1 + g.shift;
  if (g.causal && k1 - 1 > qlo) return false;
  if (g.wl >= 0 && k0 < qhi - g.wl) return false;
  if (g.wr >= 0 && k1 - 1 > qlo + g.wr) return false;
  return true;
}

// the keys [lo, hi] that q row qi may see by the causal and window masks
// (hi < lo: none; a row past sq sees none)
__device__ __forceinline__ int2 key_bounds(const Geom& g, int qi) {
  const int qp = qi + g.shift;
  int lo = g.wl >= 0 ? qp - g.wl : 0;
  int hi = g.sk - 1;
  if (g.causal) hi = min(hi, qp);
  if (g.wr >= 0) hi = min(hi, qp + g.wr);
  if (qi >= g.sq) hi = -1;
  return make_int2(max(lo, 0), hi);
}

// the q rows [lo, hi] that may see key kj by the causal and window masks
// (hi < lo: none; a key past sk is seen by none)
__device__ __forceinline__ int2 query_bounds(const Geom& g, int kj) {
  int lo = 0;
  if (g.causal) lo = max(lo, kj - g.shift);
  if (g.wr >= 0) lo = max(lo, kj - g.wr - g.shift);
  int hi = g.sq - 1;
  if (g.wl >= 0) hi = min(hi, kj + g.wl - g.shift);
  if (kj >= g.sk) hi = -1;
  return make_int2(lo, hi);
}

// segment ids of rows [row0, row0 + 32 N) below S, N a lane (rows
// row0 + lane + 32 i), and their [min, max] over the warp
template <int N>
__device__ __forceinline__ int2 warp_seg_span(const int* seg, int row0, int S, int lane,
                                              int (&v)[N]) {
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = row0 + lane + 32 * i;
    v[i] = r < S ? seg[r] : 0;
    if (r < S) {
      lo = min(lo, v[i]);
      hi = max(hi, v[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// bit i: tile [base + 64 i, + 64), below `end`, holds a segment id in
// `span` (every tile below `end` without segments); each lane probes
// one tile, so 32 tiles cost one pass of loads, not 32 round trips
__device__ __forceinline__ unsigned tiles_meeting(const int* seg, int base, int end, int S,
                                                  int2 span, bool has_seg, int lane) {
  const int t0 = base + lane * kStep;
  bool hit = t0 < end;
  if (has_seg && hit) {
    int lo = INT_MAX, hi = INT_MIN;
    const int n = min(kStep, S - t0);
#pragma unroll 8
    for (int r = 0; r < n; ++r) {
      const int v = __ldg(seg + t0 + r);
      lo = min(lo, v);
      hi = max(hi, v);
    }
    hit = hi >= span.x && lo <= span.y;
  }
  return __ballot_sync(0xffffffffu, hit);
}

// the tile's segment ids are one id, the same as every one of the CTA's
__device__ __forceinline__ bool seg_uniform(int2 a, int2 b) {
  return a.x == a.y && b.x == b.y && a.x == b.x;
}

// S = A B^T over 16 of K, m64n64k16, both operands K-major in shared
// memory; d = a b + (scale_d ? d : 0).  T: bf16 or f16 operands
#define WGMMA_SS(TY)                                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" HP_R32      \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                       \
      : HP_D32("+f", 0)                                                       \
      : "l"(a), "l"(b), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    WGMMA_SS("f16");
  else
    WGMMA_SS("bf16");
}

// d += A B over 16 of K: A from registers (a fragment of T), B MN-major
// in shared memory (the transpose flag); N = 64, 128 or 256
#define WGMMA_RS32(TY)                                                        \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" HP_R32      \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                         \
      : HP_D32("+f", 0)                                                       \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))
#define WGMMA_RS64(TY)                                                        \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" HP_R64     \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                         \
      : HP_D64("+f", 0)                                                       \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))
#define WGMMA_RS128(TY)                                                       \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" HP_R128    \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                    \
      : HP_D64("+f", 0), HP_D64("+f", 64)                                     \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    WGMMA_RS32("f16");
  else
    WGMMA_RS32("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    WGMMA_RS64("f16");
  else
    WGMMA_RS64("bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    WGMMA_RS128("f16");
  else
    WGMMA_RS128("bf16");
}

// acc (64 rows of this warpgroup) = A[rows] . B^T over DP columns: A the
// 64 rows at `a` of a resident or streamed tile whose boxes are `a_box`
// bytes apart, B the 64 rows at `b` of a tile with boxes `b_box` apart
template <typename T, int DP>
__device__ __forceinline__ void scores(float (&acc)[32], const unsigned char* a, int a_box,
                                       const unsigned char* b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;   // 16 columns = 32 bytes
    wgmma_ss<T>(acc, smem_desc(a + box * a_box + off), smem_desc(b + box * b_box + off), kk > 0);
  }
}

// acc += X . B over the tile's 64 rows of K: X as hi + lo bf16 fragments
// (4 registers a k16 slice), B the [64][DP] tile at `b` (MN-major)
template <typename T, int DP>
__device__ __forceinline__ void product_hilo(float (&acc)[DP / 2], const uint32_t (&hi)[16],
                                             const uint32_t (&lo)[16], const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    const uint64_t desc = smem_desc_mn(b + kk * 16 * 128, kStep * 128);
    wgmma_rs<T>(acc, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3], desc);
    wgmma_rs<T>(acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3], desc);
  }
}

// a 64 x 64 accumulator as the A fragments of its k16 slices, hi + lo:
// register 4 kk + m holds the values of accumulator registers
// 8 kk + 2 m and 8 kk + 2 m + 1 (the wgmma register layouts of the
// accumulator and of A agree)
template <typename T>
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[16],
                                            uint32_t (&lo)[16]) {
#pragma unroll
  for (int m = 0; m < 16; ++m) split2<T>(x[2 * m], x[2 * m + 1], hi[m], lo[m]);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  if (lane == 0) mbar_arrive(bar);
}

constexpr int kWin = 32 * kStep;   // keys of a probe window: 32 tiles, one a lane

// keys [base, base + n) of `seg` into the shared window `win`, by one
// bulk copy where `seg + base` is 16-byte aligned (the last n % 4 by
// loads), else by the warp's loads; every lane returns once `win` holds
// them.  `parity` is the phase of `bar` to wait for; it flips when the
// bulk copy ran.
__device__ __forceinline__ void load_window(int* win, const int* seg, int base, int n,
                                            uint64_t* bar, int& parity, int lane) {
  const int* src = seg + base;
  const int nb = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n & ~3 : 0;
  fence_proxy_async();        // the last window's reads before the copy's writes
  __syncwarp();
  if (nb > 0 && lane == 0) {
    mbar_expect_tx(bar, nb * 4);
    bulk_load(win, src, nb * 4, bar);
  }
  for (int i = nb + lane; i < n; i += 32) win[i] = __ldg(src + i);
  if (nb > 0) {
    mbar_wait(bar, parity);
    parity ^= 1;
  }
  __syncwarp();
}

// tiles_meeting from a window in shared memory: lane i reads tile i's
// ids starting at its own offset, so the 32 lanes hit 32 banks
__device__ __forceinline__ unsigned tiles_meeting_win(const int* win, int base, int end, int S,
                                                      int2 span, int lane) {
  const int t0 = base + lane * kStep;
  bool hit = t0 < end;
  if (hit) {
    int lo = INT_MAX, hi = INT_MIN;
    const int n = min(kStep, S - t0);
    const int* tile = win + lane * kStep;
#pragma unroll 8
    for (int r = 0; r < kStep; ++r) {
      const int j = (r + lane) & (kStep - 1);
      if (j < n) {
        lo = min(lo, tile[j]);
        hi = max(hi, tile[j]);
      }
    }
    hit = hi >= span.x && lo <= span.y;
  }
  return __ballot_sync(0xffffffffu, hit);
}

// The producer warp of B1 and B2: walks the key tiles that q rows
// [q0, q0 + 128) may see (kv_span; with segment ids only the tiles that
// share one with those rows, 32 probed at a time), brings each tile's K
// and V by TMA into the next stage of the ring with its keys' segment
// ids beside it, and ends the walk with a stage marked -1.  With `win`
// (kWin ints of shared memory and its barrier, B1) each probe window's
// key segment ids come in by one bulk copy and are read from there;
// without it (B2) every lane loads its tile's ids from global memory.
template <int D, int S>
__device__ __forceinline__ void walk_keys(const CUtensorMap* map_k, const CUtensorMap* map_v,
                                          unsigned char* ring, StageInfo* info, uint64_t* full,
                                          uint64_t* empty, const Geom& g, int q0, int bi,
                                          int kvh, int lane, int* win = nullptr,
                                          uint64_t* win_bar = nullptr) {
  using C = WgCfg<D>;
  const bool has_seg = g.qseg != nullptr;
  int2 qsr = make_int2(0, 0);
  if (has_seg) {
    int v[kBlk / 32];
    qsr = warp_seg_span<kBlk / 32>(g.qseg + size_t(bi) * g.sq, q0, g.sq, lane, v);
  }
  const int2 kr = kv_span(g, q0, kBlk);
  const int* kseg = has_seg ? g.kseg + size_t(bi) * g.sk : nullptr;
  const bool use_win = has_seg && win != nullptr;
  int2 hsr[2] = {qsr, qsr};          // each consumer warpgroup's rows' ids (B1)
  if (use_win) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int v[2];
      hsr[c] = warp_seg_span<2>(g.qseg + size_t(bi) * g.sq, q0 + 64 * c, g.sq, lane, v);
    }
  }
  int it = 0, parity = 0;
  for (int base = kr.x; base < kr.y; base += kWin) {
    // the next 32 key tiles that share a segment with the CTA's rows
    unsigned todo;
    if (use_win) {
      load_window(win, kseg, base, min(kWin, g.sk - base), win_bar, parity, lane);
      todo = tiles_meeting_win(win, base, kr.y, g.sk, qsr, lane);
    } else {
      todo = tiles_meeting(kseg, base, kr.y, g.sk, qsr, has_seg, lane);
    }
    for (; todo; todo &= todo - 1) {
      const int k0 = base + (__ffs(todo) - 1) * kStep;
      int seg[kStep / 32] = {0, 0};
      int2 ksr = make_int2(0, 0);
      if (use_win)
        ksr = warp_seg_span<kStep / 32>(win + (k0 - base), 0, g.sk - k0, lane, seg);
      else if (has_seg)
        ksr = warp_seg_span<kStep / 32>(kseg, k0, g.sk, lane, seg);
      const int s = it % S;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);       // the first round passes
      StageInfo& in = info[s];
      in.seg[lane] = seg[0];
      in.seg[lane + 32] = seg[1];
      if (lane == 0) {
        in.pos = k0;
        in.seg_edge = has_seg && !seg_uniform(ksr, qsr);
        in.seg_lo = ksr.x;
        in.seg_hi = ksr.y;
        in.meet = (ksr.y >= hsr[0].x && ksr.x <= hsr[0].y) |
                  (ksr.y >= hsr[1].x && ksr.x <= hsr[1].y) << 1;
        mbar_expect_tx(&full[s], 2 * C::kTileB);
        unsigned char* ks = ring + s * 2 * C::kTileB;
#pragma unroll
        for (int b = 0; b < C::NB; ++b) {
          tma_load4(ks + b * kStep * 128, map_k, 64 * b, kvh, k0, bi, &full[s]);
          tma_load4(ks + C::kTileB + b * kStep * 128, map_v, 64 * b, kvh, k0, bi, &full[s]);
        }
      } else {
        mbar_arrive(&full[s]);
      }
      ++it;
    }
  }
  const int s = it % S;                                // no more tiles
  mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
  if (lane == 0) info[s].pos = -1;
  mbar_arrive(&full[s]);
}

// B1 on wgmma: one CTA per (batch, q head, 128 q rows), keys streamed 64
// at a time.  Each consumer thread holds two rows' online softmax: the
// running max m (log2 units), its share of the row sum l (the quad's four
// shares are added at the end) and its 64 x DP/2 slice of O, all f32.
// Scores are taken as the raw dot and scaled inside the exponent's fma
// (scale * log2 e, one ex2 a score); softcap and ALiBi take the general
// loop in natural units.  The LSE is m ln 2 + log l, with logf.
template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,   // boxes of 128 rows
                     const __grid_constant__ CUtensorMap map_k,   // boxes of 64 rows
                     const __grid_constant__ CUtensorMap map_v,
                     T* __restrict__ o, float* __restrict__ lse, Geom g) {
  using C = WgCfg<D>;
  constexpr int S = C::kStagesFwd, DP = C::DP;
  extern __shared__ __align__(1024) unsigned char wg_buf[];
  unsigned char* q_s = align1024(wg_buf);
  unsigned char* ring = q_s + C::kRes;                   // S x (K, V)
  int* win = reinterpret_cast<int*>(ring + 2 * S * C::kTileB);  // a probe window's key ids
  StageInfo* info = reinterpret_cast<StageInfo*>(win + kWin);
  uint64_t* full = reinterpret_cast<uint64_t*>(info + S);
  uint64_t* empty = full + S;
  uint64_t* res = empty + S;
  uint64_t* win_bar = res + 1;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;   // heavy tiles first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (g.hq / g.hk);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);   // every producer lane; lane 0 with the bytes
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    mbar_init(res, 1);
    mbar_init(win_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(res, C::kRes);
#pragma unroll
        for (int b = 0; b < C::NB; ++b)
          tma_load4(q_s + b * kBlk * 128, &map_q, 64 * b, h, q0, bi, res);
      }
      walk_keys<D, S>(&map_k, &map_v, ring, info, full, empty, g, q0, bi, kvh, lane, win,
                      win_bar);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tc = threadIdx.x - 128;
    const int c = tc >> 7;                     // rows [q0 + 64c, + 64)
    const int warp = (tc >> 5) & 3, lane = tc & 31;
    const int grp = lane >> 2, t4 = lane & 3;
    const int qc0 = q0 + 64 * c, qw0 = qc0 + 16 * warp;
    const bool has_seg = g.qseg != nullptr;
    // ALiBi and dropout compile away from the EXTRA = false kernels
    const bool has_alibi = EXTRA && g.alibi != nullptr;
    const bool drop_on = EXTRA && g.drop_on;
    // the plain path scales the raw dot inside the exponent, so that the
    // row max of the raw dots is the max of the scores: scale > 0
    const bool plain = !has_alibi && g.softcap == 0.f && g.scale > 0.f;
    const float slope = has_alibi ? g.alibi[h] : 0.f;
    // the factor that takes a score to log2 units: the raw dot on the
    // plain path, the scaled, capped and biased score on the general one
    const float to2 = plain ? g.scale * kLog2e : kLog2e;
    // this thread's rows: qw0 + grp + 8 hh, the keys [kb.x, kb.y] each
    // may see by the causal and window masks, and the warp's rows'
    // segment ids (an interior tile of one id needs no segment mask)
    int qseg_r[2];
    int2 kb[2];
    uint32_t drow[2];
    int2 wsr = make_int2(INT_MAX, INT_MIN);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qw0 + grp + 8 * hh;
      qseg_r[hh] = has_seg && qi < g.sq ? g.qseg[size_t(bi) * g.sq + qi] : 0;
      if (qi < g.sq) {
        wsr.x = min(wsr.x, qseg_r[hh]);
        wsr.y = max(wsr.y, qseg_r[hh]);
      }
      kb[hh] = key_bounds(g, qi);
      drow[hh] = drop_on ? drop_row(g, drop_base(g, bi, h), qi) : 0u;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      wsr.x = min(wsr.x, __shfl_xor_sync(0xffffffffu, wsr.x, off));
      wsr.y = max(wsr.y, __shfl_xor_sync(0xffffffffu, wsr.y, off));
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(res, 0);

    for (int it = 0;; ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const StageInfo& in = info[s];
      const int k0 = in.pos;
      if (k0 < 0) break;
      if (!any_visible(g, qc0, qc0 + 64, k0, k0 + kStep) || (has_seg && !(in.meet >> c & 1))) {
        release(&empty[s], lane);
        continue;
      }
      // an edge for this warp's 16 rows: a mask cuts the tile, or its
      // keys and the rows are not all of one segment
      const bool edge = !all_visible(g, qw0, qw0 + 16, k0, k0 + kStep) ||
                        (has_seg && !(in.seg_lo == in.seg_hi && wsr.x == wsr.y &&
                                      in.seg_lo == wsr.x));
      const unsigned char* ks = ring + s * 2 * C::kTileB;
      const unsigned char* vs = ks + C::kTileB;

      float sc[32];
      wgmma_fence();
      scores<T, DP>(sc, q_s + c * 64 * 128, kBlk * 128, ks, kStep * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // register 4 j + 2 hh + e is row qw0 + grp + 8 hh, key
      // k0 + 8 j + 2 t4 + e; a masked score becomes kNegInf
      if (!plain) {                         // softcap, ALiBi: natural units
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kseg = has_seg ? *reinterpret_cast<const int2*>(&in.seg[8 * j + 2 * t4])
                                    : make_int2(0, 0);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              const int kj = k0 + 8 * j + 2 * t4 + e;
              float dcap;
              sc[i] = cap_score(g, sc[i], has_alibi, slope, qw0 + grp + 8 * hh, kj, &dcap);
              if (edge && !(kj >= kb[hh].x && kj <= kb[hh].y &&
                            (!has_seg || qseg_r[hh] == (e ? kseg.y : kseg.x))))
                sc[i] = kNegInf;
            }
        }
      } else if (edge) {                    // an edge tile of the plain path
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kseg = has_seg ? *reinterpret_cast<const int2*>(&in.seg[8 * j + 2 * t4])
                                    : make_int2(0, 0);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              const int kj = k0 + 8 * j + 2 * t4 + e;
              if (!(kj >= kb[hh].x && kj <= kb[hh].y &&
                    (!has_seg || qseg_r[hh] == (e ? kseg.y : kseg.x))))
                sc[i] = kNegInf;
            }
        }
      }
      // the online softmax: the tile's row max over the quad, then
      // P = 2^(score * to2 - m), 0 where masked, and O rescaled by alpha
      // where a row's max moved (m = 0 stands in for the max of a row
      // that has seen no key yet, so that 2^(-m) stays finite)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float mu[2], alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m2[hh], mx[hh] == kNegInf ? kNegInf : mx[hh] * to2);
        alpha[hh] = exp2_ftz(m2[hh] - m_new);
        m2[hh] = m_new;
        mu[hh] = m_new == kNegInf ? 0.f : m_new;
        l[hh] *= alpha[hh];
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          sc[i] = sc[i] == kNegInf ? 0.f : exp2_ftz(fmaf(sc[i], to2, -mu[hh]));
          l[hh] += sc[i];     // l and the LSE stay undropped
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          sc[i] = exp2_ftz(fmaf(sc[i], to2, -mu[hh]));
          l[hh] += sc[i];
        }
      }
      if (drop_on) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          const int kj = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          sc[i] *= drop_factor(g, drow[hh], drop_col(g, kj));
        }
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      uint32_t hi[16], lo[16];
      split_frags<T>(sc, hi, lo);
      wgmma_fence();
      product_hilo<T, DP>(acc, hi, lo, vs);    // O += P V
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      release(&empty[s], lane);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qw0 + grp + 8 * hh;
      if (qi >= g.sq) continue;
      const float inv = l[hh] == 0.f ? 0.f : 1.f / l[hh];
      T* row = o + ((size_t(bi) * g.sq + qi) * g.hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
            pack2<T>(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
      if (t4 == 0)
        lse[(size_t(bi) * g.hq + h) * g.sq + qi] =
            l[hh] == 0.f ? kNegInf : m2[hh] * kLn2 + logf(l[hh]);
    }
  }
}

// B2 on wgmma: one CTA per (batch, q head, 128 q rows), keys streamed 64
// at a time
template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,    // boxes of 128 rows
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_k,    // boxes of 64 rows
                        const __grid_constant__ CUtensorMap map_v,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Geom g) {
  using C = WgCfg<D>;
  constexpr int S = C::kStagesDq, DP = C::DP;
  extern __shared__ __align__(1024) unsigned char wg_buf[];
  unsigned char* q_s = align1024(wg_buf);
  unsigned char* do_s = q_s + C::kRes;
  unsigned char* ring = do_s + C::kRes;                  // S x (K, V)
  StageInfo* info = reinterpret_cast<StageInfo*>(ring + 2 * S * C::kTileB);
  uint64_t* full = reinterpret_cast<uint64_t*>(info + S);
  uint64_t* empty = full + S;
  uint64_t* res = empty + S;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;   // heavy tiles first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (g.hq / g.hk);
  const bool has_seg = g.qseg != nullptr;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);   // every producer lane; lane 0 with the bytes
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    mbar_init(res, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(res, 2 * C::kRes);
#pragma unroll
        for (int b = 0; b < C::NB; ++b) {
          tma_load4(q_s + b * kBlk * 128, &map_q, 64 * b, h, q0, bi, res);
          tma_load4(do_s + b * kBlk * 128, &map_do, 64 * b, h, q0, bi, res);
        }
      }
      walk_keys<D, S>(&map_k, &map_v, ring, info, full, empty, g, q0, bi, kvh, lane);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tc = threadIdx.x - 128;
    const int c = tc >> 7;                     // rows [q0 + 64c, + 64)
    const int warp = (tc >> 5) & 3, lane = tc & 31;
    const int grp = lane >> 2, t4 = lane & 3;
    const int qc0 = q0 + 64 * c;
    // ALiBi and dropout compile away from the EXTRA = false kernels
    const bool has_alibi = EXTRA && g.alibi != nullptr;
    const bool drop_on = EXTRA && g.drop_on;
    const bool plain = !has_alibi && g.softcap == 0.f;
    const float slope = has_alibi ? g.alibi[h] : 0.f;
    const float sl2 = g.scale * kLog2e;
    // this thread's rows: qc0 + 16 warp + grp + 8 hh
    float lse2[2], delta_r[2];
    int qseg_r[2];
    uint32_t drow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qc0 + 16 * warp + grp + 8 * hh;
      const size_t at = (size_t(bi) * g.hq + h) * g.sq + qi;
      lse2[hh] = qi < g.sq ? lse[at] * kLog2e : 0.f;
      delta_r[hh] = qi < g.sq ? delta[at] : 0.f;
      qseg_r[hh] = has_seg && qi < g.sq ? g.qseg[size_t(bi) * g.sq + qi] : 0;
      drow[hh] = drop_on ? drop_row(g, drop_base(g, bi, h), qi) : 0u;
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    mbar_wait(res, 0);

    for (int it = 0;; ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const StageInfo& in = info[s];
      const int k0 = in.pos;
      if (k0 < 0) break;
      if (!any_visible(g, qc0, qc0 + 64, k0, k0 + kStep)) {
        release(&empty[s], lane);
        continue;
      }
      const bool edge = in.seg_edge || !all_visible(g, qc0, qc0 + 64, k0, k0 + kStep);
      const unsigned char* ks = ring + s * 2 * C::kTileB;
      const unsigned char* vs = ks + C::kTileB;

      float sc[32], dp[32];
      wgmma_fence();
      scores<T, DP>(sc, q_s + c * 64 * 128, kBlk * 128, ks, kStep * 128);
      wgmma_commit();
      scores<T, DP>(dp, do_s + c * 64 * 128, kBlk * 128, vs, kStep * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // P = exp(s - lse), then dS = (P~ dP - P delta) dcap scale in dp;
      // register 4 j + 2 hh + e is row 16 warp + grp + 8 hh, key
      // 8 j + 2 t4 + e
      if (plain && !drop_on && !edge) {     // an interior tile: no mask
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          const float p = exp2_ftz(fmaf(sc[i], sl2, -lse2[hh]));
          dp[i] = p * (dp[i] - delta_r[hh]) * g.scale;
        }
      } else {
        // the keys [klo, khi] each row may see (causal, window, ragged
        // ends), and the tile's key segment ids, two a load
        int klo[2], khi[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qi = qc0 + 16 * warp + grp + 8 * hh;
          const int2 kb = key_bounds(g, qi);
          klo[hh] = kb.x - k0;
          khi[hh] = kb.y - k0;
        }
        if (plain && !drop_on) {            // an edge tile of the plain path
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int2 ks = has_seg ? *reinterpret_cast<const int2*>(&in.seg[8 * j + 2 * t4])
                                    : make_int2(0, 0);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * hh + e;
                const int cj = 8 * j + 2 * t4 + e;
                const bool ok = cj >= klo[hh] && cj <= khi[hh] &&
                                (!has_seg || qseg_r[hh] == (e ? ks.y : ks.x));
                const float p = ok ? exp2_ftz(fmaf(sc[i], sl2, -lse2[hh])) : 0.f;
                dp[i] = p * (dp[i] - delta_r[hh]) * g.scale;
              }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int2 ks = has_seg ? *reinterpret_cast<const int2*>(&in.seg[8 * j + 2 * t4])
                                    : make_int2(0, 0);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * hh + e;
                const int cj = 8 * j + 2 * t4 + e;
                float p, dcap = 1.f;
                if (plain) {
                  p = exp2_ftz(fmaf(sc[i], sl2, -lse2[hh]));
                } else {
                  const int qi = qc0 + 16 * warp + grp + 8 * hh;
                  const float x = cap_score(g, sc[i], has_alibi, slope, qi, k0 + cj, &dcap);
                  p = exp2_ftz(fmaf(x, kLog2e, -lse2[hh]));
                }
                if (edge && !(cj >= klo[hh] && cj <= khi[hh] &&
                              (!has_seg || qseg_r[hh] == (e ? ks.y : ks.x))))
                  p = 0.f;
                const float f = drop_on ? drop_factor(g, drow[hh], drop_col(g, k0 + cj)) : 1.f;
                dp[i] = ds_core(drop_on, p, f, dp[i], delta_r[hh]) * dcap * g.scale;
              }
          }
        }
      }
      uint32_t hi[16], lo[16];
      split_frags<T>(dp, hi, lo);
      wgmma_fence();
      product_hilo<T, DP>(acc, hi, lo, ks);     // dq += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      release(&empty[s], lane);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qc0 + 16 * warp + grp + 8 * hh;
      if (qi >= g.sq) continue;
      T* row = dq + ((size_t(bi) * g.sq + qi) * g.hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =
            pack2<T>(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// B3 on wgmma: one CTA per (batch, kv head, 128 keys), q rows of every
// q head of the group streamed 64 at a time.  Past head dim 128 (kHalf)
// a CTA takes 64 keys, and consumer warpgroup c holds columns
// [DA c, DA c + DA) of their dk and dv: both warpgroups take the whole
// S^T and dP^T (the scores cost a third more products), each its half of
// the second products, so a thread holds 2 x 64 f32 of dk and dv.
template <typename T, int D, bool EXTRA>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_k,   // boxes of 128 rows
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_q,   // boxes of 64 rows
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv,
                         Geom g) {
  using C = WgCfg<D>;
  constexpr int S = C::kStagesDkv, DP = C::DP;
  constexpr bool kHalf = C::kHalf;
  constexpr int KB = C::kBlkDkv;                         // keys of the CTA
  constexpr int DA = kHalf ? DP / 2 : DP;                // dk, dv columns a warpgroup holds
  extern __shared__ __align__(1024) unsigned char wg_buf[];
  unsigned char* k_s = align1024(wg_buf);
  unsigned char* v_s = k_s + KB * DP * 2;
  unsigned char* ring = v_s + KB * DP * 2;               // S x (Q, dO)
  StageInfo* info = reinterpret_cast<StageInfo*>(ring + 2 * S * C::kTileB);
  RowStats* stats = reinterpret_cast<RowStats*>(info + S);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + S);
  uint64_t* empty = full + S;
  uint64_t* res = empty + S;

  const int k0 = blockIdx.x * KB;            // the first kv tiles see the most
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int group = g.hq / g.hk;
  const bool has_seg = g.qseg != nullptr;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 8);
    }
    mbar_init(res, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(res, 2 * KB * DP * 2);
#pragma unroll
        for (int b = 0; b < C::NB; ++b) {
          tma_load4(k_s + b * KB * 128, &map_k, 64 * b, kvh, k0, bi, res);
          tma_load4(v_s + b * KB * 128, &map_v, 64 * b, kvh, k0, bi, res);
        }
      }
      int2 ksr = make_int2(0, 0);
      if (has_seg) {
        int v[KB / 32];
        ksr = warp_seg_span<KB / 32>(g.kseg + size_t(bi) * g.sk, k0, g.sk, lane, v);
      }
      const int2 qr = q_span(g, k0, KB);
      const int* qseg = has_seg ? g.qseg + size_t(bi) * g.sq : nullptr;
      int it = 0;
      for (int base = qr.x; base < qr.y; base += 32 * kStep) {
        // the next 32 q tiles that share a segment with the CTA's keys,
        // walked for every q head of the group
        const unsigned meet = tiles_meeting(qseg, base, qr.y, g.sq, ksr, has_seg, lane);
        for (int gi = 0; gi < group; ++gi) {
          const int h = kvh * group + gi;     // ALiBi and dropout go by q head
          for (unsigned todo = meet; todo; todo &= todo - 1) {
            const int q0 = base + (__ffs(todo) - 1) * kStep;
            int seg[kStep / 32] = {0, 0};
            int seg_edge = 0;
            if (has_seg)
              seg_edge = !seg_uniform(warp_seg_span<kStep / 32>(qseg, q0, g.sq, lane, seg), ksr);
            float l[2], dl[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int qi = q0 + lane + 32 * i;
              const size_t at = (size_t(bi) * g.hq + h) * g.sq + qi;
              l[i] = qi < g.sq ? lse[at] * kLog2e : 0.f;
              dl[i] = qi < g.sq ? delta[at] : 0.f;
            }
            const int s = it % S;
            mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            StageInfo& in = info[s];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              in.seg[lane + 32 * i] = seg[i];
              stats[s].lse2[lane + 32 * i] = l[i];
              stats[s].delta[lane + 32 * i] = dl[i];
            }
            if (lane == 0) {
              in.pos = q0;
              in.head = h;
              in.seg_edge = seg_edge;
              mbar_expect_tx(&full[s], 2 * C::kTileB);
              unsigned char* qs = ring + s * 2 * C::kTileB;
#pragma unroll
              for (int b = 0; b < C::NB; ++b) {
                tma_load4(qs + b * kStep * 128, &map_q, 64 * b, h, q0, bi, &full[s]);
                tma_load4(qs + C::kTileB + b * kStep * 128, &map_do, 64 * b, h, q0, bi,
                          &full[s]);
              }
            } else {
              mbar_arrive(&full[s]);
            }
            ++it;
          }
        }
      }
      const int s = it % S;                  // no more tiles
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      if (lane == 0) info[s].pos = -1;
      mbar_arrive(&full[s]);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tc = threadIdx.x - 128;
    // keys [k0 + 64c, + 64); with kHalf keys [k0, + 64), columns [DA c, + DA)
    const int c = tc >> 7;
    const int warp = (tc >> 5) & 3, lane = tc & 31;
    const int grp = lane >> 2, t4 = lane & 3;
    const int kc0 = kHalf ? k0 : k0 + 64 * c;
    const unsigned char* kw_s = k_s + (kHalf ? 0 : c * 64 * 128);   // the warpgroup's keys
    const unsigned char* vw_s = v_s + (kHalf ? 0 : c * 64 * 128);
    const int col_box = kHalf ? c * (DA / 64) * kStep * 128 : 0;   // its columns of Q, dO
    const bool has_alibi = EXTRA && g.alibi != nullptr;
    const bool drop_on = EXTRA && g.drop_on;
    const bool plain = !has_alibi && g.softcap == 0.f;
    const float sl2 = g.scale * kLog2e;
    // this thread's keys: kc0 + 16 warp + grp + 8 hh
    int kseg_r[2];
    uint32_t dcol[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kj = kc0 + 16 * warp + grp + 8 * hh;
      kseg_r[hh] = has_seg && kj < g.sk ? g.kseg[size_t(bi) * g.sk + kj] : 0;
      dcol[hh] = drop_on ? drop_col(g, kj) : 0u;
    }
    float dk_acc[DA / 2], dv_acc[DA / 2];
#pragma unroll
    for (int i = 0; i < DA / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(res, 0);

    for (int it = 0;; ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const StageInfo& in = info[s];
      const RowStats& rs = stats[s];
      const int q0 = in.pos;
      if (q0 < 0) break;
      if (!any_visible(g, q0, q0 + kStep, kc0, kc0 + 64)) {
        release(&empty[s], lane);
        continue;
      }
      const int h = in.head;
      const bool edge = in.seg_edge || !all_visible(g, q0, q0 + kStep, kc0, kc0 + 64);
      const float slope = has_alibi ? g.alibi[h] : 0.f;
      const uint32_t dbase = drop_on ? drop_base(g, bi, h) : 0u;
      const unsigned char* qs = ring + s * 2 * C::kTileB;
      const unsigned char* dos = qs + C::kTileB;

      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns q rows
      float st[32], dpt[32];
      wgmma_fence();
      scores<T, DP>(st, kw_s, KB * 128, qs, kStep * 128);
      wgmma_commit();
      scores<T, DP>(dpt, vw_s, KB * 128, dos, kStep * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // P~^T in st and dS^T in dpt; register 4 j + 2 hh + e is key
      // 16 warp + grp + 8 hh, q row 8 j + 2 t4 + e
      if (plain && !drop_on && !edge) {     // an interior tile: no mask
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(&rs.lse2[8 * j + 2 * t4]);
          const float2 dl = *reinterpret_cast<const float2*>(&rs.delta[8 * j + 2 * t4]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e;
              const float p = exp2_ftz(fmaf(st[i], sl2, -(e ? l2.y : l2.x)));
              dpt[i] = p * (dpt[i] - (e ? dl.y : dl.x)) * g.scale;
              st[i] = p;
            }
        }
      } else {
        // the q rows [qlo, qhi] each key may be seen by (causal, window,
        // ragged ends)
        int qlo[2], qhi[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int2 qb = query_bounds(g, kc0 + 16 * warp + grp + 8 * hh);
          qlo[hh] = qb.x - q0;
          qhi[hh] = qb.y - q0;
        }
        if (plain && !drop_on) {            // an edge tile of the plain path
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(&rs.lse2[8 * j + 2 * t4]);
            const float2 dl = *reinterpret_cast<const float2*>(&rs.delta[8 * j + 2 * t4]);
            const int2 qs = has_seg ? *reinterpret_cast<const int2*>(&in.seg[8 * j + 2 * t4])
                                    : make_int2(0, 0);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * hh + e;
                const int cq = 8 * j + 2 * t4 + e;
                const bool ok = cq >= qlo[hh] && cq <= qhi[hh] &&
                                (!has_seg || kseg_r[hh] == (e ? qs.y : qs.x));
                const float p = ok ? exp2_ftz(fmaf(st[i], sl2, -(e ? l2.y : l2.x))) : 0.f;
                dpt[i] = p * (dpt[i] - (e ? dl.y : dl.x)) * g.scale;
                st[i] = p;
              }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(&rs.lse2[8 * j + 2 * t4]);
            const float2 dl = *reinterpret_cast<const float2*>(&rs.delta[8 * j + 2 * t4]);
            const int2 qs = has_seg ? *reinterpret_cast<const int2*>(&in.seg[8 * j + 2 * t4])
                                    : make_int2(0, 0);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * hh + e;
                const int cq = 8 * j + 2 * t4 + e;
                const int kj = kc0 + 16 * warp + grp + 8 * hh;
                float p, dcap = 1.f;
                if (plain) {
                  p = exp2_ftz(fmaf(st[i], sl2, -(e ? l2.y : l2.x)));
                } else {
                  const float x = cap_score(g, st[i], has_alibi, slope, q0 + cq, kj, &dcap);
                  p = exp2_ftz(fmaf(x, kLog2e, -(e ? l2.y : l2.x)));
                }
                if (edge && !(cq >= qlo[hh] && cq <= qhi[hh] &&
                              (!has_seg || kseg_r[hh] == (e ? qs.y : qs.x))))
                  p = 0.f;
                const float f =
                    drop_on ? drop_factor(g, drop_row(g, dbase, q0 + cq), dcol[hh]) : 1.f;
                dpt[i] = ds_core(drop_on, p, f, dpt[i], e ? dl.y : dl.x) * dcap * g.scale;
                st[i] = p * f;                 // dV takes the dropped P
              }
          }
        }
      }
      uint32_t ph[16], pl[16];
      split_frags<T>(st, ph, pl);
      wgmma_fence();
      product_hilo<T, DA>(dv_acc, ph, pl, dos + col_box);   // dv += P~^T dO
      wgmma_commit();
      uint32_t dh[16], dl[16];
      split_frags<T>(dpt, dh, dl);
      wgmma_fence();
      product_hilo<T, DA>(dk_acc, dh, dl, qs + col_box);    // dk += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
      release(&empty[s], lane);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kj = kc0 + 16 * warp + grp + 8 * hh;
      if (kj >= g.sk) continue;
      const size_t base = ((size_t(bi) * g.sk + kj) * g.hk + kvh) * D + (kHalf ? DA * c : 0);
#pragma unroll
      for (int j = 0; j < (kHalf ? DA : D) / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + base + 8 * j + 2 * t4) =
            pack2<T>(dk_acc[4 * j + 2 * hh], dk_acc[4 * j + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * j + 2 * t4) =
            pack2<T>(dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the map of one head's rows of a BSHD tensor [b, s, h, d] of T (bf16 or
// f16): boxes of 64 columns by `rows` rows of one head and batch,
// 128-byte swizzle, zeros out of range (rows past s, columns past d)
template <typename T>
int make_bshd_map(CUtensorMap* map, const void* base, int b, int s, int h, int d, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(h), cuuint64_t(s), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 2, cuuint64_t(h) * d * 2,
                                 cuuint64_t(s) * h * d * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      enc(map,
          std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          4, const_cast<void*>(base), dims, strides, box,
          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + int(r);
}

// Each launcher sets its kernel's dynamic shared-memory limit once per
// device (an attribute of the function on each device) and returns the
// launch's cudaError_t, or an error of the map encoder.
template <typename T, int D, bool EXTRA>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
               const Geom& g, cudaStream_t st) {
  static bool attr[kMaxDevices];
  if constexpr (kWg16<T>) {
    constexpr size_t smem = wg_smem<D, WgCfg<D>::kStagesFwd, false, 1>() + 4 * kWin + 8;
    const auto kernel = fwd_wgmma_kernel<T, D, EXTRA>;
    const cudaError_t r = smem_attr_per_device(kernel, int(smem), attr);
    if (r != cudaSuccess) return r;
    CUtensorMap mq, mk, mv;
    int e = make_bshd_map<T>(&mq, q, b, g.sq, g.hq, D, kBlk);
    if (e == 0) e = make_bshd_map<T>(&mk, k, b, g.sk, g.hk, D, kStep);
    if (e == 0) e = make_bshd_map<T>(&mv, v, b, g.sk, g.hk, D, kStep);
    if (e != 0) return e;
    const dim3 grid((g.sq + kBlk - 1) / kBlk, g.hq, b);
    kernel<<<grid, kWgThreads, smem, st>>>(mq, mk, mv, static_cast<T*>(o),
                                           static_cast<float*>(lse), g);
  } else {
    constexpr size_t smem = fwd_smem<D>();
    const cudaError_t r = smem_attr_per_device(fwd_kernel<T, D, EXTRA>, int(smem), attr);
    if (r != cudaSuccess) return r;
    const dim3 grid((g.sq + kTile - 1) / kTile, g.hq, b);
    fwd_kernel<T, D, EXTRA><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), g);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool EXTRA>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int b, const Geom& g, cudaStream_t st) {
  static bool attr[kMaxDevices];
  if constexpr (kWg16<T>) {
    constexpr size_t smem = wg_smem<D, WgCfg<D>::kStagesDq, false>();
    const auto kernel = bwd_dq_wgmma_kernel<T, D, EXTRA>;
    const cudaError_t r = smem_attr_per_device(kernel, int(smem), attr);
    if (r != cudaSuccess) return r;
    CUtensorMap mq, mdo, mk, mv;
    int e = make_bshd_map<T>(&mq, q, b, g.sq, g.hq, D, kBlk);
    if (e == 0) e = make_bshd_map<T>(&mdo, dout, b, g.sq, g.hq, D, kBlk);
    if (e == 0) e = make_bshd_map<T>(&mk, k, b, g.sk, g.hk, D, kStep);
    if (e == 0) e = make_bshd_map<T>(&mv, v, b, g.sk, g.hk, D, kStep);
    if (e != 0) return e;
    const dim3 grid((g.sq + kBlk - 1) / kBlk, g.hq, b);
    kernel<<<grid, kWgThreads, smem, st>>>(mq, mdo, mk, mv, static_cast<const float*>(lse),
                                           static_cast<const float*>(delta),
                                           static_cast<T*>(dq), g);
  } else {
    constexpr size_t smem = dq_smem<D>();
    const cudaError_t r = smem_attr_per_device(bwd_dq_kernel<T, D, EXTRA>, int(smem), attr);
    if (r != cudaSuccess) return r;
    const dim3 grid((g.sq + kTile - 1) / kTile, g.hq, b);
    bwd_dq_kernel<T, D, EXTRA><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), g);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool EXTRA>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int b, const Geom& g, cudaStream_t st) {
  static bool attr[kMaxDevices];
  if constexpr (kWg16<T>) {
    constexpr int KB = WgCfg<D>::kBlkDkv;
    constexpr size_t smem = wg_smem<D, WgCfg<D>::kStagesDkv, true, 2, KB>();
    const auto kernel = bwd_dkv_wgmma_kernel<T, D, EXTRA>;
    const cudaError_t r = smem_attr_per_device(kernel, int(smem), attr);
    if (r != cudaSuccess) return r;
    CUtensorMap mk, mv, mq, mdo;
    int e = make_bshd_map<T>(&mk, k, b, g.sk, g.hk, D, KB);
    if (e == 0) e = make_bshd_map<T>(&mv, v, b, g.sk, g.hk, D, KB);
    if (e == 0) e = make_bshd_map<T>(&mq, q, b, g.sq, g.hq, D, kStep);
    if (e == 0) e = make_bshd_map<T>(&mdo, dout, b, g.sq, g.hq, D, kStep);
    if (e != 0) return e;
    const dim3 grid((g.sk + KB - 1) / KB, g.hk, b);
    kernel<<<grid, kWgThreads, smem, st>>>(mk, mv, mq, mdo, static_cast<const float*>(lse),
                                           static_cast<const float*>(delta),
                                           static_cast<T*>(dk), static_cast<T*>(dv), g);
  } else {
    constexpr size_t smem = dkv_smem<D>();
    const cudaError_t r = smem_attr_per_device(bwd_dkv_kernel<T, D, EXTRA>, int(smem), attr);
    if (r != cudaSuccess) return r;
    const dim3 grid((g.sk + kTile - 1) / kTile, g.hk, b);
    bwd_dkv_kernel<T, D, EXTRA><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), g);
  }
  return cudaGetLastError();
}

Geom make_geom(const void* qseg, const void* kseg, const void* alibi, int sq, int sk,
               int hq, int hk, int causal, int wl, int wr, float scale, float softcap,
               int drop_on, unsigned drop_seed, unsigned drop_thresh, float drop_scale,
               int q_off, int k_off, int h_off, int b_off) {
  Geom g;
  g.qseg = static_cast<const int*>(qseg);
  g.kseg = static_cast<const int*>(kseg);
  g.alibi = static_cast<const float*>(alibi);
  g.sq = sq; g.sk = sk; g.hq = hq; g.hk = hk;
  g.causal = causal; g.wl = wl; g.wr = wr; g.shift = sk - sq + q_off - k_off;
  g.scale = scale; g.softcap = softcap;
  g.drop_on = drop_on; g.drop_seed = drop_seed; g.drop_thresh = drop_thresh;
  g.drop_scale = drop_scale;
  g.q_off = q_off; g.k_off = k_off; g.h_off = h_off; g.b_off = b_off;
  return g;
}

}  // namespace

// The C interface.  q/k/v/dout/o/dq/dk/dv are BSHD and contiguous (16-byte
// aligned), of dtype 0 = float32, 1 = bfloat16 or 2 = float16; lse and delta are
// [b, hq, sq] float32; qseg/kseg are [b, sq] / [b, sk] int32, or both
// null; alibi is [hq] float32 slopes or null; with drop_on a pair is kept
// when its hash (drop_seed) is >= drop_thresh and kept P entries are
// scaled by drop_scale; q_off/k_off/h_off/b_off are the global position
// of the local q and kv rows, head 0 and batch row 0 (0 for a whole call).  Each launches on `stream`, does not synchronise,
// and returns 0 on success, else the cudaError_t of its launch, or
// 100000 when the runtime does not reach cuTensorMapEncodeTiled, or
// 200000 + its CUresult when it refuses a map (the bf16 and f16 kernels).
// ALiBi and dropout have kernels of their own (EXTRA), so that the
// kernels of the plain training path carry none of their code
#define FLASH_DISPATCH_D(LAUNCH, T, DD, ...)                               \
  do {                                                                     \
    if (g.alibi != nullptr || g.drop_on) return LAUNCH<T, DD, true>(__VA_ARGS__); \
    return LAUNCH<T, DD, false>(__VA_ARGS__);                              \
  } while (0)
#define FLASH_DISPATCH_T(LAUNCH, DD, ...)                                  \
  do {                                                                     \
    if (dtype == 0) FLASH_DISPATCH_D(LAUNCH, float, DD, __VA_ARGS__);       \
    if (dtype == 1) FLASH_DISPATCH_D(LAUNCH, __nv_bfloat16, DD, __VA_ARGS__); \
    if (dtype == 2) FLASH_DISPATCH_D(LAUNCH, __half, DD, __VA_ARGS__);      \
  } while (0)
#define FLASH_ROW(DD, LAUNCH, ...)                                         \
  if (d == DD) FLASH_DISPATCH_T(LAUNCH, DD, __VA_ARGS__);
// -DFLASH_HEAD_DIM=<d> builds that head dim's kernels alone (one library
// a head dim, compiled side by side: ops/_build.py); without it, all
#ifdef FLASH_HEAD_DIM
#define FLASH_ROWS(LAUNCH, ...) FLASH_ROW(FLASH_HEAD_DIM, LAUNCH, __VA_ARGS__)
#else
#define FLASH_ROWS(LAUNCH, ...)                                            \
  FLASH_ROW(32, LAUNCH, __VA_ARGS__)                                       \
  FLASH_ROW(64, LAUNCH, __VA_ARGS__)                                       \
  FLASH_ROW(80, LAUNCH, __VA_ARGS__)                                       \
  FLASH_ROW(96, LAUNCH, __VA_ARGS__)                                       \
  FLASH_ROW(128, LAUNCH, __VA_ARGS__)                                      \
  FLASH_ROW(256, LAUNCH, __VA_ARGS__)
#endif
#define FLASH_DISPATCH(LAUNCH, ...)                                        \
  do {                                                                     \
    FLASH_ROWS(LAUNCH, __VA_ARGS__)                                        \
    return cudaErrorInvalidValue;                                          \
  } while (0)

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* alibi, void* o, void* lse, int b, int sq, int sk,
    int hq, int hk, int d, int causal, int wl, int wr, float scale, float softcap,
    int drop_on, unsigned drop_seed, unsigned drop_thresh, float drop_scale,
    int q_off, int k_off, int h_off, int b_off, int dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const Geom g = make_geom(qseg, kseg, alibi, sq, sk, hq, hk, causal, wl, wr, scale,
                           softcap, drop_on, drop_seed, drop_thresh, drop_scale, q_off,
                           k_off, h_off, b_off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, b, g, st);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* alibi, const void* dout, const void* lse,
    const void* delta, void* dq, int b, int sq, int sk, int hq, int hk, int d,
    int causal, int wl, int wr, float scale, float softcap, int drop_on,
    unsigned drop_seed, unsigned drop_thresh, float drop_scale, int q_off,
    int k_off, int h_off, int b_off, int dtype, void* stream) {
  if (b == 0 || sq == 0) return 0;
  const Geom g = make_geom(qseg, kseg, alibi, sq, sk, hq, hk, causal, wl, wr, scale,
                           softcap, drop_on, drop_seed, drop_thresh, drop_scale, q_off,
                           k_off, h_off, b_off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, b, g, st);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, const void* alibi, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int b, int sq, int sk, int hq, int hk,
    int d, int causal, int wl, int wr, float scale, float softcap, int drop_on,
    unsigned drop_seed, unsigned drop_thresh, float drop_scale, int q_off,
    int k_off, int h_off, int b_off, int dtype, void* stream) {
  if (b == 0 || sk == 0) return 0;
  const Geom g = make_geom(qseg, kseg, alibi, sq, sk, hq, hk, causal, wl, wr, scale,
                           softcap, drop_on, drop_seed, drop_thresh, drop_scale, q_off,
                           k_off, h_off, b_off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, b, g, st);
}
