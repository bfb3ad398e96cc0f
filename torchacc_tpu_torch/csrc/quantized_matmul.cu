/*
 * Quantized matmul, written by hand for Hopper (sm_90a): a quantize pass
 * and a GEMM on TMA-fed shared memory and wgmma (8-bit for int8, f16 for
 * the e4m3 values of fp8).  Together they
 * replace the Pallas TPU kernel _qmm_kernel of
 * torchacc_tpu/ops/quantized_matmul.py (:175, pallas_call :233 in
 * _qmm2d_pallas) — B5.
 *
 * What it computes (the plain version is ops/quantized_matmul.py
 * _qmm2d_plain): for x [M, K] and w [K, N] in the compute dtype (bf16,
 * f16 or f32), one f32 activation scale sx and per-column weight scales
 * sw [N],
 *
 *     qx = Q(clip(x / sx, +-qmax)),  qw = Q(clip(w / sw[n], +-qmax))
 *     out[m, n] = float(sum_k qx[m, k] * qw[k, n]) * (sx * sw[n])
 *
 * cast to x's dtype (rounded to nearest even; in f16 a value beyond
 * 65504 becomes +-inf, as JAX's astype gives it and the fp16 loss
 * scaler skips the step).  int8: qmax 127, Q rounds half to even, the sum is
 * an exact int32 (127^2 * K < 2^31 needs K < 133 144; the wrapper
 * refuses more).  fp8: qmax 448, Q is the e4m3 cast (round to nearest
 * even, saturating), the products are exact and summed in f32.
 *
 * Bitwise int8.  Every rounding is the plain version's: the IEEE
 * quotient x / s (never x * (1 / s) where the two could differ), the
 * clip before the round, round half to even, int32 -> f32 conversion
 * to nearest even, and the epilogue as two separate multiplies
 * acc_f32 * (sx * sw[n]) with no FMA contraction.  So the int8 result
 * equals the plain version bit for bit; fp8 quantizes to the same e4m3
 * values and sums the same exact products in f32, in another order.
 *
 * What bounds it on an H100 (3.35 TB/s; 1 979 TOP/s dense int8, 989
 * TFLOP/s f16): at the training shapes (M = 8192 tokens, K and N 1024..14336,
 * bf16) the product does 2*M*N*K operations over (M*K + K*N + M*N) * 2
 * bytes, hundreds of operations per byte: bound by operations.  The
 * first version fused the quantization into the GEMM, as the TPU kernel
 * does, and every CTA quantized its x and w tiles again (112 times
 * along N at gate/up): the quantization set the pace, at 7% of the
 * 8-bit peak.
 *
 * What this design does about it:
 *  - qmm_quantize_kernel: one launch quantizes each operand once, into
 *    device memory: qx [M, Kp] and qw [N, Kp], K-major (what wgmma takes
 *    for A and B alike), Kp = K rounded up to 16 (TMA's row stride is a
 *    multiple of 16 bytes; the pad columns are 0 and add nothing).  int8
 *    as bytes; fp8 as the e4m3 values widened to f16, which holds every
 *    one of them exactly (below).  The weight is read where it lies:
 *    [N, K] row-major (an nn.Linear) row by row, [K, N] row-major with
 *    neighbouring threads on neighbouring columns.  Bound by bytes: the
 *    operands read once, the quantized operands written once;
 *  - qmm_gemm_wgmma: one persistent CTA an SM walks 128 x BN output
 *    tiles (BN 256, or 128 for narrow N).  One producer thread keeps TMA
 *    loads of 128-byte-deep A and B tiles (128-byte swizzle) in flight
 *    through a ring of stages, with full/empty mbarrier pairs, and runs
 *    on into the next tile while the last one is stored; two consumer
 *    warpgroups, 64 rows each, run wgmma.mma_async over the stage's 128
 *    bytes of K (m64nBNk32 s8.s8 -> s32, or m64nBNk16 f16.f16 -> f32)
 *    from shared memory, one wgmma group in flight, and release a stage
 *    when its group is done.  setmaxnreg moves registers from the
 *    producer warpgroup to the consumers.  Ragged M, N and K: TMA fills
 *    the rows and columns out of range with zeros; the epilogue's stores
 *    are predicated, its scales staged in shared memory.  Tiles are
 *    walked so that those in work together cover a patch of 16 tiles of
 *    M by the tiles of N (shared tiles stay in L2);
 *  - fp8 on the f16 tensor cores: Hopper's e4m3 wgmma keeps about 13
 *    bits of its sums, not f32's 24, and adding its partial sums into
 *    f32 registers, as often as every k32 step, still leaves the result
 *    about 75 times further from an f64 product than an f32 sum (read on
 *    an H100, PERF.md).  The f16 wgmma sums the same exact products
 *    (e4m3 has a 4-bit significand and exponents within f16's) in f32,
 *    at half the 8-bit rate and with twice the operand bytes.
 */

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ptx.cuh"   // mbarriers, TMA, wgmma descriptors, the map encoder

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ void store_out(T* p, float v);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ void store_out<__half>(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ void store_out2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_out2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_out2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// ---------------------------------------------------------------------------
// quantization of four values to four bytes
// ---------------------------------------------------------------------------

struct Scale {
  float s, inv;
  bool fast;   // s is far from the ends of the f32 range: quotient() holds
};

__device__ __forceinline__ Scale make_scale(float s) {
  Scale r;
  r.s = s;
  r.inv = __fdiv_rn(1.f, s);      // correctly rounded
  r.fast = s > 1e-20f && s < 1e20f;
  return r;
}

// The IEEE quotient x / s without the division: with inv = RN(1 / s),
// q = RN(x * inv) lies within 1.5 ulp of x / s; the residual
// r = x - q * s is exact in one fma, and q + r * inv rounds to a
// faithful quotient, then (Markstein's theorem: a faithful quotient
// corrected once with a correctly rounded reciprocal) to RN(x / s).
// Six instructions against ~15 for div.rn with its range checks, and
// no branch.  Holds while nothing under- or overflows: |s| in
// [1e-20, 1e20] (Scale::fast), x finite; a quotient too small for its
// residual to be exact (< 1e-15) quantizes to zero either way.  The
// corrections add +0 to a zero quotient, so its sign is taken from x
// (s > 0): -0 / s is -0, as IEEE division gives it (fp8 keeps the sign
// of zero, e4m3 0x80; an f16 activation or weight that underflowed is
// -0).
__device__ __forceinline__ float quotient(float x, const Scale& sc) {
  float q = __fmul_rn(x, sc.inv);
  q = __fmaf_rn(__fmaf_rn(-q, sc.s, x), sc.inv, q);
  q = __fmaf_rn(__fmaf_rn(-q, sc.s, x), sc.inv, q);
  return copysignf(q, x);
}

// int8: clip(y, +-127), round half to even, as a two's complement byte in
// the low byte: y + 1.5 * 2^23 rounds y to an integer (nearest even) in
// the low mantissa bits
__device__ __forceinline__ uint32_t q_int8(float y) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f), 12582912.f));
}

// the scales at the ends of the f32 range (never seen in training): the
// division itself
__device__ __noinline__ uint32_t quant4_div(float x0, float x1, float x2, float x3, float s0,
                                            float s1, float s2, float s3, bool fp8) {
  const float y[4] = {__fdiv_rn(x0, s0), __fdiv_rn(x1, s1), __fdiv_rn(x2, s2),
                      __fdiv_rn(x3, s3)};
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b =
        fp8 ? uint32_t(__nv_cvt_float_to_fp8(fminf(fmaxf(y[i], -448.f), 448.f),
                                             __NV_SATFINITE, __NV_E4M3))
            : q_int8(y[i]) & 0xffu;
    out |= b << (8 * i);
  }
  return out;
}

// four values that share nothing but the format; sc[i] is value i's scale
template <bool FP8>
__device__ __forceinline__ uint32_t quant4(const float (&x)[4], const Scale (&sc)[4]) {
  if (!(sc[0].fast && sc[1].fast && sc[2].fast && sc[3].fast))
    return quant4_div(x[0], x[1], x[2], x[3], sc[0].s, sc[1].s, sc[2].s, sc[3].s, FP8);
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = quotient(x[i], sc[i]);
  if constexpr (FP8) {
    // the cast saturates at +-448 (the clip) and rounds to nearest even
    const uint32_t lo = uint32_t(__nv_cvt_float2_to_fp8x2(make_float2(y[0], y[1]),
                                                          __NV_SATFINITE, __NV_E4M3));
    const uint32_t hi = uint32_t(__nv_cvt_float2_to_fp8x2(make_float2(y[2], y[3]),
                                                          __NV_SATFINITE, __NV_E4M3));
    return lo | (hi << 16);
  } else {
    return __byte_perm(__byte_perm(q_int8(y[0]), q_int8(y[1]), 0x0040),
                       __byte_perm(q_int8(y[2]), q_int8(y[3]), 0x0040), 0x5410);
  }
}

// ---------------------------------------------------------------------------
// the quantize pass: 16 elements of one K row per thread
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256;

// bytes of a quantized operand element: an int8, or an e4m3 value as f16
template <bool FP8>
constexpr int kOpBytes = FP8 ? 2 : 1;

// 16 quantized values (bytes, element i in byte i % 4 of word i / 4) to
// their place in a K row: int8 as they are; e4m3 widened to f16, which is
// exact, 32 bytes
template <bool FP8>
__device__ __forceinline__ void store_q16(unsigned char* dst, uint4 q) {
  if constexpr (FP8) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    uint32_t h[8];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
            __nv_fp8x2_storage_t((w[v] >> (16 * p)) & 0xffffu), __NV_E4M3);
        h[2 * v + p] = uint32_t(r.x) | (uint32_t(r.y) << 16);
      }
    }
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(h[4], h[5], h[6], h[7]);
  } else {
    *reinterpret_cast<uint4*>(dst) = q;
  }
}

// 16 values of one scale to 16 bytes; bytes from `valid` on are the pad: 0
template <bool FP8>
__device__ __forceinline__ uint4 quant16(const float (&f)[16], const Scale& sc, int valid) {
  const Scale s4[4] = {sc, sc, sc, sc};
  uint32_t q[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float f4[4] = {f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]};
    q[v] = quant4<FP8>(f4, s4);
  }
  if (valid < 16) {
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * v + b >= valid) q[v] &= ~(0xffu << (8 * b));
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// elements [k0, k0 + 16) of row `row` of a K-major [rows, Kp] operand,
// from the contiguous elements src[row * ld + k0 ...]
template <typename T, bool FP8>
__device__ __forceinline__ void quant_row_chunk(const T* __restrict__ src, long long ld,
                                                float scale, int K, int Kp,
                                                unsigned char* __restrict__ dst, int row,
                                                int k0, bool vec_ok) {
  const int valid = min(16, K - k0);
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (valid > 0) {
    const T* p = src + size_t(row) * ld + k0;
    float f[16];
    if (vec_ok && valid == 16) {
      constexpr int NV = sizeof(T);          // 16-byte loads for 16 elements
      uint4 raw[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) raw[v] = reinterpret_cast<const uint4*>(p)[v];
      const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) f[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) f[j] = j < valid ? to_f32(p[j]) : 0.f;
    }
    q = quant16<FP8>(f, make_scale(scale), valid);
  }
  store_q16<FP8>(dst + (size_t(row) * Kp + k0) * kOpBytes<FP8>, q);
}

// Blocks [0, x_blocks) quantize x into qx; the rest quantize w into qw.
// One thread writes one 16-byte chunk of a K row.
template <typename T, bool FP8, bool W_KN>
__global__ void __launch_bounds__(kQThreads)
    qmm_quantize_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ sx_p, const float* __restrict__ sw,
                 unsigned char* __restrict__ qx, unsigned char* __restrict__ qw, int M, int N,
                 int K, int Kp, long long ldw, long long x_blocks, int x_vec_ok, int w_vec_ok) {
  const int cpr = Kp / 16;                   // chunks per K row
  if (blockIdx.x < x_blocks) {
    const long long i = (long long)blockIdx.x * kQThreads + threadIdx.x;
    if (i >= (long long)M * cpr) return;
    quant_row_chunk<T, FP8>(x, K, *sx_p, K, Kp, qx, int(i / cpr), int(i % cpr) * 16,
                            x_vec_ok);
    return;
  }
  const long long i = (long long)(blockIdx.x - x_blocks) * kQThreads + threadIdx.x;
  if (i >= (long long)N * cpr) return;
  if constexpr (W_KN) {
    // w [K, N] row-major: neighbouring threads take neighbouring columns
    // n, so that each of the 16 K rows a chunk reads is read coalesced
    const int n = int(i % N), k0 = int(i / N) * 16;
    const int valid = min(16, K - k0);
    float f[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      f[j] = j < valid ? to_f32(w[size_t(k0 + j) * ldw + n]) : 0.f;
    store_q16<FP8>(qw + (size_t(n) * Kp + k0) * kOpBytes<FP8>,
                   valid > 0 ? quant16<FP8>(f, make_scale(sw[n]), valid)
                             : make_uint4(0u, 0u, 0u, 0u));
  } else {
    const int n = int(i / cpr);
    quant_row_chunk<T, FP8>(w, ldw, sw[n], K, Kp, qw, n, int(i % cpr) * 16, w_vec_ok);
  }
}

// ---------------------------------------------------------------------------
// the GEMM: TMA, mbarriers and wgmma (PTX)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;            // rows of a CTA tile: two consumer warpgroups of 64
constexpr int kBK = 128;            // bytes of K a stage: one 128-byte swizzle row
constexpr int kGemmThreads = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int kGroupM = 16;         // M tiles per patch of CTAs

template <int BN>
struct GemmCfg {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kStageA = kBM * kBK, kStageB = BN * kBK;
  // the stages, the barriers, the tile's scales, and 1 KB to align the
  // stages to the 1024-byte period of the 128-byte swizzle
  static constexpr int kSmem =
      kStages * (kStageA + kStageB) + 2 * kStages * 8 + BN * 4 + 1024;
};

// one product of the warpgroup over 32 bytes of K, N = 2 * (registers a
// thread): m64nNk32 on int8, m64nNk16 on f16 (both K-major, so no
// transposes); d = a * b + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" HP_R64 "}, %64, %65, p;\n}\n"
      : HP_D64("+r", 0)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" HP_R128 "}, %128, %129, p;\n}\n"
      : HP_D64("+r", 0), HP_D64("+r", 64)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" HP_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HP_D64("+f", 0)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {" HP_R128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : HP_D64("+f", 0), HP_D64("+f", 64)
      : "l"(a), "l"(b), "r"(scale_d));
}

// output tile t of the grid's walk: CTAs that run together cover kGroupM
// tiles of M by the tiles of N (the A and B tiles they share stay in L2)
template <int BN>
__device__ __forceinline__ void tile_origin(int t, int M, int N, int& m0, int& n0) {
  const int ntm = (M + kBM - 1) / kBM, ntn = (N + BN - 1) / BN;
  const int per_group = kGroupM * ntn;
  const int first_m = (t / per_group) * kGroupM;
  const int gsize = min(kGroupM, ntm - first_m);
  const int in_group = t % per_group;
  m0 = (first_m + in_group % gsize) * kBM;
  n0 = (in_group / gsize) * BN;
}

// Persistent: a CTA walks tiles blockIdx.x, + gridDim.x, ...; the
// producer runs on into the next tile's stages while the consumers
// store the last one.
template <bool FP8, int BN, typename T>
__global__ void __launch_bounds__(kGemmThreads, 1)
    qmm_gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const float* __restrict__ sx_p,
                   const float* __restrict__ sw, T* __restrict__ out, int M, int N, int k_tiles,
                   int tiles, int out_pair_ok) {
  using Cfg = GemmCfg<BN>;
  constexpr int S = Cfg::kStages;
  constexpr int R = BN / 2;                 // accumulator registers a thread
  using Acc = typename std::conditional<FP8, float, int>::type;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sa = smem;                           // S x [kBM][kBK]
  unsigned char* sb = smem + S * Cfg::kStageA;        // S x [BN][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + S * Cfg::kStageB);
  uint64_t* empty = full + S;
  float* scale_s = reinterpret_cast<float*>(empty + S);   // [BN]: sx * sw[n]

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx; then the bytes
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;                                 // stages filled so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin<BN>(t, M, N, m0, n0);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);   // the first round passes
          mbar_expect_tx(&full[s], Cfg::kStageA + Cfg::kStageB);
          tma_load(sa + s * Cfg::kStageA, &map_a, kt * kBK, m0, &full[s]);
          tma_load(sb + s * Cfg::kStageB, &map_b, kt * kBK, n0, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tc = threadIdx.x - 128;        // 0..255
    const int c = tc / 128;                  // rows [64c, 64c + 64) of the tile
    const int warp = (tc / 32) % 4, lane = tc % 32;
    const auto release = [&](int s) {
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    const float sx = *sx_p;
    int it = 0;                                   // stages consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin<BN>(t, M, N, m0, n0);
      // this tile's weight scale, read now and used in the epilogue
      const float my_sw = tc < BN && n0 + tc < N ? sw[n0 + tc] : 0.f;
      Acc acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0;

      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        // the descriptors of step k are 32 bytes = 2 units further on
        const uint64_t da = smem_desc(sa + s * Cfg::kStageA + c * 64 * kBK);
        const uint64_t db = smem_desc(sb + s * Cfg::kStageB);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 32; ++k) wgmma(acc, da + 2 * k, db + 2 * k, 1);
        wgmma_commit();
        // one group in flight: the previous stage's is done
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0) release((it - 1) % S);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % S);

      // sx * sw[n] for the tile's columns, once the last tile's epilogue
      // has read its own (barrier 1: the two consumer warpgroups)
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (tc < BN) scale_s[tc] = __fmul_rn(sx, my_sw);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");

      // out = float(acc) * (sx * sw[n]): two multiplies, each rounded.
      // Register 4j + 2h + e holds row 16 warp + lane / 4 + 8h, column
      // 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN tile.
      const int row0 = m0 + 64 * c + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int nl = 8 * j + 2 * (lane % 4), n = n0 + nl;
        if (n >= N) continue;
        const float d0 = scale_s[nl], d1 = scale_s[nl + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 8 * h;
          if (m >= M) continue;
          float a0, a1;
          if constexpr (FP8) {
            a0 = acc[4 * j + 2 * h];
            a1 = acc[4 * j + 2 * h + 1];
          } else {
            a0 = __int2float_rn(acc[4 * j + 2 * h]);
            a1 = __int2float_rn(acc[4 * j + 2 * h + 1]);
          }
          const float v0 = __fmul_rn(a0, d0), v1 = __fmul_rn(a1, d1);
          T* p = out + size_t(m) * N + n;
          if (out_pair_ok && n + 1 < N) {
            store_out2(p, v0, v1);
          } else {
            store_out<T>(p, v0);
            if (n + 1 < N) store_out<T>(p + 1, v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the map of a K-major [rows, row_bytes] operand, read as bytes in boxes of
// kBK bytes of K by box_rows rows, 128-byte swizzle, zeros out of range
int make_map(CUtensorMap* map, const void* base, long long row_bytes, int rows, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {cuuint64_t(row_bytes), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(row_bytes)};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + int(r);
}

bool aligned(const void* p, size_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

template <typename T, bool FP8, bool W_KN>
int launch_quantize(const void* x, const void* w, const void* sx, const void* sw, void* qx,
                    void* qw, int M, int N, int K, int Kp, long long ldw, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const long long cpr = Kp / 16;
  const long long xb = ((long long)M * cpr + kQThreads - 1) / kQThreads;
  const long long wb = ((long long)N * cpr + kQThreads - 1) / kQThreads;
  if (xb + wb > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int x_vec_ok = aligned(x, 16) && K % VEC == 0;
  const int w_vec_ok = aligned(w, 16) && ldw % VEC == 0;
  qmm_quantize_kernel<T, FP8, W_KN><<<unsigned(xb + wb), kQThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<unsigned char*>(qx),
      static_cast<unsigned char*>(qw), M, N, K, Kp, ldw, xb, x_vec_ok, w_vec_ok);
  return cudaGetLastError();
}

template <typename T>
int dispatch_quantize(const void* x, const void* w, const void* sx, const void* sw, void* qx,
                      void* qw, int M, int N, int K, int Kp, long long ldw, int w_kn, int fmt,
                      cudaStream_t st) {
  if (fmt == 0 && w_kn) return launch_quantize<T, false, true>(x, w, sx, sw, qx, qw, M, N, K, Kp, ldw, st);
  if (fmt == 0) return launch_quantize<T, false, false>(x, w, sx, sw, qx, qw, M, N, K, Kp, ldw, st);
  if (fmt == 1 && w_kn) return launch_quantize<T, true, true>(x, w, sx, sw, qx, qw, M, N, K, Kp, ldw, st);
  if (fmt == 1) return launch_quantize<T, true, false>(x, w, sx, sw, qx, qw, M, N, K, Kp, ldw, st);
  return cudaErrorInvalidValue;
}

template <bool FP8, int BN, typename T>
int launch_gemm(const void* qx, const void* qw, const void* sx, const void* sw, void* out,
                int M, int N, int Kp, cudaStream_t st) {
  using Cfg = GemmCfg<BN>;
  static bool smem_set[kMaxDevices];
  const auto kernel = qmm_gemm_wgmma<FP8, BN, T>;
  int dev = 0;
  cudaError_t r = smem_attr_per_device(kernel, Cfg::kSmem, smem_set, &dev);
  if (r != cudaSuccess) return r;
  int sms = 0;
  r = sm_count(dev, &sms);
  if (r != cudaSuccess) return r;
  const long long row_bytes = (long long)Kp * kOpBytes<FP8>;
  CUtensorMap map_a, map_b;
  int e = make_map(&map_a, qx, row_bytes, M, kBM);
  if (e == 0) e = make_map(&map_b, qw, row_bytes, N, BN);
  if (e != 0) return e;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int pair_ok = aligned(out, 2 * sizeof(T)) && N % 2 == 0;
  kernel<<<unsigned(tiles < sms ? tiles : sms), kGemmThreads, Cfg::kSmem, st>>>(
      map_a, map_b, static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<T*>(out), M, N, int((row_bytes + kBK - 1) / kBK), int(tiles), pair_ok);
  return cudaGetLastError();
}

template <typename T>
int dispatch_gemm(const void* qx, const void* qw, const void* sx, const void* sw, void* out,
                  int M, int N, int Kp, int bn, int fmt, cudaStream_t st) {
  if (fmt == 0 && bn == 256) return launch_gemm<false, 256, T>(qx, qw, sx, sw, out, M, N, Kp, st);
  if (fmt == 0 && bn == 128) return launch_gemm<false, 128, T>(qx, qw, sx, sw, out, M, N, Kp, st);
  if (fmt == 1 && bn == 256) return launch_gemm<true, 256, T>(qx, qw, sx, sw, out, M, N, Kp, st);
  if (fmt == 1 && bn == 128) return launch_gemm<true, 128, T>(qx, qw, sx, sw, out, M, N, Kp, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The C interface.  Both launch on `stream`, do not synchronise, and
// return 0 on success, else a cudaError_t of the launch, or 100000 when
// the runtime does not reach cuTensorMapEncodeTiled, or 200000 + its
// CUresult when it refuses a map.
//
// qmm_quantize: x [M, K] contiguous, of dtype 0 = float32, 1 =
// bfloat16 or 2 = float16; w of the same dtype holds [K, N] either as [N, K] row-major
// with leading dimension ldw (w_kn = 0) or as [K, N] row-major with
// leading dimension ldw (w_kn = 1); sx one float32 and sw [N] float32.
// Writes qx [M, Kp] and qw [N, Kp] (int8 for fmt 0; for fmt 1 the e4m3
// values as float16), K-major, columns K..Kp zero; Kp is a multiple of
// 16, >= K.
extern "C" int qmm_quantize(const void* x, const void* w, const void* sx, const void* sw,
                            void* qx, void* qw, int M, int N, int K, int Kp, long long ldw,
                            int w_kn, int fmt, int dtype, void* stream) {
  if (Kp % 16 != 0 || Kp < K || !aligned(qx, 16) || !aligned(qw, 16))
    return cudaErrorInvalidValue;
  if (M == 0 && N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_quantize<float>(x, w, sx, sw, qx, qw, M, N, K, Kp, ldw, w_kn, fmt, st);
  if (dtype == 1)
    return dispatch_quantize<__nv_bfloat16>(x, w, sx, sw, qx, qw, M, N, K, Kp, ldw, w_kn, fmt,
                                            st);
  if (dtype == 2)
    return dispatch_quantize<__half>(x, w, sx, sw, qx, qw, M, N, K, Kp, ldw, w_kn, fmt, st);
  return cudaErrorInvalidValue;
}

// qmm_gemm: out [M, N] (dtype 0 = float32, 1 = bfloat16, 2 = float16) =
// float(qx [M, Kp] . qw [N, Kp]^T) * (sx * sw[n]), on what qmm_quantize
// wrote for fmt; bn 128 or 256 columns a CTA.
extern "C" int qmm_gemm(const void* qx, const void* qw, const void* sx, const void* sw,
                        void* out, int M, int N, int Kp, int bn, int fmt, int dtype,
                        void* stream) {
  if (Kp % 16 != 0 || Kp <= 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_gemm<float>(qx, qw, sx, sw, out, M, N, Kp, bn, fmt, st);
  if (dtype == 1) return dispatch_gemm<__nv_bfloat16>(qx, qw, sx, sw, out, M, N, Kp, bn, fmt, st);
  if (dtype == 2) return dispatch_gemm<__half>(qx, qw, sx, sw, out, M, N, Kp, bn, fmt, st);
  return cudaErrorInvalidValue;
}
