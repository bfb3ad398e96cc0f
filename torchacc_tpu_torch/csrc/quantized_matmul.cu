/*
 * Fused quantize -> matmul -> dequantize, written by hand for Hopper
 * (sm_90a).  It replaces the Pallas TPU kernel _qmm_kernel of
 * torchacc_tpu/ops/quantized_matmul.py (:175, pallas_call :233 in
 * _qmm2d_pallas) — B5.
 *
 * What it computes (the plain version is ops/quantized_matmul.py
 * _qmm2d_plain): for x [M, K] and w [K, N] in the compute dtype (bf16
 * or f32), one f32 activation scale sx and per-column weight scales
 * sw [N],
 *
 *     qx = Q(clip(x / sx, +-qmax)),  qw = Q(clip(w / sw[n], +-qmax))
 *     out[m, n] = float(sum_k qx[m, k] * qw[k, n]) * (sx * sw[n])
 *
 * cast to x's dtype.  int8: qmax 127, Q rounds half to even, the sum is
 * an exact int32 (127^2 * K < 2^31 needs K < 133 144; the wrapper
 * refuses more).  fp8: qmax 448, Q is the e4m3 cast (round to nearest
 * even, saturating), the products are exact in f32 and summed in f32.
 * The quantized operands live in shared memory only: they never reach
 * device memory, which is what the TPU kernel fuses.
 *
 * Bitwise int8.  Every rounding is the plain version's: the IEEE
 * quotient x / s (never x * (1 / s) where the two could differ), the
 * clip before the round, round half to even, int32 -> f32 conversion
 * to nearest even, and the epilogue as two separate multiplies
 * acc_f32 * (sx * sw[n]) with no FMA contraction.  So the int8 kernel
 * equals the plain version bit for bit; the fp8 kernel quantizes to the
 * same e4m3 values and differs only in the order of the f32 sum.
 *
 * What bounds it on an H100 (3.35 TB/s; 1 979 TOP/s dense int8 and
 * fp8): at the training shapes (M = 8192 tokens, K and N 1024..14336,
 * bf16) it does 2*M*N*K operations over (M*K + K*N + M*N) * 2 bytes,
 * hundreds of operations per byte: bound by operations.  What this
 * first version is really bound by is the quantization itself: a tile
 * of x is quantized again by every CTA along N and a tile of w by every
 * CTA along M, (BM + BN) / (BM * BN) elements per multiply-add, and an
 * element costs ~12 CUDA-core instructions against 1/128 of a
 * tensor-core instruction per multiply-add.
 *
 * What the design does about it:
 *  - the quotient.  div.rn costs ~15 instructions with its range
 *    checks.  The scale's correctly rounded reciprocal is taken once; a
 *    product and two fma corrections then give the IEEE quotient bit for
 *    bit (quotient() below), in five instructions and with no branch.
 *    (Rounding x * (1 / s) alone and redoing only the values near a
 *    rounding tie is no shortcut: with bf16 inputs, exact ties are
 *    common, not rare);
 *  - a CTA owns a BM x BN = 128 x 128 output tile and loops over K (the
 *    TPU's sequential K grid axis with a VMEM accumulator becomes the
 *    loop; the accumulators stay in registers); 8 warps, each 64 x 32,
 *    on mma.sync m16n8k32 (s8.s8 -> s32, e4m3.e4m3 -> f32);
 *  - two stages of quantized tiles in shared memory: while one is
 *    multiplied, warps that are done fill the other (16-byte loads,
 *    quantize, 8-byte stores); one barrier a K step, two CTAs an SM;
 *  - CTAs are numbered so that those running together cover a square
 *    patch of the output (16 tiles of M by the tiles of N), which keeps
 *    the x and w tiles they share in L2;
 *  - the weight is read where it lies: [N, K] row-major (an nn.Linear)
 *    or [K, N] row-major; both become K-contiguous rows in shared
 *    memory, which is what the "col" B operand of mma.sync wants;
 *  - no 512-tiles, no zero padding to tile multiples, no K grid axis:
 *    ragged M, N and K are predicated (rows and columns out of range
 *    quantize to 0 and add nothing);
 *  - fp8 accumulates in the mma's f32 accumulator over all of K.  Adding
 *    each K step's sums on the CUDA cores instead (in case the tensor
 *    cores kept fewer bits of a running sum) changed no bit of the
 *    error against an f64 product on an H100, so it is not done.
 * Measured on an H100 SXM at 700 W (chip_smoke.py): about 7% of the
 * 8-bit peak, 5x the time of the bf16 matmul of the same shape: the
 * quantization takes the time.  wgmma, TMA and
 * quantizing each tile once for a cluster of CTAs (shared through
 * distributed shared memory) are later work.
 */

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kMT = kBM / kWarpsM / 16;   // m16 tiles per warp: 4
constexpr int kNT = kBN / kWarpsN / 8;    // n8 tiles per warp: 4
constexpr int kPad = 16;                  // bytes of row padding (bank spread)
constexpr int kGroupM = 16;               // M tiles per patch of CTAs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void store_out(T* p, float v);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_out2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_out2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// Five instructions against ~15 for div.rn with its range checks, and
// no branch.  Holds while nothing under- or overflows: |s| in
// [1e-20, 1e20] (Scale::fast), x finite; a quotient too small for its
// residual to be exact (< 1e-15) quantizes to zero either way.
__device__ __forceinline__ float quotient(float x, const Scale& sc) {
  float q = __fmul_rn(x, sc.inv);
  q = __fmaf_rn(__fmaf_rn(-q, sc.s, x), sc.inv, q);
  q = __fmaf_rn(__fmaf_rn(-q, sc.s, x), sc.inv, q);
  return q;
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
// tile loads: 16 bytes of a row per thread and load
// ---------------------------------------------------------------------------

// elements [row][col .. col + VEC) of a row-major [rows][cols] array with
// leading dimension ld; out-of-range elements read as zero
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ base, int row, int col,
                                            int rows, int cols, long long ld, bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows && col < cols) {
    const T* p = base + size_t(row) * ld + col;
    if (vec_ok && col + VEC <= cols) {
      r = *reinterpret_cast<const uint4*>(p);
    } else {
      T* e = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (col + j < cols) e[j] = p[j];
    }
  }
  return r;
}

template <typename T, bool FP8, bool W_KN>
__global__ void __launch_bounds__(kThreads, 2)
    qmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ sx_p, const float* __restrict__ sw,
               T* __restrict__ out, int M, int N, int K, long long ldw, int x_vec_ok,
               int w_vec_ok, int out_pair_ok) {
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte load
  constexpr int BK = 128 / sizeof(T);             // bf16: 64, f32: 32
  constexpr int LD = BK + kPad;                   // bytes per shared row
  constexpr int XCH = kBM * BK / VEC / kThreads;  // x chunks per thread: 4
  constexpr int WCH = kBN * BK / VEC / kThreads;  // w chunks per thread: 4
  constexpr int CPR = BK / VEC;                   // chunks per K row of a tile
  using Acc = typename std::conditional<FP8, float, int>::type;

  // two stages of quantized tiles: one is multiplied while the next is
  // written
  __shared__ __align__(16) unsigned char xs_all[2 * kBM * LD];
  __shared__ __align__(16) unsigned char ws_all[2 * kBN * LD];
  __shared__ float sw_s[kBN];

  // CTAs that run together cover kGroupM tiles of M by the tiles of N
  const int ntm = (M + kBM - 1) / kBM, ntn = (N + kBN - 1) / kBN;
  const int per_group = kGroupM * ntn;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int gsize = min(kGroupM, ntm - first_m);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gsize) * kBM;
  const int n0 = (in_group / gsize) * kBN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWarpsN) * (kBM / kWarpsM);
  const int wn = (warp % kWarpsN) * (kBN / kWarpsN);

  if (threadIdx.x < kBN)
    sw_s[threadIdx.x] = n0 + threadIdx.x < N ? sw[n0 + threadIdx.x] : 1.f;
  const float sx = *sx_p;
  const Scale scx = make_scale(sx);
  __syncthreads();

  // the weight scale of each chunk this thread quantizes: one row (n)
  // per chunk when w lies [N, K]
  Scale scw[WCH];
  if constexpr (!W_KN) {
#pragma unroll
    for (int c = 0; c < WCH; ++c)
      scw[c] = make_scale(sw_s[(threadIdx.x + c * kThreads) / CPR]);
  }

  Acc acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // chunks [c0, c1) of this thread's share of the tiles at k0
  uint4 xraw[XCH], wraw[WCH];
  auto gload = [&](int k0, int c0, int c1) {
#pragma unroll
    for (int c = 0; c < XCH; ++c) {
      if (c < c0 || c >= c1) continue;
      const int i = threadIdx.x + c * kThreads;
      xraw[c] = load_chunk<T>(x, m0 + i / CPR, k0 + (i % CPR) * VEC, M, K, K, x_vec_ok);
    }
#pragma unroll
    for (int c = 0; c < WCH; ++c) {
      if (c < c0 || c >= c1) continue;
      const int i = threadIdx.x + c * kThreads;
      if constexpr (W_KN) {
        constexpr int NPR = kBN / VEC;            // chunks per N row of a tile
        wraw[c] = load_chunk<T>(w, k0 + i / NPR, n0 + (i % NPR) * VEC, K, N, ldw, w_vec_ok);
      } else {
        wraw[c] = load_chunk<T>(w, n0 + i / CPR, k0 + (i % CPR) * VEC, N, K, ldw, w_vec_ok);
      }
    }
  };

  auto quantize_store = [&](int stage, int c0, int c1) {
    unsigned char* xs = xs_all + stage * (kBM * LD);
    unsigned char* ws = ws_all + stage * (kBN * LD);
#pragma unroll
    for (int c = 0; c < XCH; ++c) {
      if (c < c0 || c >= c1) continue;
      const int i = threadIdx.x + c * kThreads;
      const T* e = reinterpret_cast<const T*>(&xraw[c]);
      const Scale s4[4] = {scx, scx, scx, scx};
      uint32_t q[VEC / 4];
#pragma unroll
      for (int v = 0; v < VEC / 4; ++v) {
        const float f[4] = {to_f32(e[4 * v]), to_f32(e[4 * v + 1]), to_f32(e[4 * v + 2]),
                            to_f32(e[4 * v + 3])};
        q[v] = quant4<FP8>(f, s4);
      }
      unsigned char* dst = xs + (i / CPR) * LD + (i % CPR) * VEC;
      if constexpr (VEC == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
      else *reinterpret_cast<uint32_t*>(dst) = q[0];
    }
#pragma unroll
    for (int c = 0; c < WCH; ++c) {
      if (c < c0 || c >= c1) continue;
      const int i = threadIdx.x + c * kThreads;
      const T* e = reinterpret_cast<const T*>(&wraw[c]);
      if constexpr (W_KN) {
        // a chunk holds VEC columns (n) of one k: a byte each, a shared
        // row apart
        constexpr int NPR = kBN / VEC;
        const int kk = i / NPR, nn = (i % NPR) * VEC;
#pragma unroll
        for (int v = 0; v < VEC / 4; ++v) {
          float f[4];
          Scale s4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            f[j] = to_f32(e[4 * v + j]);
            s4[j] = make_scale(sw_s[nn + 4 * v + j]);
          }
          const uint32_t q = quant4<FP8>(f, s4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ws[(nn + 4 * v + j) * LD + kk] = (unsigned char)((q >> (8 * j)) & 0xffu);
        }
      } else {
        const Scale s4[4] = {scw[c], scw[c], scw[c], scw[c]};
        uint32_t q[VEC / 4];
#pragma unroll
        for (int v = 0; v < VEC / 4; ++v) {
          const float f[4] = {to_f32(e[4 * v]), to_f32(e[4 * v + 1]), to_f32(e[4 * v + 2]),
                              to_f32(e[4 * v + 3])};
          q[v] = quant4<FP8>(f, s4);
        }
        unsigned char* dst = ws + (i / CPR) * LD + (i % CPR) * VEC;
        if constexpr (VEC == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
        else *reinterpret_cast<uint32_t*>(dst) = q[0];
      }
    }
  };

  static_assert(XCH == WCH && XCH % 2 == 0, "the tiles' chunks are filled in two halves");
  gload(0, 0, XCH);
  quantize_store(0, 0, XCH);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += BK, stage ^= 1) {
    const bool more = k0 + BK < K;
    const unsigned char* xs = xs_all + stage * (kBM * LD);
    const unsigned char* ws = ws_all + stage * (kBN * LD);

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const unsigned char* pb = ws + (wn + j * 8 + g) * LD + ks * 32 + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(pb);
        b[j][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const unsigned char* pa = xs + (wm + i * 16 + g) * LD + ks * 32 + t * 4;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(pa),
                               *reinterpret_cast<const uint32_t*>(pa + 8 * LD),
                               *reinterpret_cast<const uint32_t*>(pa + 16),
                               *reinterpret_cast<const uint32_t*>(pa + 8 * LD + 16)};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if constexpr (FP8) mma_e4m3(acc[i][j], a, b[j][0], b[j][1]);
          else mma_s8(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
    // a warp that is done multiplying fills the next stage while others
    // still multiply; one barrier a K step.  The raw tiles are loaded
    // here, half at a time, and not held in registers across the
    // products: that keeps the kernel within 128 registers, so two CTAs
    // share an SM and hide each other's loads and barriers (faster on an
    // H100 than one CTA with the loads in flight during the products)
    if (more) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        gload(k0 + BK, h * (XCH / 2), (h + 1) * (XCH / 2));
        quantize_store(stage ^ 1, h * (XCH / 2), (h + 1) * (XCH / 2));
      }
    }
    __syncthreads();
  }

  // out = float(acc) * (sx * sw[n]): two multiplies, each rounded
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int nl = wn + j * 8 + t * 2;
    const int n = n0 + nl;
    const float d0 = __fmul_rn(sx, sw_s[nl]);
    const float d1 = __fmul_rn(sx, sw_s[nl + 1]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + g + 8 * half;
        if (m >= M) continue;
        float a0, a1;
        if constexpr (FP8) {
          a0 = acc[i][j][2 * half];
          a1 = acc[i][j][2 * half + 1];
        } else {
          a0 = __int2float_rn(acc[i][j][2 * half]);
          a1 = __int2float_rn(acc[i][j][2 * half + 1]);
        }
        const float v0 = __fmul_rn(a0, d0), v1 = __fmul_rn(a1, d1);
        T* p = out + size_t(m) * N + n;
        if (out_pair_ok && n + 1 < N) {
          store_out2(p, v0, v1);
        } else {
          if (n < N) store_out<T>(p, v0);
          if (n + 1 < N) store_out<T>(p + 1, v1);
        }
      }
  }
}

template <typename T, bool FP8, bool W_KN>
cudaError_t launch(const void* x, const void* w, const void* sx, const void* sw, void* out,
                   int M, int N, int K, long long ldw, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const auto aligned = [](const void* p, size_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const int x_vec_ok = aligned(x, 16) && K % VEC == 0;
  const int w_vec_ok = aligned(w, 16) && ldw % VEC == 0;
  const int out_pair_ok = aligned(out, 2 * sizeof(T)) && N % 2 == 0;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * (long long)((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  qmm_kernel<T, FP8, W_KN><<<int(tiles), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<T*>(out), M, N, K, ldw, x_vec_ok, w_vec_ok,
      out_pair_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* sx, const void* sw, void* out,
                     int M, int N, int K, long long ldw, int w_kn, int fmt, cudaStream_t st) {
  if (fmt == 0 && w_kn) return launch<T, false, true>(x, w, sx, sw, out, M, N, K, ldw, st);
  if (fmt == 0) return launch<T, false, false>(x, w, sx, sw, out, M, N, K, ldw, st);
  if (fmt == 1 && w_kn) return launch<T, true, true>(x, w, sx, sw, out, M, N, K, ldw, st);
  if (fmt == 1) return launch<T, true, false>(x, w, sx, sw, out, M, N, K, ldw, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The C interface.  x [M, K] and out [M, N] are contiguous, of dtype
// 0 = float32 or 1 = bfloat16; w has the same dtype and holds [K, N]
// either as [N, K] row-major with leading dimension ldw (w_kn = 0) or as
// [K, N] row-major with leading dimension ldw (w_kn = 1); sx is one
// float32 and sw [N] float32, on the device.  fmt 0 = int8, 1 = fp8
// (e4m3).  Returns the cudaError_t of the launch (0 = success), launches
// on `stream` and does not synchronise.
extern "C" int quantized_matmul(const void* x, const void* w, const void* sx, const void* sw,
                                void* out, int M, int N, int K, long long ldw, int w_kn,
                                int fmt, int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w, sx, sw, out, M, N, K, ldw, w_kn, fmt, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, sx, sw, out, M, N, K, ldw, w_kn, fmt, st);
  return cudaErrorInvalidValue;
}
