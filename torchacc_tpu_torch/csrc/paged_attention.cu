/*
 * Paged attention forward, written by hand for Hopper (sm_90a).
 *
 * Replaces the Pallas TPU kernel
 *   torchacc_tpu/ops/paged_attention.py::_paged_fwd_kernel (:103),
 *   launched by _paged_attention_pallas (:165, pallas_call at :202),
 * and computes exactly _paged_attention_xla (:66): causal attention of
 * q [S, T, H, D] over one layer's paged pool k/v [NB, BS, KH, D], where
 * block_tables [S, MB] maps slot s's logical block j to a pool block,
 * context_lens [S] counts the banked tokens (chunk included) and
 * q_start [S] is the position of the slot's first query row.  Key kv is
 * visible to row t when kv < ctx and kv <= q_start + t (and inside the
 * window when left/right >= 0).  Scores are f32, softcapped before the
 * mask; masked scores are NEG_INF and masked probabilities are zero; a
 * row that sees no key (a slot with context_lens == 0) writes zeros.
 * There is no LSE output.  GQA maps q head h to kv head h / (H / KH).
 *
 * What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
 *  - decode (T = 1) reads every visible K and V row once:
 *    sum_s ctx_s * KH * D * 2 (k, v) * 2 bytes (bf16) per layer, for
 *    4 * H * D flops per key: ~1 flop per byte, far below the card's
 *    ~295 flops per byte, so it is bound by device-memory bandwidth.
 *  - a prefill chunk does 4 * sum_s(unmasked q.k pairs) * D * H flops
 *    over the same bytes, and at T = 256 it is bound by arithmetic.
 *
 * What this design does about it:
 *  - one CTA per (slot, kv head, tile of 32 query rows), the rows being
 *    the group x T (q head, token) pairs that share the kv head, so each
 *    K/V page is read from HBM once per kv head and not once per q head
 *    (the TPU grid (slot, q head, kv block) re-read it group times);
 *  - the CTA walks only the keys its rows can see — at most
 *    ceil(ctx / BS) table entries, cut further by causality and by the
 *    left window — where the TPU grid swept all MB blocks and skipped
 *    the compute under pl.when;
 *  - keys are staged 64 at a time (whole pages for BS <= 64, any BS
 *    works) into shared memory with 16-byte coalesced loads, so many
 *    bytes are in flight per step; K is stored with a padded row so
 *    that each lane can dot one key against the row's q with no bank
 *    conflicts and no shuffles, and V is read as each lane's D/32
 *    contiguous head dims;
 *  - online softmax in f32 with the alpha guard for rows that have seen
 *    no key yet; the TPU's 128-lane scratch broadcast is gone (m and l
 *    live in registers).
 * Dot products run on the CUDA cores; tensor cores (mma / wgmma), TMA
 * and a split of long contexts across CTAs are later work.
 */

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kKeys = 64;  // keys staged per step: 2 per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kKeys) * (D + 1) + size_t(kKeys) * D + size_t(kRowsPerCta) * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ ctx_lens, const int* __restrict__ q_start,
    T* __restrict__ out, int t_len, int heads, int kv_heads, int block_size,
    int max_blocks, float scale, float softcap, int win_left, int win_right) {
  constexpr int E = D / 32;              // head dims per lane in P @ V
  constexpr int KS = D + 1;              // padded K row stride
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int VPR = D / VEC;           // 16-byte loads per key row
  constexpr int CH = kKeys / 32;         // keys per lane per step
  constexpr int kLoads = kKeys * VPR / kThreads;   // loads per thread per step
  constexpr int kBatch = kLoads < 8 ? kLoads : 8;
  static_assert(kKeys * VPR % kThreads == 0 && kLoads % kBatch == 0,
                "stage loads must split evenly over the threads");

  extern __shared__ float smem[];
  float* k_s = smem;                     // [kKeys][KS]
  float* v_s = k_s + kKeys * KS;         // [kKeys][D]
  float* q_s = v_s + kKeys * D;          // [kRowsPerCta][D]

  const int s = blockIdx.z;
  const int kvh = blockIdx.y;
  const int group = heads / kv_heads;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int rows = min(kRowsPerCta, group * t_len - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ctx = ctx_lens[s];
  const int q0 = q_start[s];

  // local row lr is row r = row0 + lr: token t = r / group, q head
  // kvh * group + r % group
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = row0 + i / D;
    const int h = kvh * group + r % group;
    q_s[i] = to_float(q[((size_t(s) * t_len + r / group) * heads + h) * D + i % D]);
  }

  // keys any row of this tile can see: causality ends the range at the
  // last row's position, the left window starts it at the first row's
  const int t_lo = row0 / group;
  const int t_hi = (row0 + rows - 1) / group;
  const int kv_end = min(ctx, q0 + t_hi + 1);
  const int kv_begin = win_left >= 0 ? max(0, q0 + t_lo - win_left) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][E];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int base = kv_begin; base < kv_end; base += kKeys) {
    __syncthreads();  // the previous step's readers are done
    // issue a batch of 16-byte loads before converting any of them, so
    // each thread keeps up to 2 * kBatch loads in flight
#pragma unroll
    for (int j0 = 0; j0 < kLoads; j0 += kBatch) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (j0 + j) * kThreads;
        const int kv = base + i / VPR;
        kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
        if (kv < kv_end) {
          const int blk = tables[size_t(s) * max_blocks + kv / block_size];
          const size_t off =
              ((size_t(blk) * block_size + kv % block_size) * kv_heads + kvh) * D +
              (i % VPR) * VEC;
          kr[j] = *reinterpret_cast<const uint4*>(k_pool + off);
          vr[j] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (j0 + j) * kThreads;
        const int key = i / VPR;
        const int col = (i % VPR) * VEC;
        const T* kp = reinterpret_cast<const T*>(&kr[j]);
        const T* vp = reinterpret_cast<const T*>(&vr[j]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          k_s[key * KS + col + e] = to_float(kp[e]);
          v_s[key * D + col + e] = to_float(vp[e]);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int lr = i * kWarps + warp;  // warp-uniform
      if (lr >= rows) break;
      const int qp = q0 + (row0 + lr) / group;
      const float* qrow = q_s + lr * D;
      float sc[CH];
      bool ok[CH];
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int key = c * 32 + lane;
        const int kv = base + key;
        const float* krow = k_s + key * KS;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
        float x = dot * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ok[c] = kv < kv_end && kv <= qp &&
                (win_left < 0 || kv >= qp - win_left) &&
                (win_right < 0 || kv <= qp + win_right);
        sc[c] = ok[c] ? x : kNegInf;
        tile_max = fmaxf(tile_max, sc[c]);
      }
      const float m_new = fmaxf(m[i], warp_max(tile_max));
      const float alpha = m[i] == kNegInf ? 0.f : expf(m[i] - m_new);
      float p[CH];
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        p[c] = ok[c] ? expf(sc[c] - m_new) : 0.f;
        psum += p[c];
      }
      l[i] = alpha * l[i] + warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p[c], j);
          const float* vrow = v_s + (c * 32 + j) * D + lane * E;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vrow[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int lr = i * kWarps + warp;
    if (lr >= rows) break;
    const int r = row0 + lr;
    const int h = kvh * group + r % group;
    T* orow = out + ((size_t(s) * t_len + r / group) * heads + h) * D + lane * E;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e] = from_float<T>(acc[i][e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* ctx_lens,
                   const void* q_start, void* out, int num_slots, int t_len,
                   int heads, int kv_heads, int block_size, int max_blocks,
                   float scale, float softcap, int win_left, int win_right,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  const int rows = (heads / kv_heads) * t_len;
  const dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta, kv_heads, num_slots);
  paged_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(ctx_lens), static_cast<const int*>(q_start),
      static_cast<T*>(out), t_len, heads, kv_heads, block_size, max_blocks,
      scale, softcap, win_left, win_right);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* ctx_lens, const void* q_start, void* out,
                         int num_slots, int t_len, int heads, int kv_heads,
                         int block_size, int max_blocks, float scale,
                         float softcap, int win_left, int win_right,
                         cudaStream_t stream) {
#define PAGED_CASE(DIM)                                                      \
  case DIM:                                                                  \
    return launch<T, DIM>(q, k_pool, v_pool, tables, ctx_lens, q_start, out, \
                          num_slots, t_len, heads, kv_heads, block_size,     \
                          max_blocks, scale, softcap, win_left, win_right,   \
                          stream);
  switch (head_dim) {
    PAGED_CASE(32)   // llama-tiny
    PAGED_CASE(128)  // llama3-8b
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 = success); launches on `stream` and does not synchronise.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* ctx_lens, const void* q_start, void* out, int num_slots,
    int t_len, int heads, int kv_heads, int head_dim, int block_size,
    int max_blocks, float scale, float softcap, int win_left, int win_right,
    int dtype, void* stream) {
  if (num_slots == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(head_dim, q, k_pool, v_pool, tables, ctx_lens,
                               q_start, out, num_slots, t_len, heads,
                               kv_heads, block_size, max_blocks, scale,
                               softcap, win_left, win_right, st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(
        head_dim, q, k_pool, v_pool, tables, ctx_lens, q_start, out,
        num_slots, t_len, heads, kv_heads, block_size, max_blocks, scale,
        softcap, win_left, win_right, st);
  return cudaErrorInvalidValue;
}
