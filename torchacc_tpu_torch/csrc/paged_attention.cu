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
 * Keys past the table (ctx > MB * BS) do not exist, as in the plain
 * version, which gathers MB * BS keys.
 *
 * Three bodies, chosen by the wrapper's launch plan
 * (ops/paged_attention.py::_paged_plan) from the dtype and T, never on
 * a failure:
 *
 *  paged_mma_kernel<T, D, 4, 2>   bf16 or f16, T > 1: a prefill chunk
 *  paged_mma_kernel<T, D, 1, 4>   bf16 or f16, T = 1: decode, split
 *                                 contexts
 *  paged_f32_kernel<D>            f32, any T: the exact comparison path,
 *                                 on the CUDA cores (the first port's
 *                                 body)
 *
 * The tensor-core kernel is a template on the 16-bit type T (bf16, or
 * f16 for a model trained under the fp16 loss scaler and served in its
 * compute dtype, as csrc/flash_attention.cu templates B1-B3): the pages
 * stay in T, the products run mma.sync on T with f32 sums, P enters P.V
 * as hi + lo in T, and the output is stored in T.
 *
 * What bounds each shape on an H100 (3.35 TB/s; 989 TFLOP/s bf16 on the
 * tensor cores):
 *  - decode reads every visible K and V row once, sum_s ctx_s * KH * D *
 *    2 (k, v) * 2 bytes, for 4 * H * D flops per key: ~1 flop per byte
 *    against the card's ~295, so it is bound by bytes, and what matters
 *    is enough CTAs with enough bytes in flight;
 *  - a prefill chunk of T = 256 does 4 * D * H flops for each visible
 *    (row, key) pair over the same bytes: ~400 flops per byte, bound by
 *    operations, which belong on the tensor cores.
 *
 * One tensor-core kernel serves both 16-bit shapes.  A CTA takes a tile
 * of rows, the (token, q head) pairs that share one kv head, so a K/V
 * page is read once per kv head and tile, not once per q head, against
 * one part of the keys the tile can see.  Its warps form a grid WR x
 * WK: warp (wr, wk) owns 16 rows and a quarter (WK = 4) or half (WK = 2)
 * of every 64-key stage.
 *  - Tiles: prefill 64 rows (WR = 4) x 2 key halves = 8 warps; the
 *    registers are held to 128 a thread so that two CTAs share an SM
 *    (16 warps to hide the mma and load latencies), and the plan splits
 *    the keys where the tiles alone would not fill them (2 parts at T =
 *    256, group 4: 16 tiles x 2 x 8 kv heads = 256 CTAs).  Decode: the
 *    group's rows padded to one m16 tile (WR = 1) x 4 key quarters, 3
 *    CTAs an SM; the 12 pad rows cost nothing that matters in a body
 *    bound by bytes.
 *  - Products: QK^T and P.V on mma.sync m16n8k16 (bf16 or f16 in, f32
 *    accumulate), q and K fragments by ldmatrix (q read again each
 *    step, which costs less than the registers it would hold), V by
 *    ldmatrix.trans.  Online softmax in f32 with m and l in registers;
 *    exp by the fast __expf (ex2.approx, a few ulp of f32, far inside
 *    the bf16 output's tolerance), and the output rows' rescale skipped
 *    when no row of the warp has a new maximum.  P enters P.V as hi +
 *    lo bf16 (as in B1, csrc/flash_attention.cu): a P rounded once to
 *    bf16 left short chunks outside the card tests' bf16 tolerance, so
 *    the kernel keeps ~16 bits of P and agrees with the plain f32
 *    version to about one bf16 ulp.
 *  - Stages: K and V pages stream through a ring of 2 stages of 64 keys
 *    (34 KB at D = 128: 87 KB of shared memory for a prefill CTA, 74 KB
 *    for a decode CTA; 66 KB at D = 256: 165 KB and 140 KB, one CTA an
 *    SM), in the 16-bit type, never widened; rows padded by 8 elements
 *    so that the fragment loads of a warp and the 16-byte copies spread
 *    over all 32 banks, as a swizzle would.  cp.async copies one
 *    16-byte chunk per thread and chunk of a page row (D * 2 bytes at
 *    stride KH * D * 2), so step i + 1 is in flight while step i
 *    computes (a deeper ring left more CTAs waiting for shared memory
 *    than it hid latency); keys past the part are zero-filled.  A
 *    thread divides by the block size once per stage and walks the
 *    pages from there, and reads the block-table entries a step before
 *    the copies that use them.
 *  - Masks: the walk covers only visible keys (causality ends it at the
 *    tile's last row, the left window starts it at the first row's
 *    edge), and the mask is applied only where some row of the warp
 *    cannot see the whole step.  Tiles that see the most keys go first.
 *  - Split contexts (flash-decoding): the grid is (tiles x splits, kv
 *    heads, slots).  The plan picks `splits` from the shapes alone:
 *    about 4 CTAs an SM for decode (9 at 8 slots, 8 kv heads on 132
 *    SMs), and for prefill what fills 2 CTAs an SM (2 at T = 256, where
 *    the long contexts gain most).  On the card each CTA cuts its
 *    tile's visible keys into `splits` parts of ceil(keys / splits)
 *    rounded up to whole stages, at least 128 keys, and takes its own:
 *    every slot's keys spread over the CTAs whatever its context, and
 *    context_lens, which stays on the card, never sizes the grid.  A
 *    CTA whose part is empty exits at once.
 *  - Merge: the WK warps of a row merge their (o, m, l) by LSE through
 *    shared memory, in warp order.  A tile with one used part writes the
 *    output.  Otherwise each part writes (o, m, l) in f32 to a workspace
 *    [S, KH, tiles, splits, rows, D + 2] from torch's caching allocator,
 *    and the last CTA of the tile to finish (an atomic counter per
 *    (slot, kv head, tile)) merges them by LSE and resets the counter to
 *    0, so no memset is launched.  That CTA walks the parts in part
 *    order whichever it is, so the output is bitwise the same from run
 *    to run.  Parts that saw no key (m = NEG_INF, l = 0) add nothing,
 *    and a tile that sees no key writes zeros.
 *
 * The dynamic-shared-memory limit is an attribute of a function on a
 * device, so it is set once per device and kernel (as B5 does).
 */

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kThreads = 128;     // 4 warps: the f32 body
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float cap_score(float dot, float scale, float softcap) {
  const float x = dot * scale;
  return softcap > 0.f ? softcap * tanhf(x / softcap) : x;
}

__device__ __forceinline__ bool visible(int kv, int qp, int ctx, int left, int right) {
  return kv < ctx && kv <= qp && (left < 0 || kv >= qp - left) &&
         (right < 0 || kv <= qp + right);
}

// the dynamic-shared-memory limit of `kernel` on the current device,
// set once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r != cudaSuccess) return r;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (r != cudaSuccess) return r;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// cp.async page loads
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;         // keys a stage, both tensor-core bodies
constexpr int kStages = 2;        // stages in the ring: 1 in flight while 1 computes

// 16 bytes from gmem to smem; with pred false nothing is read and the
// 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread copies one 16-byte chunk column of every RSTEP-th key row
// of a stage: N rows a stage.
template <int D, int NT>
struct PageCopy {
  static constexpr int CPR = D / 8;        // chunks a key row
  static constexpr int RSTEP = NT / CPR;
  static constexpr int N = kKeys / RSTEP;
  static_assert(NT % CPR == 0 && kKeys % RSTEP == 0, "page loads must split evenly");
};

// the pool rows (block * BS + offset) of this thread's keys of the stage
// at k0, -1 at or past kend: one division by the block size, then a walk
// over the pages; the table reads are plain loads, issued a step before
// the copies that use them
template <int D, int NT>
__device__ __forceinline__ void page_rows(int (&rows)[PageCopy<D, NT>::N], const int* table,
                                          int k0, int kend, int block_size) {
  using P = PageCopy<D, NT>;
  int key = k0 + threadIdx.x / P::CPR;
  int page = key / block_size;
  int off = key - page * block_size;
#pragma unroll
  for (int n = 0; n < P::N; ++n) {
    rows[n] = key < kend ? __ldg(table + page) * block_size + off : -1;
    key += P::RSTEP;
    off += P::RSTEP;
    while (off >= block_size) {
      off -= block_size;
      ++page;
    }
  }
}

// those rows of kv head kvh into dst [kKeys][D + 8] (16-bit), one cp.async
// a 16-byte chunk; rows -1 are zero-filled
template <int D, int NT, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* pool,
                                          const int (&rows)[PageCopy<D, NT>::N], int kv_heads,
                                          int kvh) {
  using P = PageCopy<D, NT>;
  const int col = threadIdx.x % P::CPR;
  const int r0 = threadIdx.x / P::CPR;
#pragma unroll
  for (int n = 0; n < P::N; ++n) {
    const bool ok = rows[n] >= 0;
    const T* src = ok ? pool + (size_t(rows[n]) * kv_heads + kvh) * D + col * 8 : pool;
    cp_async16(dst + (r0 + n * P::RSTEP) * (D + 8) + col * 8, src, ok);
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 on the tensor cores: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMaxGroup = 16;     // decode rows: one m16 tile (ops: _MAX_GROUP)

// d += a . b on the 16-bit type T, f32 sums
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1);
template <>
__device__ __forceinline__ void mma16<bf16>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<f16>(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to the 16-bit type T
__device__ __forceinline__ void store16(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store16(f16* p, float x) { *p = __float2half(x); }

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// x0, x1 as the sum of two pairs of the 16-bit type T: hi = T(x),
// lo = T(x - hi)
template <typename T>
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi, uint32_t& lo);
template <>
__device__ __forceinline__ void split16<bf16>(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <>
__device__ __forceinline__ void split16<f16>(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

constexpr int kMinSplitKeys = 128;   // a part takes at least 2 stages (ops: _MIN_SPLIT_KEYS)
constexpr int kMaxSplits = 32;       // parts of a tile's keys (ops: _MAX_SPLITS)

// A CTA of WR x WK warps: warp (wr, wk) owns rows [16 wr, 16 wr + 16)
// of the CTA's row tile and keys [wk * kKeys / WK, ...) of every stage.
//   prefill: WR = 4, WK = 2 (64 rows, 8 warps);
//   decode: WR = 1, WK = 4 (the group's rows, padded to 16, 4 warps).
template <int D, int WR, int WK>
struct MmaCfg {
  static constexpr int kThreads = 32 * WR * WK;
  // CTAs an SM the registers must allow: 2 prefill CTAs of 8 warps, 3
  // decode CTAs of 4 (shared memory allows as many).  At D = 256 the
  // ring alone is 132 KB, so shared memory holds one CTA an SM (165 KB
  // prefill, 140 KB decode), and a thread's 128 f32 of O need more than
  // the 128 or 170 registers those counts leave: the registers are not
  // held (ops/paged_attention.py::_ctas_per_sm plans for one)
  static constexpr int kMinBlocks = D >= 256 ? 1 : WR == 1 ? 3 : 2;
  static constexpr int kRows = 16 * WR;
  static constexpr int kKeysPerWarp = kKeys / WK;
  static constexpr int LD = D + 8;
  static constexpr int kTile = kKeys * LD;
  static constexpr size_t kRingBytes = sizeof(bf16) * size_t(kStages) * 2 * kTile;
  static constexpr size_t kSmem = sizeof(bf16) * size_t(kRows) * LD + kRingBytes;
  static_assert(kKeysPerWarp % 16 == 0, "a warp takes whole k-steps of P.V");
  static_assert(sizeof(float) * WK * kRows * (D + 2) <= kRingBytes,
                "the warps' partials are merged in the ring");
  static_assert(sizeof(float) * 2 * kRows * kMaxSplits <= kRingBytes,
                "the parts' weights are computed in the ring");
};

// grid (row tiles x splits, kv heads, slots).  A CTA takes one row tile
// (decode: the group's rows) against one of `splits` parts of the keys
// the tile can see: parts of ceil(keys / splits) keys rounded up to a
// stage, at least kMinSplitKeys, so a slot's keys spread over the CTAs
// whatever its context.  With more than one part, the parts' (o, m, l)
// go to ws [S, KH, tiles, splits, kRows, D + 2] and the last CTA of the
// tile to finish merges them.
template <typename T, int D, int WR, int WK>
__global__ void __launch_bounds__(MmaCfg<D, WR, WK>::kThreads, MmaCfg<D, WR, WK>::kMinBlocks)
    paged_mma_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ ctx_lens, const int* __restrict__ q_start,
                     T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                     int t_len, int heads, int kv_heads, int block_size, int max_blocks,
                     int splits, float scale, float softcap, int win_left, int win_right) {
  using Cfg = MmaCfg<D, WR, WK>;
  constexpr int NT = Cfg::kThreads;
  constexpr int ROWS = Cfg::kRows;
  constexpr int KPW = Cfg::kKeysPerWarp;
  constexpr int LD = Cfg::LD;
  constexpr int TILE = Cfg::kTile;
  constexpr int CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int merges;
  T* q_s = reinterpret_cast<T*>(smem_raw);         // [ROWS][LD]
  T* ring = q_s + ROWS * LD;                        // stage i: K, then V

  const int s = blockIdx.z, kvh = blockIdx.y;
  const int group = heads / kv_heads;
  const int tiles = gridDim.x / splits;
  const int tile = tiles - 1 - int(blockIdx.x) / splits;   // heaviest tiles first
  const int part = int(blockIdx.x) % splits;
  const int row0 = tile * ROWS;
  const int rows = min(ROWS, group * t_len - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tid = lane & 3;
  const int wrow = (warp % WR) * 16;
  const int wkey = (warp / WR) * KPW;
  const int ctx = min(ctx_lens[s], max_blocks * block_size);
  const int q0 = q_start[s];
  const int* table = tables + size_t(s) * max_blocks;
  // row r of the tile is (token (row0 + r) / group, q head kvh * group +
  // (row0 + r) % group)
  auto out_row = [&](int r) {
    const int rr = row0 + r;
    return out + ((size_t(s) * t_len + rr / group) * heads + kvh * group + rr % group) * D;
  };

  // the keys some row can see: causality ends the walk at the last row,
  // the left window starts it at the first; keys in [full_begin,
  // full_end) are visible to every row, so steps inside need no mask
  const int qp_lo = q0 + row0 / group;
  const int qp_hi = q0 + (row0 + rows - 1) / group;
  const int kv_end = min(ctx, qp_hi + 1);
  const int kv_begin = win_left >= 0 ? max(0, qp_lo - win_left) : 0;
  const int span = kv_end - kv_begin;
  if (span <= 0) {   // no row sees a key: part 0 writes the zeros
    if (part == 0)
      for (int i = threadIdx.x; i < rows * D; i += NT)
        store16(out_row(i / D) + i % D, 0.f);
    return;
  }
  const int per_part = (span + splits - 1) / splits;
  const int chunk = max(kMinSplitKeys, (per_part + kKeys - 1) / kKeys * kKeys);
  const int active = (span + chunk - 1) / chunk;
  if (part >= active) return;   // the tile's keys fit in fewer parts
  const int lo = kv_begin + part * chunk;
  const int hi = min(kv_end, lo + chunk);
  const int full_end = min(min(ctx, qp_lo + 1), hi);
  const int full_begin = win_left >= 0 ? qp_hi - win_left : 0;
  const int steps = (hi - lo + kKeys - 1) / kKeys;

  // rows past the tile's last read as zeros
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR;
    const bool ok = r < rows;
    const T* src = q;
    if (ok) {
      const int rr = row0 + r;
      src = q + ((size_t(s) * t_len + rr / group) * heads + kvh * group + rr % group) * D +
            (i % CPR) * 8;
    }
    cp_async16(q_s + r * LD + (i % CPR) * 8, src, ok);
  }
  int pool_rows[PageCopy<D, NT>::N];   // pool rows of the next step to issue
  page_rows<D, NT>(pool_rows, table, lo, hi, block_size);
  auto issue = [&](int j) {   // step j's K and V into stage j % kStages
    if (j < steps) {
      T* st = ring + (j % kStages) * 2 * TILE;
      copy_rows<D, NT>(st, k_pool, pool_rows, kv_heads, kvh);
      copy_rows<D, NT>(st + TILE, v_pool, pool_rows, kv_heads, kvh);
      if (j + 1 < steps)   // read now, used at the next issue
        page_rows<D, NT>(pool_rows, table, lo + (j + 1) * kKeys, hi, block_size);
    }
    cp_async_commit();   // one group a step, empty past the end
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);   // q rides in step 0's group

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < steps; ++j) {
    __syncthreads();   // step j - 1 is done with the stage step j + 1 takes
    issue(j + kStages - 1);
    cp_async_wait<kStages - 1>();   // step j has landed
    __syncthreads();
    const T* k_s = ring + (j % kStages) * 2 * TILE + wkey * LD;
    const T* v_s = k_s + TILE;
    const int k0 = lo + j * kKeys + wkey;   // this warp's first key

    // S = Q K^T; ldmatrix gives a q fragment, and the K fragments of two
    // n-tiles at once (q is read again every step: registers are what
    // limits the CTAs an SM)
    float sc[KPW / 8][4];
#pragma unroll
    for (int n = 0; n < KPW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (wrow + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < KPW / 8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, k_s + (n * 8 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                           ((lane >> 3) & 1) * 8);
        mma16<T>(sc[n], a, b[0], b[1]);
        mma16<T>(sc[n + 1], a, b[2], b[3]);
      }
    }

    const bool edge = !(k0 + KPW <= full_end && k0 >= full_begin);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = q0 + (row0 + wrow + grp + 8 * half) / group;
      float tmax = kNegInf;
#pragma unroll
      for (int n = 0; n < KPW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[n][2 * half + e];
          x = cap_score(x, scale, softcap);
          const int key = k0 + n * 8 + tid * 2 + e;
          if (edge && !(key < hi && visible(key, qp, ctx, win_left, win_right))) x = kNegInf;
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[half], tmax);
      const float alpha = m[half] == kNegInf ? 0.f : __expf(m[half] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < KPW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[n][2 * half + e];
          x = x == kNegInf ? 0.f : __expf(x - m_new);
          psum += x;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[half] = alpha * l[half] + psum;
      m[half] = m_new;
      // once the row maxima settle, alpha is 1 for the whole warp
      if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * half] *= alpha;
          acc[n][2 * half + 1] *= alpha;
        }
      }
    }

    // acc += P . V, P as hi + lo in T, V read transposed with ldmatrix
#pragma unroll
    for (int kk = 0; kk < KPW / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split16<T>(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split16<T>(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split16<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split16<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
      const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + row * LD + dn * 16 + (lane >> 4) * 8);
        mma16<T>(acc[2 * dn], ph, b[0], b[1]);
        mma16<T>(acc[2 * dn], pl, b[0], b[1]);
        mma16<T>(acc[2 * dn + 1], ph, b[2], b[3]);
        mma16<T>(acc[2 * dn + 1], pl, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();   // nothing may land after the CTA is gone
  __syncthreads();      // the ring is free for the warps' partials

  // each row's (o, m, l) from the WK warps that share it, merged by LSE
  // in warp order through shared memory
  float* warp_parts = reinterpret_cast<float*>(ring);   // [WK][ROWS][D + 2]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* pr = warp_parts + (size_t(warp / WR) * ROWS + wrow + grp + 8 * half) * (D + 2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      pr[n * 8 + tid * 2] = acc[n][2 * half];
      pr[n * 8 + tid * 2 + 1] = acc[n][2 * half + 1];
    }
    if (tid == 0) {
      pr[D] = m[half];
      pr[D + 1] = l[half];
    }
  }
  __syncthreads();
  const size_t unit = (size_t(s) * kv_heads + kvh) * tiles + tile;   // (slot, kv head, tile)
  float* parts = active > 1 ? ws + unit * splits * ROWS * (D + 2) : nullptr;
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WK; ++w) mx = fmaxf(mx, warp_parts[(w * ROWS + r) * (D + 2) + D]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float* pr = warp_parts + (w * ROWS + r) * (D + 2);
      const float c = expf(pr[D] - mx);   // 0 for a warp that saw nothing
      num = fmaf(c, pr[d], num);
      den = fmaf(c, pr[D + 1], den);
    }
    if (parts != nullptr) {   // this part's (o, m, l), for the merge below
      float* pp = parts + (size_t(part) * ROWS + r) * (D + 2);
      pp[d] = num;
      if (d == 0) {
        pp[D] = mx;
        pp[D + 1] = den;
      }
    } else {
      store16(out_row(r) + d, den == 0.f ? 0.f : num / den);
    }
  }
  if (parts == nullptr) return;

  // the last part of the tile to finish merges them all, in part order
  // whichever CTA it is, so the output does not depend on which finished
  // last; it resets the tile's counter for the next launch
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) merges = atomicAdd(counters + unit, 1) == active - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  // each (row, part)'s weight exp(m - M) / sum(exp(m - M) l), from one
  // round of loads; then every output a sum of independent loads
  float* wgt = reinterpret_cast<float*>(ring);   // [rows][active]
  float* lsum = wgt + rows * active;             // [rows][active]
  for (int i = threadIdx.x; i < rows * active; i += NT) {
    const float* pp = parts + (size_t(i % active) * ROWS + i / active) * (D + 2);
    wgt[i] = __ldcg(pp + D);
    lsum[i] = __ldcg(pp + D + 1);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += NT) {
    float mx = kNegInf;
    for (int p = 0; p < active; ++p) mx = fmaxf(mx, wgt[r * active + p]);
    float den = 0.f;
    for (int p = 0; p < active; ++p) {
      wgt[r * active + p] = expf(wgt[r * active + p] - mx);   // 0 for a part that saw nothing
      den = fmaf(wgt[r * active + p], lsum[r * active + p], den);
    }
    for (int p = 0; p < active; ++p) wgt[r * active + p] = den == 0.f ? 0.f : wgt[r * active + p] / den;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    float num = 0.f;
#pragma unroll 8
    for (int p = 0; p < active; ++p)
      num = fmaf(wgt[r * active + p], __ldcg(parts + (size_t(p) * ROWS + r) * (D + 2) + d), num);
    store16(out_row(r) + d, num);
  }
  if (threadIdx.x == 0) counters[unit] = 0;
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores (the first port's body): the exact comparison path
// ---------------------------------------------------------------------------
//
// One CTA per (32 rows, kv head, slot).  Keys are staged 64 at a time
// into shared memory with 16-byte loads; K is stored with a padded row
// so that each lane dots one key against the row's q with no bank
// conflicts, and V is read as each lane's D/32 contiguous head dims.

constexpr int kWarpsF32 = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsF32 = kWarpsF32 * kRowsPerWarp;   // ops: _ROWS_F32
constexpr int kKeysF32 = 64;

template <int D>
constexpr size_t f32_smem() {
  return sizeof(float) *
         (size_t(kKeysF32) * (D + 1) + size_t(kKeysF32) * D + size_t(kRowsF32) * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
               const float* __restrict__ v_pool, const int* __restrict__ tables,
               const int* __restrict__ ctx_lens, const int* __restrict__ q_start,
               float* __restrict__ out, int t_len, int heads, int kv_heads, int block_size,
               int max_blocks, float scale, float softcap, int win_left, int win_right) {
  constexpr int E = D / 32;              // head dims per lane in P @ V
  constexpr int KS = D + 1;              // padded K row stride
  constexpr int VEC = 4;                 // floats per 16-byte load
  constexpr int VPR = D / VEC;           // 16-byte loads per key row
  constexpr int CH = kKeysF32 / 32;      // keys per lane per step
  constexpr int kLoads = kKeysF32 * VPR / kThreads;   // loads per thread per step
  constexpr int kBatch = kLoads < 8 ? kLoads : 8;
  static_assert(kKeysF32 * VPR % kThreads == 0 && kLoads % kBatch == 0,
                "stage loads must split evenly over the threads");

  extern __shared__ float smem[];
  float* k_s = smem;                     // [kKeysF32][KS]
  float* v_s = k_s + kKeysF32 * KS;      // [kKeysF32][D]
  float* q_s = v_s + kKeysF32 * D;       // [kRowsF32][D]

  const int s = blockIdx.z;
  const int kvh = blockIdx.y;
  const int group = heads / kv_heads;
  const int row0 = blockIdx.x * kRowsF32;
  const int rows = min(kRowsF32, group * t_len - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ctx = min(ctx_lens[s], max_blocks * block_size);
  const int q0 = q_start[s];

  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = row0 + i / D;
    const int h = kvh * group + r % group;
    q_s[i] = q[((size_t(s) * t_len + r / group) * heads + h) * D + i % D];
  }

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

  for (int base = kv_begin; base < kv_end; base += kKeysF32) {
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int j0 = 0; j0 < kLoads; j0 += kBatch) {
      float4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (j0 + j) * kThreads;
        const int kv = base + i / VPR;
        kr[j] = vr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kv < kv_end) {
          const int blk = tables[size_t(s) * max_blocks + kv / block_size];
          const size_t off =
              ((size_t(blk) * block_size + kv % block_size) * kv_heads + kvh) * D +
              (i % VPR) * VEC;
          kr[j] = *reinterpret_cast<const float4*>(k_pool + off);
          vr[j] = *reinterpret_cast<const float4*>(v_pool + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = threadIdx.x + (j0 + j) * kThreads;
        const int key = i / VPR;
        const int col = (i % VPR) * VEC;
        float* kd = k_s + key * KS + col;
        kd[0] = kr[j].x;
        kd[1] = kr[j].y;
        kd[2] = kr[j].z;
        kd[3] = kr[j].w;
        *reinterpret_cast<float4*>(v_s + key * D + col) = vr[j];
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int lr = i * kWarpsF32 + warp;  // warp-uniform
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
        const float x = cap_score(dot, scale, softcap);
        ok[c] = kv < kv_end && visible(kv, qp, ctx, win_left, win_right);
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
    const int lr = i * kWarpsF32 + warp;
    if (lr >= rows) break;
    const int r = row0 + lr;
    const int h = kvh * group + r % group;
    float* orow = out + ((size_t(s) * t_len + r / group) * heads + h) * D + lane * E;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e] = acc[i][e] / denom;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k_pool, *v_pool, *tables, *ctx_lens, *q_start;
  void *out, *ws, *counters;
  int num_slots, t_len, heads, kv_heads, block_size, max_blocks, grid_x, splits;
  float scale, softcap;
  int win_left, win_right;
  cudaStream_t stream;
};

// prefill: 64 rows x 8 warps; decode: the group's rows x 4 warps; T the
// 16-bit type
template <typename T, int D, bool DECODE>
cudaError_t launch_mma(const Args& a) {
  constexpr int WR = DECODE ? 1 : 4, WK = DECODE ? 4 : 2;
  using Cfg = MmaCfg<D, WR, WK>;
  if ((DECODE && (a.heads / a.kv_heads > kMaxGroup || a.t_len != 1)) || a.splits <= 0 || a.splits > kMaxSplits ||
      a.grid_x % a.splits != 0 || (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  static bool done[kMaxDevices];
  const auto kernel = paged_mma_kernel<T, D, WR, WK>;
  cudaError_t r = allow_smem(kernel, Cfg::kSmem, done);
  if (r != cudaSuccess) return r;
  kernel<<<dim3(a.grid_x, a.kv_heads, a.num_slots), Cfg::kThreads, Cfg::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.ctx_lens), static_cast<const int*>(a.q_start),
      static_cast<T*>(a.out), static_cast<float*>(a.ws), static_cast<int*>(a.counters),
      a.t_len, a.heads, a.kv_heads, a.block_size, a.max_blocks, a.splits, a.scale,
      a.softcap, a.win_left, a.win_right);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  static bool done[kMaxDevices];
  const auto kernel = paged_f32_kernel<D>;
  cudaError_t r = allow_smem(kernel, f32_smem<D>(), done);
  if (r != cudaSuccess) return r;
  kernel<<<dim3(a.grid_x, a.kv_heads, a.num_slots), kThreads, f32_smem<D>(), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_pool),
      static_cast<const float*>(a.v_pool), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.ctx_lens), static_cast<const int*>(a.q_start),
      static_cast<float*>(a.out), a.t_len, a.heads, a.kv_heads, a.block_size, a.max_blocks,
      a.scale, a.softcap, a.win_left, a.win_right);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_body(int body, const Args& a) {
  switch (body) {
    case 0: return launch_f32<D>(a);
    case 1: return launch_mma<bf16, D, false>(a);
    case 2: return launch_mma<bf16, D, true>(a);
    case 3: return launch_mma<f16, D, false>(a);
    case 4: return launch_mma<f16, D, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// body (ops/paged_attention.py _BODY_CODE): 0 = f32 on the CUDA cores,
// 1 = bf16 prefill on the tensor cores (T > 1), 2 = bf16 split decode
// (T = 1; ws and counters needed when grid_x > 1), 3 and 4 the same two
// in f16.  The grid is
// (grid_x, kv_heads, num_slots).  Returns the cudaError_t of the launch
// (0 = success); launches on `stream` and does not synchronise.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* ctx_lens, const void* q_start, void* out, void* ws, void* counters,
    int num_slots, int t_len, int heads, int kv_heads, int head_dim, int block_size,
    int max_blocks, int body, int grid_x, int splits, float scale, float softcap,
    int win_left, int win_right, void* stream) {
  if (num_slots == 0 || t_len == 0) return 0;
  if (grid_x <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || block_size <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, tables, ctx_lens, q_start, out, ws, counters,
               num_slots, t_len, heads, kv_heads, block_size, max_blocks, grid_x, splits,
               scale, softcap, win_left, win_right, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 32: return launch_body<32>(body, a);     // llama-tiny
    case 64: return launch_body<64>(body, a);     // Llama-3.2-1B, Qwen2-0.5B
    case 128: return launch_body<128>(body, a);   // llama3-8b
    case 256: return launch_body<256>(body, a);   // the Gemma family
    default: return cudaErrorInvalidValue;
  }
}
