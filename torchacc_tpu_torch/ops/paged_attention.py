"""Block-table (paged) attention for the serving engine.

The port of torchacc_tpu/ops/paged_attention.py.  Queries are
``[S, T, H, D]`` (S slots, T tokens per slot: 1 for decode, a chunk for
prefill, already rope-rotated); one layer's pool is ``[NB, BS, KH, D]``;
``block_tables [S, MB]`` maps each slot's logical blocks to pool
blocks; ``context_lens [S]`` counts every banked token of the slot
(chunk included: the pool is written before attention); ``q_start [S]``
is the position of the slot's first query row, so causality is
``kv_pos <= q_start + t``.  Slots with ``context_lens == 0`` give zeros.

- ``_paged_attention_cuda``: the hand-written Hopper kernels
  (``csrc/paged_attention.cu``), built at first use and bound with
  ctypes.  :func:`_paged_plan` picks the body and lays out its launch:
  bf16 or f16 prefill chunks on the tensor cores, bf16 or f16 decode
  with the context split across CTAs and merged in the kernel, f32 on
  the CUDA cores.
  Each call is one launch and adds one to :data:`launch_counts`, under
  its shape: ``"decode"`` for ``T == 1``, ``"prefill"`` for a chunk.
- ``_paged_attention_torch``: the plain PyTorch version, numerically the
  JAX ``_paged_attention_xla`` (f32 scores, NEG_INF mask, masked
  probabilities zeroed).  The CPU tests and the comparison phase of
  ``chip_smoke.py`` use it.

``impl``: 'auto' sends CUDA tensors to the kernel and CPU tensors to the
plain version; 'cuda' forces the kernel (and raises on CPU tensors);
'torch' forces the plain version.  There is no fallback from a kernel
that fails to build or launch: it raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from torchacc_tpu_torch.ops import _build
from torchacc_tpu_torch.ops._common import NEG_INF, check_local

#: kernel launches so far by shape, counted where the kernel launches;
#: chip_smoke.py sets both to 0 before the serving run and reads them after
launch_counts = {"decode": 0, "prefill": 0}

# llama-tiny; Llama-3.2-1B and Qwen2-0.5B; llama3-8b; the Gemma family
_KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the kernel bodies (paged_attention_fwd's ``body``) by (plan body,
# dtype): the tensor-core bodies are one template on the 16-bit type
_BODY_CODE = {("f32", torch.float32): 0,
              ("prefill_mma", torch.bfloat16): 1,
              ("decode_split", torch.bfloat16): 2,
              ("prefill_mma", torch.float16): 3,
              ("decode_split", torch.float16): 4}
_ROWS_F32 = 32          # rows a CTA of the f32 body (kRowsF32)
_ROWS_MMA = 64          # rows a CTA of the tensor-core prefill
_DECODE_ROWS = 16       # rows of a decode CTA: the group, padded to m16
_MAX_GROUP = _DECODE_ROWS   # q heads per kv head the decode body takes
_MIN_SPLIT_KEYS = 128   # keys a part takes at least (kMinSplitKeys)
_MAX_SPLITS = 32        # parts a tile's keys are cut into (kMaxSplits)
_CTAS_PER_SM = 4        # decode CTAs an SM
_PREFILL_CTAS_PER_SM = 2   # prefill CTAs an SM (kMinBlocks)
_MAX_GRID_YZ = 65535    # CUDA's limit on grid dims y (kv heads), z (slots)


def _ctas_per_sm(decode: bool, d: int) -> int:
    """The CTAs an SM the plan fills for a body at head dim ``d``: up to
    128, 4 decode CTAs (3 resident, kMinBlocks, and one queued) and the 2
    prefill CTAs that kMinBlocks holds; at 256 a CTA's ring (132 KB of
    shared memory) leaves room for one an SM, of either body."""
    if d >= 256:
        return 1
    return _CTAS_PER_SM if decode else _PREFILL_CTAS_PER_SM


def _paged_attention_torch(q, k_pool, v_pool, block_tables, context_lens,
                           q_start, scale, window, logit_softcap):
    s_, t_, h, d = q.shape
    nb, bs, kh, _ = k_pool.shape
    mb = block_tables.shape[1]
    tables = block_tables.long()
    # gather each slot's pages into a dense [S, MB*BS, ...] view (the
    # kernel never materialises this)
    k = k_pool[tables].reshape(s_, mb * bs, kh, d)
    v = v_pool[tables].reshape(s_, mb * bs, kh, d)
    if kh != h:
        # kv head of q head i is i // group (jnp.repeat order)
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("sthd,skhd->shtk", q.float(), k.float()) * scale
    if logit_softcap > 0.0:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    dev = q.device
    kv_pos = torch.arange(mb * bs, dtype=torch.int32, device=dev)
    q_pos = (q_start.to(torch.int32)[:, None]
             + torch.arange(t_, dtype=torch.int32, device=dev))   # [S, T]
    mask = ((kv_pos[None, None, :]
             < context_lens.to(torch.int32)[:, None, None])
            & (kv_pos[None, None, :] <= q_pos[:, :, None]))    # [S, T, K]
    left, right = window
    if left >= 0:
        mask &= kv_pos[None, None, :] >= q_pos[:, :, None] - left
    if right >= 0:
        mask &= kv_pos[None, None, :] <= q_pos[:, :, None] + right
    mask = mask[:, None, :, :]                               # [S, 1, T, K]
    scores = torch.where(mask, scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    out = torch.einsum("shtk,skhd->sthd", probs, v.float())
    return out.to(q.dtype)


class PagedPlan(NamedTuple):
    """How one call launches: the kernel body, its grid ``(row tiles x
    splits, kv heads, slots)``, the query rows of a tile (the rows are
    the (token, q head) pairs of one kv head) and the parts each tile's
    keys are split into."""

    body: str
    grid: Tuple[int, int, int]
    rows: int
    splits: int


@functools.lru_cache(maxsize=256)
def _paged_plan(q_shape: Tuple[int, int, int, int],
                pool_shape: Tuple[int, int, int, int], max_blocks: int,
                dtype: torch.dtype, sms: int) -> PagedPlan:
    """Lay out B4's launch for ``q [S, T, H, D]`` over a pool ``[NB, BS,
    KH, D]`` with tables ``[S, max_blocks]`` on a card of ``sms`` SMs.

    - f32 (any T): the CUDA-core body, 32 rows a CTA, keys unsplit;
    - bf16 or f16 prefill (T > 1): 64-row tiles on the tensor cores;
      the keys are split where the tiles alone would not fill the CTAs
      an SM holds (``_ctas_per_sm``: two, one at head dim 256);
    - bf16 or f16 decode (T = 1): the group's rows (padded to 16) a
      CTA, the keys split into about ``_ctas_per_sm * sms / (S * KH)``
      parts.

    The two 16-bit types take the same layout.

    The kernel cuts a tile's visible keys into ``splits`` parts of whole
    64-key stages, at least ``_MIN_SPLIT_KEYS`` each, on the card: the
    grid comes from the shapes and the table width alone, never from
    ``context_lens``, which stays on the card.  The table width caps the
    parts at what a full table could fill."""
    s_, t_, h, d = q_shape
    _, bs, kh, _ = pool_shape
    group = h // kh
    if s_ > _MAX_GRID_YZ or kh > _MAX_GRID_YZ:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_YZ} slots "
                         f"and kv heads, got {s_} and {kh}")
    cdiv = lambda a, b: -(-a // b)
    if dtype == torch.float32:
        return PagedPlan("f32", (cdiv(group * t_, _ROWS_F32), kh, s_),
                         _ROWS_F32, 1)
    max_parts = min(_MAX_SPLITS, max(1, cdiv(max_blocks * bs,
                                             _MIN_SPLIT_KEYS)))
    if t_ > 1:
        tiles = cdiv(group * t_, _ROWS_MMA)
        splits = min(max_parts, max(
            1, _ctas_per_sm(False, d) * sms // (s_ * kh * tiles)))
        return PagedPlan("prefill_mma", (tiles * splits, kh, s_), _ROWS_MMA,
                         splits)
    if group > _MAX_GROUP:
        raise ValueError(
            f"the 16-bit decode kernel takes at most {_MAX_GROUP} q heads per "
            f"kv head, got {group}")
    splits = min(max_parts, cdiv(_ctas_per_sm(True, d) * sms, s_ * kh))
    return PagedPlan("decode_split", (splits, kh, s_), _DECODE_ROWS, splits)


#: per (device, stream): the merge counters of split keys, one per
#: (slot, kv head, row tile).  Zeroed once when made; the merging CTA
#: resets each counter it used, so no call launches a memset.
_merge_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _merge_counters.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _merge_counters[(device.index, stream)] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_kernel_args(q, k_pool, v_pool, block_tables, context_lens,
                       q_start) -> None:
    """Raise on anything the kernel does not take."""
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "context_lens": context_lens,
               "q_start": q_start}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(
                f"the paged-attention kernel needs CUDA tensors; {name} is "
                f"on {t.device} (use impl='torch' for the plain version)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32, bfloat16 or float16, got "
                         f"{q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype}/{v_pool.dtype} must "
                         f"match q dtype {q.dtype}")
    # the kernel indexes these per slot without bounds: a short one
    # would be read past its end
    if (k_pool.ndim != 4 or block_tables.ndim != 2
            or tuple(q_start.shape) != (q.shape[0],)):
        raise ValueError(
            f"kernel takes k_pool [NB, BS, KH, D], block_tables [S, MB] and "
            f"q_start [S]; got {tuple(k_pool.shape)}, "
            f"{tuple(block_tables.shape)}, {tuple(q_start.shape)}")
    d = q.shape[-1]
    if d not in _KERNEL_HEAD_DIMS or k_pool.shape[-1] != d:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS} "
                         f"(q and pool alike), got {d} / {k_pool.shape[-1]}")
    if k_pool.shape[0] * k_pool.shape[1] >= 2**31:
        raise ValueError(f"the kernel indexes pool rows with 32 bits; got "
                         f"{k_pool.shape[0]} x {k_pool.shape[1]}")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_fn():
    """The bound C entry point (built and loaded at first use)."""
    fn = _build.load("paged_attention").paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, context_lens,
                          q_start, scale, window, logit_softcap):
    _check_kernel_args(q, k_pool, v_pool, block_tables, context_lens, q_start)
    s_, t_, h, d = q.shape
    _, bs, kh, _ = k_pool.shape
    mb = block_tables.shape[1]
    plan = _paged_plan(tuple(q.shape), tuple(k_pool.shape), mb, q.dtype,
                       _sm_count(q.device.index))
    fn = _kernel_fn()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = None
    counters = 0
    if plan.splits > 1:
        # each part's (o, m, l), from the caching allocator
        ws = torch.empty(s_ * kh * plan.grid[0] * plan.rows * (d + 2),
                         dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream,
                             s_ * kh * plan.grid[0] // plan.splits).data_ptr()
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(),
             q_start.data_ptr(), out.data_ptr(),
             0 if ws is None else ws.data_ptr(), counters,
             s_, t_, h, kh, d, bs, mb, _BODY_CODE[plan.body, q.dtype],
             plan.grid[0],
             plan.splits, float(scale), float(logit_softcap),
             int(window[0]), int(window[1]), stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError {err} "
            f"(q {tuple(q.shape)} {q.dtype}, pool {tuple(k_pool.shape)}, "
            f"{plan})")
    launch_counts["decode" if t_ == 1 else "prefill"] += 1
    return out


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    q_start: torch.Tensor,
    *,
    scale: Optional[float] = None,
    window: Tuple[int, int] = (-1, -1),
    logit_softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """Causal attention of ``q [S, T, H, D]`` over a paged KV pool (see
    the module docstring).  Returns ``[S, T, H, D]`` in q's dtype.

    ``impl``: 'auto' (the kernel for CUDA tensors, the plain version for
    CPU tensors) | 'cuda' | 'torch'."""
    check_local(q=q, k_pool=k_pool, v_pool=v_pool)
    if q.ndim != 4:
        raise ValueError(f"q must be [slots, t, heads, head_dim], got "
                         f"{tuple(q.shape)}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} != v_pool "
                         f"{tuple(v_pool.shape)}")
    s_, t_, h, d = q.shape
    kh = k_pool.shape[2]
    if h % kh != 0:
        raise ValueError(
            f"num q heads ({h}) must be a multiple of kv heads ({kh})")
    if block_tables.shape[0] != s_ or tuple(context_lens.shape) != (s_,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / context_lens "
            f"{tuple(context_lens.shape)} do not match {s_} slots")
    if scale is None:
        scale = d ** -0.5
    if impl == "auto":
        impl = "cuda" if q.device.type == "cuda" else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be auto|cuda|torch, got {impl!r}")
    fn = (_paged_attention_cuda if impl == "cuda"
          else _paged_attention_torch)
    ints = [t.to(torch.int32).contiguous()
            for t in (block_tables, context_lens, q_start)]
    return fn(q, k_pool, v_pool, *ints,
              float(scale), tuple(window), float(logit_softcap))
