"""Flash attention forward and backward (the port of
torchacc_tpu/ops/flash_attention.py): causal, sliding window, packed
segment ids, GQA/MQA, score softcap, ALiBi, dropout on P @ V, and the
per-row log-sum-exp.

- The kernels (``csrc/flash_attention.cu``), built at first use and
  bound with ctypes: B1 the forward, B2 dq and B3 dk/dv, for float32,
  bfloat16 and float16 inputs.  Each launch
  adds one to :data:`launch_counts` under ``"fwd"``, ``"bwd_dq"`` or
  ``"bwd_dkv"``, where the kernel launches.
- The plain versions (``ops/attention.py``): the CPU path, the tests,
  and what ``chip_smoke.py`` holds the kernels against.

``impl``: 'auto' sends CUDA tensors to the kernels and CPU tensors to
the plain versions; 'cuda' forces the kernels (and raises on CPU
tensors); 'torch' forces the plain versions.  No path falls back from a
kernel that fails to build or launch: it raises.

The gradient of :func:`flash_attention` comes from the backward
kernels (or the plain backward, for ``impl='torch'``), never from
autograd through plain ops.  Both directions are ``torch.library``
custom ops with a registered autograd formula, so that the selective
checkpoint policies of ``utils/remat.py`` see the forward as one op
and can save its outputs (``o`` and ``lse``, the JAX package's
``attn_ctx``/``attn_lse``): under ``save_attn*`` the forward kernel runs
once per layer and step, not again in the recompute.

ALiBi slopes are hyperparameters and get no gradient.  Dropout keeps a
pair by the stateless coordinate hash of ``ops/_common.py`` (seed,
batch, q head, q position, k position), the same bits in the forward,
both backward kernels, the plain version and the JAX package; it scales
P for P @ V only, so the LSE is the undropped one.

The global offsets (the q/k/h/b entries of the JAX ``meta`` operand,
``_make_meta`` ``:734``) are host ints: ``q_offset``/``k_offset`` move
the mask and ALiBi geometry to ``shift = sk - sq + q_offset -
k_offset`` (a context-parallel ring step sees its chunks where they lie
in the whole sequence), and dropout hashes ``(b_offset + b, h_offset +
h, q_offset + i, k_offset + j)``, so that a ring step, a head shard or
a batch shard draws the masks of the whole call.
"""

import ctypes
from typing import Optional, Tuple

import torch

from torchacc_tpu_torch.ops import _build
from torchacc_tpu_torch.ops._common import check_local, dropout_threshold
from torchacc_tpu_torch.ops.attention import (
    attention_reference,
    attention_reference_bwd,
)

#: kernel launches so far, counted where each kernel launches;
#: chip_smoke.py sets them to 0 before the training run and reads them after
launch_counts = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

# llama-tiny; Llama-3.2-1B, Qwen2-0.5B and GPT-2; Phi-2 and Pythia-2.8B;
# Phi-3-mini; llama3-8b; the Gemma family (one library each, built side
# by side: ops/_build.py SPLIT)
_KERNEL_HEAD_DIMS = _build.SPLIT["flash_attention"][1]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def segment_ids_from_positions(positions: torch.Tensor) -> torch.Tensor:
    """Packed-sequence segment ids from position ids that reset to 0 at
    each document start."""
    starts = (positions == 0).to(torch.int32)
    return torch.cumsum(starts, dim=-1, dtype=torch.int32) - 1


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _kernel_fns(d: int):
    """The bound C entry points of head dim ``d``'s library (built and
    loaded at first use)."""
    lib = _build.load("flash_attention", d)
    fwd, dq, dkv = (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                    lib.flash_attention_bwd_dkv)
    if fwd.argtypes is None:
        # b, sq, sk, hq, hk, d, causal, left, right; scale, softcap;
        # dropout on, seed, threshold, 1 / (1 - p); the q, k, h and b
        # offsets; dtype, stream
        tail = ([ctypes.c_int] * 9 + [ctypes.c_float] * 2
                + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_float] + [ctypes.c_int] * 4
                + [ctypes.c_int, ctypes.c_void_p])
        fwd.argtypes = [ctypes.c_void_p] * 8 + tail
        dq.argtypes = [ctypes.c_void_p] * 10 + tail
        dkv.argtypes = [ctypes.c_void_p] * 11 + tail
        for fn in (fwd, dq, dkv):
            fn.restype = ctypes.c_int
    return fwd, dq, dkv


def _check_kernel_args(tensors, segs) -> None:
    """Raise on anything the kernels do not take."""
    q = tensors["q"]
    for name, t in list(tensors.items()) + list(segs.items()):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(
                f"the flash-attention kernels need CUDA tensors; {name} is "
                f"on {t.device} (use impl='torch' for the plain version)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernels take float32, bfloat16 or float16, got "
                         f"{q.dtype}")
    for name, t in tensors.items():
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} must match q {q.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    d = q.shape[-1]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernels take head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    for name, t in segs.items():
        if t is None:
            continue
        want = torch.float32 if name == "alibi_slopes" else torch.int32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")


def _geom(q, k, causal, window, scale, softcap, dropout_p, dropout_seed,
          offsets=(0, 0, 0, 0)):
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    return [b, sq, sk, hq, hk, d, int(causal), int(window[0]),
            int(window[1]), float(scale), float(softcap),
            int(dropout_p > 0.0), int(dropout_seed) & 0xFFFFFFFF,
            dropout_threshold(dropout_p),
            1.0 / (1.0 - dropout_p) if dropout_p > 0.0 else 1.0,
            *(int(x) for x in offsets)]


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _raise_on(err, name, q):
    if err != 0:
        raise RuntimeError(
            f"flash-attention {name} kernel launch failed: error {err} "
            f"(a cudaError_t; 100000: no tensor-map encoder; 200000 + a "
            f"CUresult: a tensor map refused) "
            f"(q {tuple(q.shape)} {q.dtype})")


def _fwd_cuda(q, k, v, qseg, kseg, causal, window, scale, softcap,
              alibi=None, dropout_p=0.0, dropout_seed=0,
              offsets=(0, 0, 0, 0)):
    _check_kernel_args({"q": q, "k": k, "v": v},
                       {"q_segment_ids": qseg, "kv_segment_ids": kseg,
                        "alibi_slopes": alibi})
    fwd, _, _ = _kernel_fns(q.shape[-1])
    b, sq, hq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg),
              _ptr(kseg), _ptr(alibi), o.data_ptr(), lse.data_ptr(),
              *_geom(q, k, causal, window, scale, softcap, dropout_p,
                     dropout_seed, offsets),
              _DTYPE_CODE[q.dtype], stream)
    _raise_on(err, "forward", q)
    launch_counts["fwd"] += 1
    return o, lse


def _bwd_delta(o, do):
    """delta = rowsum(dO * O) in f32, ``[b, hq, sq]``: computed outside
    the kernels, as in JAX (:555)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()


def _bwd_ptrs(q, k, v, do, lse, delta, qseg, kseg, alibi):
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg),
            _ptr(kseg), _ptr(alibi), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr()]


def _dq_cuda(q, k, v, do, lse, delta, qseg, kseg, causal, window, scale,
             softcap, alibi=None, dropout_p=0.0, dropout_seed=0,
             offsets=(0, 0, 0, 0)):
    """B2: dq from the saved lse and delta (one launch)."""
    _, dq_fn, _ = _kernel_fns(q.shape[-1])
    dq = torch.empty_like(q)
    err = dq_fn(*_bwd_ptrs(q, k, v, do, lse, delta, qseg, kseg, alibi),
                dq.data_ptr(),
                *_geom(q, k, causal, window, scale, softcap, dropout_p,
                       dropout_seed, offsets),
                _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "dq", q)
    launch_counts["bwd_dq"] += 1
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, qseg, kseg, causal, window, scale,
              softcap, alibi=None, dropout_p=0.0, dropout_seed=0,
              offsets=(0, 0, 0, 0)):
    """B3: dk and dv from the saved lse and delta (one launch)."""
    _, _, dkv_fn = _kernel_fns(q.shape[-1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = dkv_fn(*_bwd_ptrs(q, k, v, do, lse, delta, qseg, kseg, alibi),
                 dk.data_ptr(), dv.data_ptr(),
                 *_geom(q, k, causal, window, scale, softcap, dropout_p,
                        dropout_seed, offsets),
                 _DTYPE_CODE[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "dk/dv", q)
    launch_counts["bwd_dkv"] += 1
    return dk, dv


def _bwd_cuda(q, k, v, o, lse, do, qseg, kseg, causal, window, scale,
              softcap, alibi=None, dropout_p=0.0, dropout_seed=0,
              offsets=(0, 0, 0, 0)):
    _check_kernel_args({"q": q, "k": k, "v": v, "o": o, "do": do},
                       {"q_segment_ids": qseg, "kv_segment_ids": kseg,
                        "alibi_slopes": alibi})
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32 [b, hq, sq]")
    args = (q, k, v, do, lse, _bwd_delta(o, do), qseg, kseg, causal,
            window, scale, softcap, alibi, dropout_p, dropout_seed, offsets)
    return (_dq_cuda(*args),) + _dkv_cuda(*args)


def _use_kernel(impl: str, q: torch.Tensor) -> bool:
    if impl == "auto":
        return q.device.type == "cuda"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be auto|cuda|torch, got {impl!r}")
    return impl == "cuda"


# ---------------------------------------------------------------------------
# the custom ops (one op each way, seen whole by selective checkpointing)
# ---------------------------------------------------------------------------

@torch.library.custom_op("torchacc_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_segment_ids: Optional[torch.Tensor],
                  kv_segment_ids: Optional[torch.Tensor],
                  alibi_slopes: Optional[torch.Tensor], causal: bool,
                  window_left: int, window_right: int, scale: float,
                  logit_softcap: float, dropout_p: float, dropout_seed: int,
                  q_offset: int, k_offset: int, h_offset: int,
                  b_offset: int,
                  impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    window = (window_left, window_right)
    offsets = (q_offset, k_offset, h_offset, b_offset)
    if _use_kernel(impl, q):
        return _fwd_cuda(q, k, v, q_segment_ids, kv_segment_ids, causal,
                         window, scale, logit_softcap, alibi_slopes,
                         dropout_p, dropout_seed, offsets)
    o, lse = attention_reference(
        q, k, v, causal=causal, window=window, scale=scale,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        alibi_slopes=alibi_slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed, q_offset=q_offset, k_offset=k_offset,
        h_offset=h_offset, b_offset=b_offset, return_lse=True,
        logit_softcap=logit_softcap)
    return o, lse.contiguous()


@torch.library.custom_op("torchacc_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  q_segment_ids: Optional[torch.Tensor],
                  kv_segment_ids: Optional[torch.Tensor],
                  alibi_slopes: Optional[torch.Tensor], causal: bool,
                  window_left: int, window_right: int, scale: float,
                  logit_softcap: float, dropout_p: float, dropout_seed: int,
                  q_offset: int, k_offset: int, h_offset: int,
                  b_offset: int, impl: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    window = (window_left, window_right)
    offsets = (q_offset, k_offset, h_offset, b_offset)
    if _use_kernel(impl, q):
        return _bwd_cuda(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids,
                         causal, window, scale, logit_softcap, alibi_slopes,
                         dropout_p, dropout_seed, offsets)
    return attention_reference_bwd(
        q, k, v, o, lse, do, causal=causal, window=window, scale=scale,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        alibi_slopes=alibi_slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed, q_offset=q_offset, k_offset=k_offset,
        h_offset=h_offset, b_offset=b_offset, logit_softcap=logit_softcap)


def _setup_context(ctx, inputs, output):
    q, k, v, qseg, kseg, alibi = inputs[:6]
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, qseg, kseg, alibi)
    ctx.params = inputs[6:]
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse, qseg, kseg, alibi = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, o, lse, do.contiguous(), qseg, kseg,
                               alibi, *ctx.params)
    # the slopes are hyperparameters: no gradient (JAX :803)
    return (dq, dk, dv) + (None,) * 15


_flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)


# ---------------------------------------------------------------------------
# public API (BSHD)
# ---------------------------------------------------------------------------

def _prepare(q, k, v, q_segment_ids, kv_segment_ids, alibi_slopes,
             dropout_p, dropout_seed, offsets, scale):
    check_local(q=q, k=k, v=v, q_segment_ids=q_segment_ids,
                kv_segment_ids=kv_segment_ids, alibi_slopes=alibi_slopes)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q [b, sq, hq, d], k/v [b, sk, hk, d] expected; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hq, hk = q.shape[2], k.shape[2]
    if hq % hk != 0:
        raise ValueError(
            f"num q heads ({hq}) must be a multiple of kv heads ({hk})")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be provided together")
    if alibi_slopes is not None:
        if tuple(alibi_slopes.shape) != (hq,):
            raise ValueError(
                f"alibi_slopes must have shape ({hq},) (one slope per q "
                f"head), got {tuple(alibi_slopes.shape)}")
        alibi_slopes = alibi_slopes.detach().to(torch.float32).contiguous()
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_seed is not None and not isinstance(dropout_seed, int):
        raise TypeError(
            f"dropout_seed must be a host int (the train step), got "
            f"{type(dropout_seed).__name__}")
    for name, x in zip(("q_offset", "k_offset", "h_offset", "b_offset"),
                       offsets):
        if not isinstance(x, int) or isinstance(x, bool):
            raise TypeError(f"{name} must be a host int, got "
                            f"{type(x).__name__}")
        if not -2 ** 31 <= x < 2 ** 31:
            raise ValueError(f"{name} {x} does not fit in int32")
    segs = [None if s is None else s.to(torch.int32).contiguous()
            for s in (q_segment_ids, kv_segment_ids)]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    seed = 0 if dropout_seed is None else int(dropout_seed)
    return (q.contiguous(), k.contiguous(), v.contiguous(), segs,
            alibi_slopes, float(dropout_p), seed, float(scale),
            tuple(offsets))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Tuple[int, int] = (-1, -1),
    scale: Optional[float] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    q_offset=0,
    k_offset=0,
    h_offset=0,
    b_offset=0,
    return_lse: bool = False,
    logit_softcap: float = 0.0,
    impl: str = "auto",
):
    """``[b, s, h, d]`` flash attention.  Returns ``out`` (differentiable,
    through the backward kernels) or, with ``return_lse``, ``(out,
    lse [b, h, sq] f32)`` with no gradient, as in JAX (the forward-only
    path of the context-parallel ring).  ``alibi_slopes``: ``[hq]`` f32
    per-head slopes.  ``dropout_p`` / ``dropout_seed``: dropout on the
    post-softmax probabilities; the seed is a host int (None = 0), and
    the same seed gives the same mask on every path.  ``q_offset``,
    ``k_offset``, ``h_offset``, ``b_offset``: host ints, the global
    position of the local q and kv rows, of head 0 and of batch row 0
    (the context-parallel ring's chunks; a head or batch shard)."""
    q, k, v, (qseg, kseg), alibi, dropout_p, seed, scale, offs = _prepare(
        q, k, v, q_segment_ids, kv_segment_ids, alibi_slopes, dropout_p,
        dropout_seed, (q_offset, k_offset, h_offset, b_offset), scale)
    args = (q, k, v, qseg, kseg, alibi, bool(causal), int(window[0]),
            int(window[1]), scale, float(logit_softcap), dropout_p, seed,
            *offs, impl)
    if return_lse:
        with torch.no_grad():
            return _flash_fwd_op(*args)
    return _flash_fwd_op(*args)[0]


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Tuple[int, int] = (-1, -1),
    scale: Optional[float] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    q_offset=0,
    k_offset=0,
    h_offset=0,
    b_offset=0,
    logit_softcap: float = 0.0,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standalone backward: ``(dq, dk, dv)`` from saved ``(o, lse)``,
    BSHD in and out, lse ``[b, h, sq]`` f32, at the same offsets as the
    forward."""
    q, k, v, (qseg, kseg), alibi, dropout_p, seed, scale, offs = _prepare(
        q, k, v, q_segment_ids, kv_segment_ids, alibi_slopes, dropout_p,
        dropout_seed, (q_offset, k_offset, h_offset, b_offset), scale)
    return _flash_bwd_op(q, k, v, o.contiguous(),
                         lse.to(torch.float32).contiguous(),
                         do.contiguous(), qseg, kseg, alibi, bool(causal),
                         int(window[0]), int(window[1]), scale,
                         float(logit_softcap), dropout_p, seed, *offs, impl)
