"""Quantized matmuls: int8 / fp8 forward products with delayed scaling
(the port of torchacc_tpu/ops/quantized_matmul.py, same public names).

Activations are quantized with one per-tensor scale taken from an
**amax history** of earlier steps (so the scale is known before the
tensor is read), weights with just-in-time **per-channel** scales.
Formats: int8 symmetric [-127, 127], round half to even; fp8 e4m3
(``torch.float8_e4m3fn``), clipped to +-448 before the cast.

Two executable paths, chosen like ``ops/flash_attention.py``:

- the kernels (``csrc/quantized_matmul.cu``, B5, built at first use and
  bound with ctypes), two launches a call: a quantize pass writes each
  operand once, K-major, ``qx [M, Kp]`` and ``qw [N, Kp]`` (``Kp`` = K
  rounded up to 16, the pad zero; int8 bytes, or the e4m3 values of fp8
  as float16, which holds each exactly), then a GEMM on TMA-fed shared
  memory and ``wgmma`` (int8 with an int32 accumulator; f16 with an f32
  one, since Hopper's e4m3 ``wgmma`` keeps fewer bits of its sums than
  f32) writes ``acc * (sx * sw[n])`` in ``x``'s dtype.
  :func:`_qmm_plan` lays out what both are launched with.  Each call
  adds one to :data:`launch_counts` under the format's name, where the
  kernels launch.
- the plain version (:func:`_qmm2d_plain`): the plain counterparts of
  the two kernels, :func:`_quantize_pass_plain` (explicit quantize into
  the padded operands) and :func:`_gemm_plain` (an exact product,
  dequantize).  The CPU path and the tests use it, and ``chip_smoke.py``
  holds the kernels against it on the card.  For int8 both paths
  accumulate exact integers and share every rounding, so the kernels and
  the plain version agree **bitwise**.

``impl``: 'auto' sends CUDA tensors to the kernel and CPU tensors to the
plain version; 'cuda' forces the kernel (and raises on CPU tensors);
'torch' forces the plain version.  No path falls back from a kernel
that fails to build or launch: it raises.

Gradients: the forward product is quantized, the backward runs in the
compute dtype on the **saved unquantized operands** with the scales as
constants (the straight-through estimator of the JAX ``_qmm2d_bwd``,
:269): two plain ``torch.matmul``s, outside any kernel as in JAX.  The
forward is a ``torch.library`` custom op with a registered autograd
formula, so the selective checkpoint policies of ``utils/remat.py`` see
it as one op and save its output inside the named sites.

The two scale reductions (``max|x|``, per-channel ``max|w|`` over the
contracting dim) are outside the kernel, as they are outside the Pallas
kernel in JAX (:335-337, :439); they stay plain torch and never
synchronise the host.

The delayed-scaling state is functional here as in flax: a site takes
its history and returns the new one (:class:`QuantLinear`,
:func:`quant_linear`); the model and the ``Trainer`` carry it
(``TrainState.quant``).
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from torchacc_tpu_torch.ops import _build
from torchacc_tpu_torch.ops._common import (
    check_local,
    resolve_device,
    round_up,
)

#: quantization formats: dtype + largest representable magnitude.  int8
#: uses the symmetric [-127, 127] range; fp8 is e4m3 (max finite 448),
#: the forward-pass format (gradients stay in the compute dtype).
_FORMATS = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
_FMT_CODE = {"int8": 0, "fp8": 1}
#: the dtype of the quantized operands the GEMM reads: fp8's e4m3 values
#: as float16 (every one exact), for the f16 tensor cores' f32 sums
_OPERAND_DTYPE = {"int8": torch.int8, "fp8": torch.float16}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# int32 accumulation is exact while 127^2 * K < 2^31, i.e. K < 133 144
_INT8_MAX_K = 133_000

#: B5 calls so far (a quantize pass and a GEMM each), counted where the
#: kernels launch; chip_smoke.py sets them to 0 before the quantized
#: training run and reads them after
launch_counts = {"int8": 0, "fp8": 0}
#: the GEMM's CTA tile: rows of M (two warpgroups of 64) and bytes of K
#: a stage (one 128-byte swizzle row)
_BM, _BK = 128, 128


def quant_formats() -> Tuple[str, ...]:
    return tuple(_FORMATS)


def _fmt(fmt: str) -> Tuple[Any, float]:
    if fmt not in _FORMATS:
        raise ValueError(f"quant format must be one of {tuple(_FORMATS)}, "
                         f"got {fmt!r}")
    return _FORMATS[fmt]


# ---------------------------------------------------------------------------
# scales + (de)quantize
# ---------------------------------------------------------------------------

def _f32(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=None if like is None else like.device)


def compute_scale(amax, fmt: str) -> torch.Tensor:
    """``scale = amax / qmax`` in f32, guarded so an all-zero tensor
    (amax 0) quantizes through scale 1 instead of dividing by zero."""
    _, qmax = _fmt(fmt)
    amax = _f32(amax)
    return torch.where(amax > 0.0, amax / qmax, torch.ones_like(amax))


def quantize(x: torch.Tensor, scale, fmt: str) -> torch.Tensor:
    """Quantize ``x / scale`` into the format's dtype (saturating).
    int8 rounds half to even and clips to +-127; fp8 clips to +-448
    before the cast (an e4m3 overflow would give NaN, not saturate).
    The clip comes before the round, as in JAX (:102-104)."""
    dt, qmax = _fmt(fmt)
    y = x.to(torch.float32) / _f32(scale, x)
    y = y.clamp(-qmax, qmax)
    if fmt == "int8":
        y = torch.round(y)
    return y.to(dt)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * _f32(scale, q)


def _amax(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``max|x|`` in f32, in one pass and without an ``|x|`` copy (min
    and max are exact in any dtype)."""
    if x.numel() == 0:
        shape = () if dim is None else tuple(
            s for i, s in enumerate(x.shape) if i != dim % x.ndim)
        return torch.zeros(shape, dtype=torch.float32, device=x.device)
    lo, hi = torch.aminmax(x) if dim is None else torch.aminmax(x, dim=dim)
    return torch.maximum(-lo, hi).to(torch.float32)


def per_channel_scale(w2d: torch.Tensor, fmt: str) -> torch.Tensor:
    """Just-in-time per-output-channel scale ``[N]`` for a ``[K, N]``
    weight (amax over the contracting dim).  An ``nn.Linear`` weight is
    ``[N, K]``: pass ``weight.t()``, so the amax runs over its dim 1."""
    return compute_scale(_amax(w2d, dim=0), fmt)


# ---------------------------------------------------------------------------
# delayed scaling (amax history)
# ---------------------------------------------------------------------------

def amax_history_init(length: int, device=None) -> torch.Tensor:
    """Fresh rolling amax history (f32 zeros: "no observation yet", and
    :func:`delayed_scale` falls back to the current amax)."""
    return torch.zeros((int(length),), dtype=torch.float32, device=device)


def delayed_scale(history: torch.Tensor, amax_now, fmt: str) -> torch.Tensor:
    """Per-tensor scale from the amax HISTORY (max over the window);
    falls back to ``amax_now`` while the history is still all zeros.
    The choice is a ``torch.where`` on the device: nothing is read back
    to the host."""
    amax_h = history.max()
    return compute_scale(
        torch.where(amax_h > 0.0, amax_h, _f32(amax_now, history)), fmt)


def update_amax_history(history: torch.Tensor, amax_now) -> torch.Tensor:
    """Roll the window and record the current step's amax at slot 0 (a
    new tensor; the old history is left as it was)."""
    now = _f32(amax_now, history).reshape(1).to(history.device)
    return torch.cat([now, history[:-1]])


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _exact_dot(qx: torch.Tensor, qw: torch.Tensor, fmt: str) -> torch.Tensor:
    """``qx [M, K] @ qw [K, N]`` as f32: int8 through exact integer
    sums (bitwise what an int32 accumulator gives), fp8 through f32
    sums of the exact products."""
    if fmt == "fp8":
        return torch.matmul(qx.to(torch.float32), qw.to(torch.float32))
    if qx.device.type == "cuda":
        # f64 holds every partial sum exactly (|sum| <= 127^2 K < 2^31)
        return torch.matmul(qx.to(torch.float64),
                            qw.to(torch.float64)).to(torch.float32)
    return torch.matmul(qx.to(torch.int32),
                        qw.to(torch.int32)).to(torch.float32)


def _padded_k(k: int) -> int:
    """``Kp``: K rounded up to 16, at least 16 (TMA's row stride is a
    multiple of 16 bytes)."""
    return max(16, round_up(k, 16))


def _quantize_pass_plain(x2d: torch.Tensor, w2d: torch.Tensor,
                         sx: torch.Tensor, sw: torch.Tensor, fmt: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the quantize kernel writes, plainly: ``qx [M, Kp]`` and
    ``qw [N, Kp]`` in :data:`_OPERAND_DTYPE`, both K-major, the pad
    columns ``K..Kp`` zero."""
    kp = _padded_k(x2d.shape[1])
    dt = _OPERAND_DTYPE[fmt]

    def padded(q):
        out = torch.zeros((q.shape[0], kp), dtype=dt, device=q.device)
        out[:, :q.shape[1]] = q.to(dt)
        return out
    return (padded(quantize(x2d, sx, fmt)),
            padded(quantize(w2d, sw[None, :], fmt).t()))


def _gemm_plain(qx: torch.Tensor, qw: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, fmt: str) -> torch.Tensor:
    """What the GEMM kernel computes, plainly: the exact dot of the
    padded ``qx [M, Kp]`` and ``qw [N, Kp]``, then ``acc * (sx * sw[n])``
    as two rounded multiplies.  f32 result."""
    return _exact_dot(qx, qw.t(), fmt) * (sx.to(torch.float32) * sw)[None, :]


def _qmm2d_plain(x2d: torch.Tensor, w2d: torch.Tensor, sx: torch.Tensor,
                 sw: torch.Tensor, fmt: str) -> torch.Tensor:
    """``[M, K] @ [K, N]`` on explicitly quantized operands (the JAX
    ``_qmm2d_xla``, :152): the two kernels' plain counterparts.  The pad
    columns add exact zeros.  f32 result."""
    return _gemm_plain(*_quantize_pass_plain(x2d, w2d, sx, sw, fmt), sx, sw,
                       fmt)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

class QmmPlan(NamedTuple):
    """What B5's two kernels are launched with, from the shapes and
    strides alone."""
    m: int
    n: int
    k: int
    kp: int                  # K rounded up to 16: the rows of qx and qw
    w_layout: str            # 'nk': [N, K] row-major; 'kn': [K, N] row-major
    ldw: int                 # the weight's leading dimension, in elements
    w_copy: bool             # neither layout: the weight is copied to 'kn'
    bn: int                  # columns of a GEMM CTA tile: 128 or 256
    map_a: Tuple             # qx's TMA map in bytes: dims (row, M), stride, box
    map_b: Tuple             # qw's TMA map in bytes: dims (row, N), stride, box


def _qmm_plan(x2d: torch.Tensor, w2d: torch.Tensor, fmt: str) -> QmmPlan:
    """Lay out B5's launches for ``x2d [M, K] @ w2d [K, N]`` (x
    contiguous; the weight in either layout, read where it lies), and
    refuse what the kernels do not take.  N up to 1024 takes 128-column
    tiles, the rest 256."""
    _fmt(fmt)
    m, k = x2d.shape
    n = w2d.shape[1]
    if x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes float32 or bfloat16, got "
                         f"{x2d.dtype}")
    if w2d.dtype != x2d.dtype:
        raise ValueError(f"kernel dtype {w2d.dtype} must match x "
                         f"{x2d.dtype}")
    if fmt == "int8" and k > _INT8_MAX_K:
        raise ValueError(
            f"int8: K = {k} > {_INT8_MAX_K} could overflow the int32 "
            f"accumulator (127^2 * K must stay below 2^31)")
    kp = _padded_k(k)
    if max(m, n, kp) >= 2**31:
        raise ValueError(f"x [{m}, {k}] @ [{k}, {n}] is beyond the kernels' "
                         f"32-bit sizes")
    w_copy = False
    if w2d.stride(0) == 1 and w2d.stride(1) >= max(k, 1):
        w_layout, ldw = "nk", w2d.stride(1)
    elif w2d.stride(1) == 1 and w2d.stride(0) >= max(n, 1):
        w_layout, ldw = "kn", w2d.stride(0)
    else:
        w_layout, ldw, w_copy = "kn", n, True
    bn = 128 if n <= 1024 else 256
    row = kp * _OPERAND_DTYPE[fmt].itemsize
    return QmmPlan(m=m, n=n, k=k, kp=kp, w_layout=w_layout, ldw=ldw,
                   w_copy=w_copy, bn=bn, map_a=((row, m), row, (_BK, _BM)),
                   map_b=((row, n), row, (_BK, bn)))


def _lib():
    """The bound C entry points (built and loaded at first use)."""
    lib = _build.load("quantized_matmul")
    if lib.qmm_quantize.argtypes is None:
        # x, w, sx, sw, qx, qw; M, N, K, Kp; ldw; w_kn, fmt, dtype; stream
        lib.qmm_quantize.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.qmm_quantize.restype = ctypes.c_int
        # qx, qw, sx, sw, out; M, N, Kp, bn, fmt, dtype; stream
        lib.qmm_gemm.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
        lib.qmm_gemm.restype = ctypes.c_int
    return lib


def _check(err: int, what: str, plan: QmmPlan, fmt: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"quantized-matmul {what} launch failed: error {err} "
            f"(cudaError_t; 100000: no cuTensorMapEncodeTiled; 200000 + a "
            f"CUresult: the map was refused) for {fmt}, x [{plan.m}, "
            f"{plan.k}], n {plan.n}")


def _quantize_cuda(plan: QmmPlan, x2d, w2d, sx, sw, fmt):
    """The quantize kernel: ``(qx [M, Kp], qw [N, Kp])``."""
    dt = _OPERAND_DTYPE[fmt]
    qx = torch.empty((plan.m, plan.kp), dtype=dt, device=x2d.device)
    qw = torch.empty((plan.n, plan.kp), dtype=dt, device=x2d.device)
    err = _lib().qmm_quantize(
        x2d.data_ptr(), w2d.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        qx.data_ptr(), qw.data_ptr(), plan.m, plan.n, plan.k, plan.kp,
        plan.ldw, int(plan.w_layout == "kn"), _FMT_CODE[fmt],
        _DTYPE_CODE[x2d.dtype],
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _check(err, "quantize", plan, fmt)
    return qx, qw


def _gemm_cuda(plan: QmmPlan, qx, qw, sx, sw, fmt, dtype):
    """The GEMM: ``[M, N]`` in ``dtype``."""
    out = torch.empty((plan.m, plan.n), dtype=dtype, device=qx.device)
    err = _lib().qmm_gemm(
        qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), plan.m, plan.n, plan.kp, plan.bn, _FMT_CODE[fmt],
        _DTYPE_CODE[dtype],
        torch.cuda.current_stream(qx.device).cuda_stream)
    _check(err, "GEMM", plan, fmt)
    return out


def _cuda_operands(x2d, w2d, sx, sw, fmt):
    """Validated operands of the kernels and their plan."""
    for name, t in (("x", x2d), ("kernel", w2d), ("x_scale", sx),
                    ("the weight scale", sw)):
        if t.device.type != "cuda":
            raise ValueError(
                f"the quantized-matmul kernel needs CUDA tensors; {name} is "
                f"on {t.device} (use impl='torch' for the plain version)")
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
    x2d = x2d.contiguous()
    plan = _qmm_plan(x2d, w2d, fmt)
    if plan.w_copy:
        w2d = w2d.contiguous()
    return (plan, x2d, w2d, sx.to(torch.float32).reshape(1).contiguous(),
            sw.to(torch.float32).contiguous())


def _qmm2d_cuda(x2d: torch.Tensor, w2d: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, fmt: str) -> torch.Tensor:
    """B5: the quantize pass, then the GEMM.  ``w2d`` is ``[K, N]`` with
    either dim contiguous (``weight.t()`` of an ``nn.Linear`` is read as
    it lies, ``[N, K]`` row-major).  Returns ``[M, N]`` in ``x2d``'s
    dtype."""
    plan, x2d, w2d, sx, sw = _cuda_operands(x2d, w2d, sx, sw, fmt)
    if plan.m == 0 or plan.n == 0:
        return torch.empty((plan.m, plan.n), dtype=x2d.dtype,
                           device=x2d.device)
    qx, qw = _quantize_cuda(plan, x2d, w2d, sx, sw, fmt)
    out = _gemm_cuda(plan, qx, qw, sx, sw, fmt, x2d.dtype)
    launch_counts[fmt] += 1
    return out


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl == "auto":
        return x.device.type == "cuda"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be auto|cuda|torch, got {impl!r}")
    return impl == "cuda"


# ---------------------------------------------------------------------------
# the custom op (seen whole by selective checkpointing)
# ---------------------------------------------------------------------------

@torch.library.custom_op("torchacc_tpu_torch::qmm_fwd", mutates_args=())
def _qmm_fwd_op(x2d: torch.Tensor, w2d: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, fmt: str, impl: str) -> torch.Tensor:
    if _use_kernel(impl, x2d):
        return _qmm2d_cuda(x2d, w2d, sx, sw, fmt)
    return _qmm2d_plain(x2d, w2d, sx, sw, fmt).to(x2d.dtype)


def _setup_context(ctx, inputs, output):
    x2d, w2d = inputs[:2]
    ctx.save_for_backward(x2d, w2d)


def _backward(ctx, g):
    # straight-through: the backward in the compute dtype on the saved
    # unquantized operands; the scales are constants
    x2d, w2d = ctx.saved_tensors
    g = g.to(x2d.dtype)
    dx = torch.matmul(g, w2d.to(g.dtype).t())
    if w2d.stride(0) == 1:
        # the weight lies [N, K] (an nn.Linear): make dw in that layout,
        # so that its gradient comes out contiguous
        dw = torch.matmul(g.t(), x2d).t()
    else:
        dw = torch.matmul(x2d.t(), g)
    return dx.to(x2d.dtype), dw.to(w2d.dtype), None, None, None, None


_qmm_fwd_op.register_autograd(_backward, setup_context=_setup_context)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _prod(dims) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


def quantized_dot(
    x: torch.Tensor,
    kernel: torch.Tensor,
    contract_ndim: int = 1,
    *,
    fmt: str = "int8",
    x_scale: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Quantized ``x @ kernel`` contracting ``x``'s trailing
    ``contract_ndim`` dims with ``kernel``'s leading ones (the flax
    ``DenseGeneral`` convention: kernel is ``[*contract_dims,
    *feature_dims]``; for an ``nn.Linear`` pass ``weight.t()``, which is
    read where it lies).

    ``x_scale``: per-tensor activation scale (from
    :func:`delayed_scale`); None derives it just-in-time from
    ``max|x|``.  Weights always use just-in-time per-channel scales.
    ``impl``: 'auto' (the kernel for CUDA tensors, the plain version for
    CPU tensors) | 'cuda' | 'torch'.  Returns ``x.dtype``."""
    check_local(x=x, kernel=kernel, x_scale=x_scale)
    _fmt(fmt)
    _use_kernel(impl, x)                          # validate impl
    cd = int(contract_ndim)
    if cd < 1 or cd > min(x.ndim, kernel.ndim - 1):
        raise ValueError(
            f"contract_ndim {cd} invalid for x{tuple(x.shape)} @ "
            f"k{tuple(kernel.shape)}")
    if tuple(x.shape[x.ndim - cd:]) != tuple(kernel.shape[:cd]):
        raise ValueError(
            f"contracting dims mismatch: x{tuple(x.shape)} vs kernel"
            f"{tuple(kernel.shape)} over the trailing/leading {cd} dim(s)")
    batch_shape = tuple(x.shape[:x.ndim - cd])
    feat_shape = tuple(kernel.shape[cd:])
    k_sz, n_sz = _prod(kernel.shape[:cd]), _prod(feat_shape)
    m_sz = x.numel() // k_sz if x.numel() else 0
    x2d = x.reshape(m_sz, k_sz)
    w2d = kernel.reshape(k_sz, n_sz)
    with torch.no_grad():
        if x_scale is None:
            x_scale = compute_scale(_amax(x2d), fmt)
        sw = per_channel_scale(w2d, fmt)
        sx = _f32(x_scale, x2d).to(x2d.device).reshape(())
    y = _qmm_fwd_op(x2d, w2d, sx, sw, fmt, impl)
    return y.reshape(batch_shape + feat_shape)


def quantized_matmul_reference(
    x: torch.Tensor,
    kernel: torch.Tensor,
    contract_ndim: int = 1,
    *,
    fmt: str = "int8",
    x_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32 numerics anchor: dequantize(quantize(.)) on both operands,
    then a plain f32 matmul.  The other paths differ from this only by
    accumulation order."""
    cd = int(contract_ndim)
    batch_shape = tuple(x.shape[:x.ndim - cd])
    feat_shape = tuple(kernel.shape[cd:])
    k_sz = _prod(kernel.shape[:cd])
    x2d = x.reshape(-1, k_sz).to(torch.float32)
    w2d = kernel.reshape(k_sz, -1).to(torch.float32)
    if x_scale is None:
        x_scale = compute_scale(_amax(x2d), fmt)
    sw = per_channel_scale(w2d, fmt)
    xd = dequantize(quantize(x2d, x_scale, fmt), x_scale)
    wd = dequantize(quantize(w2d, sw[None, :], fmt), sw[None, :])
    return (xd @ wd).reshape(batch_shape + feat_shape)


# ---------------------------------------------------------------------------
# a Linear with a quantized forward and delayed scaling
# ---------------------------------------------------------------------------

def quant_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], history: torch.Tensor, *,
                 fmt: str, impl: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 update: bool = True, amax_groups: Sequence[Any] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantized forward of a Linear site (``QuantDenseGeneral.
    __call__``, :410): ``x [..., K]`` and ``weight [N, K]`` go to the
    compute ``dtype``; the activation scale is
    ``delayed_scale(history, max|x|)``; the bias is added after the
    quantized product, in the compute dtype.  Returns ``(y, history')``:
    the history with this call's amax recorded, or ``history`` itself
    when ``update`` is false (an evaluation reads the scales and changes
    nothing).  The history is never changed in place.

    ``amax_groups``: the process groups of the data axes.  Where the
    batch is split over ranks, ``max|x|`` is all-reduced (MAX) over them
    before it is used, as GSPMD takes the JAX package's amax over the
    whole global batch; otherwise the ranks' scales and histories would
    part.  The weight's amax needs no reduce: inside FSDP2's forward the
    weight is the all-gathered one."""
    xc = x.to(dtype)
    wc = weight.to(dtype)
    with torch.no_grad():
        amax_now = _amax(xc)
        for group in amax_groups:
            dist.all_reduce(amax_now, op=dist.ReduceOp.MAX, group=group)
        sx = delayed_scale(history, amax_now, fmt)
        new_history = (update_amax_history(history, amax_now) if update
                       else history)
    y = quantized_dot(xc, wc.t(), 1, fmt=fmt, x_scale=sx, impl=impl)
    if bias is not None:
        y = y + bias.to(dtype)
    return y, new_history


class QuantLinear(nn.Linear):
    """``nn.Linear`` with a quantized forward matmul (the counterpart of
    the flax ``QuantDenseGeneral``, :377).  Parameter names, shapes and
    initialisation are ``nn.Linear``'s, so swapping a site between the
    two keeps checkpoints: quantization flips execution, never layout.

    The delayed-scaling amax history is not held by the module: as the
    flax ``'quant'`` collection is passed to ``apply``, ``forward``
    takes the site's history and returns ``(y, new_history)``; with
    ``update=False`` (the collection not mutable: evaluation) the
    history comes back as it was.  The weights are made on the card
    unless ``device`` says otherwise."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, quant: str = "int8",
                 quant_impl: str = "auto", amax_history_len: int = 16,
                 compute_dtype: torch.dtype = torch.float32,
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias,
                         device=resolve_device(device), dtype=dtype)
        _fmt(quant)
        self.quant = quant
        self.quant_impl = quant_impl
        self.amax_history_len = int(amax_history_len)
        self.compute_dtype = compute_dtype

    def init_history(self) -> torch.Tensor:
        return amax_history_init(self.amax_history_len,
                                 device=self.weight.device)

    def forward(self, x: torch.Tensor, history: torch.Tensor,
                update: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        return quant_linear(x, self.weight, self.bias, history,
                            fmt=self.quant, impl=self.quant_impl,
                            dtype=self.compute_dtype, update=update)
