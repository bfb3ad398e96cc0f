"""Rematerialisation (gradient checkpointing) policies: the port of
torchacc_tpu/utils/remat.py ``remat_policy`` (:45) and
``offload_is_live`` (:32) on ``torch.utils.checkpoint``.

JAX names values inside a block (``checkpoint_name``) and its policies
save the named ones; everything else is recomputed from them in the
backward, by data flow.  Torch's selective checkpointing works per op
instead: the backward re-runs the region's forward, and an op whose
outputs the policy saved returns them from the cache instead of
computing again.  So the port names *sites*: the model wraps its
projections in :func:`checkpoint_name`, and a policy saves the matmul
outputs made inside the named sites (a quantized site's matmul is the
quantized-matmul forward op, so its kernel does not re-run), plus the
flash-attention forward op whole (``o`` and ``lse``, JAX's
``attn_ctx``/``attn_lse``; under context parallelism the ``cp_fwd`` op,
so that a recompute never walks the ring again):

=========================  ==================================================
'nothing'                  save nothing: the region's whole forward re-runs,
                           the flash-attention forward kernel included
'dots'                     every matmul output (JAX ``checkpoint_dots``);
                           the flash-attention forward re-runs, as JAX's
                           Pallas kernel is no dot
'dots_with_no_batch_dims'  the matmuls whose operands carry no batch
                           dimension (``mm``/``addmm``, the dense
                           projections; not ``bmm``)
'save_attn'                q/k/v projections, o and lse of the attention,
                           the o projection (``attn_out``), the mlp output
                           (``mlp_out``); the ffn-width gate/up projections
                           and every norm and elementwise op are recomputed
'save_attn_mlp'            'save_attn' + the gate/up projections: the
                           recompute is elementwise only
'offload_dots'             the ``attn_out`` and ``mlp_out`` products go to
                           host memory (pinned, on the card) and come back
                           in the backward; everything else is recomputed
=========================  ==================================================

Where JAX saves the q/k after RoPE, the port saves the projections and
recomputes RoPE (elementwise).

'offload_dots' is a region of its own (:class:`_OffloadRegion`), not a
selective-checkpoint policy: torch's policies can keep an op's output
only on the device.  The region runs its forward without a graph,
copying each offloaded product to host memory as it is made (on a CUDA
device: into pinned memory on a side stream, the source held for that
stream by ``record_stream``); its backward queues the copies back to the
card behind an event wait on each (so the step's stream never reads a
copy that has not landed), re-runs the forward with a graph in which the
two products are those copies (their gradient formulas are the
product's, :class:`_GivenProduct`), and back-propagates through it.  The
host is CPU memory on every device, so the CPU runs the same path (JAX
falls back to 'dots' where its backend has no pinned host memory).
:data:`offload_counts` counts the bytes each way.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

import torchacc_tpu_torch.ops.context_parallel  # noqa: F401  (the op below)
import torchacc_tpu_torch.ops.flash_attention  # noqa: F401  (the op below)
import torchacc_tpu_torch.ops.quantized_matmul  # noqa: F401  (the op below)

_POLICY_NAMES = {
    "save_attn": ("qkv_proj", "attn_out", "mlp_out"),
    "save_attn_mlp": ("qkv_proj", "attn_out", "mlp_out", "mlp_gate_up"),
}
# matmuls without batch dimensions; the quantized forward product of a
# site counts as its matmul
_DOTS_NO_BATCH = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  torch.ops.torchacc_tpu_torch.qmm_fwd.default}
_MATMULS = _DOTS_NO_BATCH | {torch.ops.aten.bmm.default}
_FLASH_FWD = torch.ops.torchacc_tpu_torch.flash_fwd.default
# the context-parallel attention (ring and all-to-alls) is one op too
_CP_FWD = torch.ops.torchacc_tpu_torch.cp_fwd.default
# the sites whose products 'offload_dots' moves to host memory
_OFFLOADED = ("attn_out", "mlp_out")

#: bytes 'offload_dots' has copied to host memory and back, counted where
#: each copy is queued; chip_smoke.py sets them to 0 before a run
offload_counts = {"to_host_bytes": 0, "to_device_bytes": 0}

# the innermost site of each thread (the recompute of a checkpoint
# region runs in autograd's thread)
_local = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Mark the ops made inside as the site ``name`` (the JAX
    ``checkpoint_name`` of the same value)."""
    outer = getattr(_local, "site", None)
    _local.site = name
    try:
        yield
    finally:
        _local.site = outer


def offload_is_live(memory_cfg) -> bool:
    """Whether ``memory_cfg`` offloads the remat residuals to host
    memory ('offload_dots', or ``offload_activations``).  Host memory is
    there on every device of the port, so this is what the config asks
    for."""
    return bool(getattr(memory_cfg, "offload_activations", False)
                or (getattr(memory_cfg, "gc", False)
                    and getattr(memory_cfg, "gc_policy", "")
                    == "offload_dots"))


def remat_policy(name: str = "nothing") -> Optional[Callable]:
    """The selective-checkpoint policy function of ``name`` (None for
    'nothing': plain checkpointing, which recomputes every op;
    'offload_dots' is a region of its own, see :func:`checkpoint_block`)."""
    if name == "nothing":
        return None
    if name in ("dots", "dots_with_no_batch_dims"):
        dots = _MATMULS if name == "dots" else _DOTS_NO_BATCH

        def dot_policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in dots
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        return dot_policy
    if name not in _POLICY_NAMES:
        raise ValueError(f"unknown remat policy {name!r}")
    saved = frozenset(_POLICY_NAMES[name])

    def policy(ctx, op, *args, **kwargs):
        if op in (_FLASH_FWD, _CP_FWD) or (op in _MATMULS and getattr(
                _local, "site", None) in saved):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def checkpoint_block(fn: Callable, policy_name: str, *args):
    """``fn(*args)`` as a checkpoint region under ``policy_name``; the
    first arg is the region's differentiable input."""
    if policy_name == "offload_dots":
        return _OffloadRegion.apply(fn, *args)
    policy = remat_policy(policy_name)
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# 'offload_dots'
# ---------------------------------------------------------------------------

_streams = {}


def _offload_stream(device: torch.device):
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device=device)
    return stream


class _Tape:
    """The offloaded products of one region call, in forward order: on
    the forward they are copied to host memory; the backward brings them
    all back and the recompute takes them in the same order."""

    def __init__(self):
        self.recording = True
        self.host, self.events, self.back = [], [], []

    def save(self, y: torch.Tensor) -> None:
        if y.is_cuda:
            stream = _offload_stream(y.device)
            stream.wait_stream(torch.cuda.current_stream(y.device))
            with torch.cuda.stream(stream):
                h = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                h.copy_(y, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            # the caching allocator must not hand y's memory out again
            # before the side stream has read it
            y.record_stream(stream)
        else:
            h, event = y.clone(), None
        offload_counts["to_host_bytes"] += y.numel() * y.element_size()
        self.host.append(h)
        self.events.append(event)

    def bring_back(self, device: torch.device) -> None:
        self.recording = False
        for h, event in zip(self.host, self.events):
            if event is not None:
                # the step's stream reads the copy only once it landed
                torch.cuda.current_stream(device).wait_event(event)
                d = h.to(device, non_blocking=True)
            else:
                d = h
            offload_counts["to_device_bytes"] += h.numel() * h.element_size()
            self.back.append(d)
        self.host, self.events = [], []
        self.back.reverse()

    def take(self) -> torch.Tensor:
        return self.back.pop()


class _GivenProduct(torch.autograd.Function):
    """``y`` as the product ``x @ w^T`` it is a copy of: the value is
    ``y``, the gradients are the product's."""

    @staticmethod
    def forward(ctx, x, w, y):
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g2 = gy.reshape(-1, gy.shape[-1])
        gx = g2.mm(w).view(*gy.shape[:-1], w.shape[1])
        gw = g2.t().mm(x.reshape(-1, x.shape[-1]))
        return gx, gw, None


def offload_product(operands: Callable, product: Callable) -> torch.Tensor:
    """A projection's product ``x @ w^T``: ``product()`` computes it,
    ``operands()`` gives ``(x, w)`` as the product reads them.  Inside
    an 'offload_dots' region at an offloaded site, the forward copies
    the product to host memory and the backward's recompute takes that
    copy instead of computing it again."""
    tape = getattr(_local, "tape", None)
    if tape is None or getattr(_local, "site", None) not in _OFFLOADED:
        return product()
    if tape.recording:
        y = product()
        tape.save(y)
        return y
    return _GivenProduct.apply(*operands(), tape.take())


@contextlib.contextmanager
def _with_tape(tape):
    outer = getattr(_local, "tape", None)
    _local.tape = tape
    try:
        yield
    finally:
        _local.tape = outer


class _OffloadRegion(torch.autograd.Function):
    """``fn(x, *rest)`` with the 'offload_dots' residuals (module
    docstring); ``rest`` gets no gradient.  ``fn`` returns a tensor, or
    a tuple of them (a mixture of experts' block: its output and its
    router loss)."""

    @staticmethod
    def forward(ctx, fn, x, *rest):
        tape = _Tape()
        with _with_tape(tape), torch.no_grad():
            y = fn(x, *rest)
        ctx.fn, ctx.tape = fn, tape
        ctx.save_for_backward(x, *rest)
        return y

    @staticmethod
    def backward(ctx, *gys):
        x, *rest = ctx.saved_tensors
        ctx.tape.bring_back(x.device)
        xr = x.detach().requires_grad_(True)
        with _with_tape(ctx.tape), torch.enable_grad():
            y = ctx.fn(xr, *rest)
        ys = y if isinstance(y, tuple) else (y,)
        torch.autograd.backward(ys, gys)
        return (None, xr.grad) + (None,) * len(rest)
