"""Fused linear + cross entropy (the port of torchacc_tpu/ops/fused.py
``fused_linear_cross_entropy``, :40).

The head matmul and the CE loss are computed one chunk of rows at a
time, and the backward recomputes each chunk's logits instead of
saving them, so the full ``[tokens, vocab]`` f32 logits (4.2 GB at
8192 tokens and Llama-3's 128256 vocab) never exist; one chunk's do.
JAX computes this outside any Pallas kernel, so it is plain torch here
too.  Each chunk's logits are the f32 result of the operands in their
own dtype, as JAX's ``preferred_element_type=jnp.float32`` dot gives
them (:104-105), never a bf16 product cast afterwards: on the card
``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS, f32 output); on the
CPU the operands are upcast to f32, where the products of bf16 values
are exact.  The backward's matmuls take the operands' dtype, and dx and
dw come out in it, as JAX's VJP returns them.  The serving head
(``models.transformer.head_logits``) rounds its logits in the compute
dtype, as JAX's does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _softcap(z: torch.Tensor, cap: float) -> torch.Tensor:
    return z if cap <= 0.0 else torch.tanh(z / cap) * cap


def _logits_f32(x, w):
    """``x @ w`` as f32 from operands in their own dtype: a choice by
    device, not a fallback (a PyTorch without ``aten::mm.dtype`` for
    CUDA raises, naming it)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda":
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _chunk_loss(x, w, y, cap):
    """f32 logits of one chunk (softcapped), their lse, the valid mask
    and the chunk's loss sum."""
    z = _softcap(_logits_f32(x, w), cap)
    lse = torch.logsumexp(z, dim=-1)
    valid = y != -100
    safe = torch.where(valid, y, 0)
    ll = z.gather(1, safe[:, None])[:, 0]
    return z, lse, valid, torch.where(valid, lse - ll, 0.0).sum()


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, y, chunk_rows, cap):
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        count = (y != -100).sum().float()
        for i in range(0, x.shape[0], chunk_rows):
            loss = loss + _chunk_loss(x[i:i + chunk_rows], w,
                                      y[i:i + chunk_rows], cap)[3]
        ctx.save_for_backward(x, w, y)
        ctx.chunk_rows, ctx.cap = chunk_rows, cap
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        x, w, y = ctx.saved_tensors
        cap, rows = ctx.cap, ctx.chunk_rows
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = torch.empty_like(x) if need_x else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) \
            if need_w else None
        for i in range(0, x.shape[0], rows):
            xi, yi = x[i:i + rows], y[i:i + rows]
            z, lse, valid, _ = _chunk_loss(xi, w, yi, cap)
            # d(lse - z[y]) / dz = softmax(z) - onehot(y), valid rows only
            dz = torch.exp(z - lse[:, None])
            dz[torch.arange(len(yi), device=yi.device),
               torch.where(valid, yi, 0)] -= 1.0
            dz *= (valid.float() * g_loss)[:, None]
            if cap > 0.0:
                dz *= 1.0 - (z / cap) ** 2
            dz = dz.to(x.dtype)
            if need_x:
                dx[i:i + rows] = dz @ w.t()
            if need_w:
                dw += (xi.t() @ dz).float()
        return dx, (dw.to(w.dtype) if need_w else None), None, None, None


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    w_head: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk_rows: int = 2048,
    logit_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss_sum, valid_count)`` of next-token CE without full logits.

    hidden ``[batch, seq, H]``; w_head ``[H, V]`` (the JAX layout: pass
    ``lm_head.weight.t()``, a view); labels ``[batch, seq]`` with -100
    ignored.  Equals ``loss_sum_count(hidden @ w_head, labels)``.
    ``logit_softcap`` > 0 applies ``c * tanh(logits / c)`` first."""
    h = hidden.shape[-1]
    x = hidden.reshape(-1, h)
    y = labels.reshape(-1).long()
    return _FusedLinearCE.apply(x, w_head.to(x.dtype), y, int(chunk_rows),
                                float(logit_softcap))
