"""Fused linear + cross entropy (the port of torchacc_tpu/ops/fused.py
``fused_linear_cross_entropy``, :40, and its vocab-parallel form
``fused_linear_cross_entropy_tp``, :140).

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

from typing import Any, Tuple

import torch
import torch.distributed as dist


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


def _all_reduce(t: torch.Tensor, op, group) -> None:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)


class _FusedLinearCE(torch.autograd.Function):
    """The chunk loop.  With ``group`` (the 'tp' process group) this rank
    holds columns ``[off, off + V/tp)`` of the head: per chunk, the row
    max is all-reduced (MAX) over ``group``, then the sum of ``exp(z -
    max)`` and the label's logit (on the rank that holds it, 0
    elsewhere) in one all-reduce (SUM), as in the JAX package; without
    one (offset 0) the reductions are skipped.  The forward keeps each
    row's lse, so the backward recomputes the chunk's logits only, and
    under ``group`` needs one all-reduce: ``d(hidden)``'s partial sums
    over the ranks, in f32 (the JAX version crosses its ``shard_map`` in
    f32).  ``dW`` stays this rank's slice."""

    @staticmethod
    def forward(ctx, x, w, y, chunk_rows, cap, group):
        vloc = w.shape[1]
        off = 0 if group is None else dist.get_rank(group) * vloc
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        count = (y != -100).sum().float()
        lses = []
        for i in range(0, x.shape[0], chunk_rows):
            yi = y[i:i + chunk_rows]
            z = _softcap(_logits_f32(x[i:i + chunk_rows], w), cap)
            m = z.amax(dim=-1)
            _all_reduce(m, dist.ReduceOp.MAX, group)
            mine = (yi >= off) & (yi < off + vloc)
            ll = z.gather(1, torch.clamp(yi - off, 0, vloc - 1)[:, None])[:, 0]
            stats = torch.stack([torch.exp(z - m[:, None]).sum(dim=-1),
                                 torch.where(mine, ll, 0.0)])
            _all_reduce(stats, dist.ReduceOp.SUM, group)
            lse = m + torch.log(stats[0])
            lses.append(lse)
            loss = loss + torch.where(yi != -100, lse - stats[1], 0.0).sum()
        ctx.save_for_backward(x, w, y, torch.cat(lses))
        ctx.chunk_rows, ctx.cap, ctx.group, ctx.off = (chunk_rows, cap,
                                                       group, off)
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        x, w, y, lse = ctx.saved_tensors
        cap, rows, off, group = ctx.cap, ctx.chunk_rows, ctx.off, ctx.group
        need_x, need_w = ctx.needs_input_grad[:2]
        vloc = w.shape[1]
        dx = torch.empty(x.shape, dtype=x.dtype if group is None
                         else torch.float32, device=x.device) \
            if need_x else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) \
            if need_w else None
        for i in range(0, x.shape[0], rows):
            xi, yi = x[i:i + rows], y[i:i + rows]
            z = _softcap(_logits_f32(xi, w), cap)
            # d(lse - z[y]) / dz = softmax(z) - onehot(y), valid rows only
            dz = torch.exp(z - lse[i:i + rows, None])
            mine = (yi >= off) & (yi < off + vloc)
            dz[torch.arange(len(yi), device=yi.device),
               torch.clamp(yi - off, 0, vloc - 1)] -= mine.float()
            dz *= ((yi != -100).float() * g_loss)[:, None]
            if cap > 0.0:
                dz *= 1.0 - (z / cap) ** 2
            dz = dz.to(x.dtype)
            if need_x:
                dx[i:i + rows] = dz @ w.t()
            if need_w:
                dw += (xi.t() @ dz).float()
        if need_x and group is not None:
            dist.all_reduce(dx, group=group)
        return (dx.to(x.dtype) if need_x else None,
                dw.to(w.dtype) if need_w else None, None, None, None, None)


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
                                float(logit_softcap), None)


def fused_linear_cross_entropy_tp(
    hidden: torch.Tensor,
    w_head: torch.Tensor,
    labels: torch.Tensor,
    *,
    group: Any,
    chunk_rows: int = 2048,
    logit_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocab-parallel ``(loss_sum, valid_count)``: every rank of the
    process group ``group`` (the 'tp' axis) holds the same ``hidden
    [batch, seq, H]`` and labels and its own ``[H, V/tp]`` slice of the
    head (a local tensor: ``lm_head.weight``'s shard, transposed), rank r
    the vocab ids ``[r V/tp, (r + 1) V/tp)``.  Every rank returns the
    whole loss; ``d(hidden)`` comes back summed over the ranks and the
    head's gradient as this rank's slice.  ``logit_softcap`` as in
    :func:`fused_linear_cross_entropy`."""
    h = hidden.shape[-1]
    x = hidden.reshape(-1, h)
    y = labels.reshape(-1).long()
    return _FusedLinearCE.apply(x, w_head.to(x.dtype), y, int(chunk_rows),
                                float(logit_softcap), group)
