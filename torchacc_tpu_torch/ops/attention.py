"""Dense (plain PyTorch) attention with LSE output, and its backward from
saved (o, lse): the port of torchacc_tpu/ops/attention.py
``attention_reference`` (:99) and ``attention_reference_bwd`` (:179).

These are the plain versions beside the flash-attention kernels
(``ops/flash_attention.py``, ``csrc/flash_attention.cu``): the CPU path
and the tests use them, and ``chip_smoke.py`` holds the kernels against
them on the card.  Nothing on the card's main path calls them.

Conventions as in the JAX package: q/k/v are ``[batch, seq, heads,
head_dim]`` (BSHD); GQA maps q head ``i`` to kv head ``i // group``;
for ``sq != sk`` the geometry is bottom-right aligned (query ``i`` sits
at position ``i + sk - sq``); the window is ``(left, right)`` with -1
unbounded; segment ids ``[batch, seq]`` mask pairs from different
documents; a row that sees no key gives zeros and ``lse = NEG_INF``.
Scores, softmax and both products run in f32; outputs are cast back to
the inputs' dtype.  ALiBi adds ``-slope[h] * |i + (sk - sq) - j|`` after
the scale and the softcap; dropout keeps a pair by the coordinate hash
of ``ops/_common.py`` (bit for bit the JAX package's) and scales the
kept probabilities by ``1 / (1 - p)`` for the P @ V product only, so the
LSE stays that of the undropped softmax.

The context-parallel offsets (host ints, JAX's ``q_offset``,
``k_offset``, ``h_offset`` and ``b_offset``) place the local tensors in
the global ones: the mask and ALiBi see query ``i`` at ``q_offset + i +
(sk - sq)`` and key ``j`` at ``k_offset + j``, and dropout hashes the
global coordinates ``(b_offset + b, h_offset + h, q_offset + i,
k_offset + j)``, so that a ring step or a shard draws the masks of the
whole call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchacc_tpu_torch.ops._common import NEG_INF, dropout_keep


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Broadcast kv heads to q heads (``jnp.repeat`` order)."""
    kh = k.shape[2]
    if kh == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // kh, dim=2)


def make_attention_mask(q_len: int, kv_len: int, causal: bool = True,
                        window: Tuple[int, int] = (-1, -1),
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        q_offset: int = 0,
                        device=None) -> torch.Tensor:
    """Boolean ``[q_len, kv_len]`` (``[b, q_len, kv_len]`` with segment
    ids) mask, True = attend; ``q_offset`` shifts the query positions."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= kv_pos
    left, right = window
    if left >= 0:
        mask &= kv_pos >= q_pos - left
    if right >= 0:
        mask &= kv_pos <= q_pos + right
    if q_segment_ids is not None:
        seg = q_segment_ids[..., :, None] == kv_segment_ids[..., None, :]
        mask = mask & seg
    return mask


def _mask4(q, k, causal, window, q_segment_ids, kv_segment_ids,
           shift=None):
    """The mask of :func:`make_attention_mask` with query ``i`` at ``i +
    shift`` (default ``sk - sq``), as ``[b|1, 1?, q, k]``."""
    sq, sk = q.shape[1], k.shape[1]
    if shift is None:
        shift = sk - sq
    mask = make_attention_mask(sq, sk, causal, window, q_segment_ids,
                               kv_segment_ids, q_offset=shift,
                               device=q.device)
    return mask[:, None] if mask.ndim == 3 else mask     # [b|1, 1?, q, k]


def _scores(q, k, scale, logit_softcap, alibi_slopes=None, shift=None):
    """f32 ``[b, h, q, k]`` scores after the scale, the softcap and the
    ALiBi bias (query ``i`` at ``i + shift``, default ``sk - sq``), and the softcap's chain
    factor ``1 - (s / c)^2`` (1.0 when off), taken before the bias
    lands."""
    kr = _repeat_kv(k, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    dcap = 1.0
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
        dcap = 1.0 - (s / logit_softcap) ** 2
    if alibi_slopes is not None:
        sq, sk = q.shape[1], k.shape[1]
        q_pos = torch.arange(sq, dtype=torch.float32, device=q.device) \
            + (sk - sq if shift is None else shift)
        k_pos = torch.arange(sk, dtype=torch.float32, device=q.device)
        dist = (q_pos[:, None] - k_pos[None, :]).abs()
        s = s + (-alibi_slopes.detach().float()[:, None, None] * dist[None])
    return s, dcap


def _shift(q, k, offsets):
    """Query ``i``'s position less key ``j``'s, at ``i = j = 0``: the
    bottom-right alignment ``sk - sq`` plus ``q_offset - k_offset``."""
    return offsets[0] - offsets[1] + k.shape[1] - q.shape[1]


def _dropped(p, dropout_p, dropout_seed, offsets=(0, 0, 0, 0)):
    """``p [b, h, q, k]`` with dropout applied: kept entries scaled by
    ``1 / (1 - p)``, the rest zero (``p`` itself when dropout is off).
    ``offsets``: ``(q, k, h, b)`` offsets of the hashed coordinates."""
    if dropout_p <= 0.0:
        return p
    b, h, sq, sk = p.shape
    q_off, k_off, h_off, b_off = offsets
    dev = p.device
    keep = dropout_keep(
        0 if dropout_seed is None else dropout_seed,
        torch.arange(b, device=dev)[:, None, None] + b_off,
        torch.arange(h, device=dev)[None, :, None] + h_off,
        torch.arange(sq, device=dev) + q_off,
        torch.arange(sk, device=dev) + k_off, dropout_p)
    return torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_p))


def attention_reference(
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
    q_offset: int = 0,
    k_offset: int = 0,
    h_offset: int = 0,
    b_offset: int = 0,
    return_lse: bool = False,
    logit_softcap: float = 0.0,
):
    """Plain attention.  Returns ``out`` or ``(out, lse [b, h, sq] f32)``."""
    b, sq, hq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    offsets = (q_offset, k_offset, h_offset, b_offset)
    shift = _shift(q, k, offsets)
    s, _ = _scores(q, k, scale, logit_softcap, alibi_slopes, shift)
    mask = _mask4(q, k, causal, window, q_segment_ids, kv_segment_ids,
                  shift)
    s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                       # [b, h, q]
    probs = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    probs = _dropped(probs, dropout_p, dropout_seed, offsets)
    vr = _repeat_kv(v, hq)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr.float()).to(q.dtype)
    if return_lse:
        # a row that sees no key: logsumexp of NEG_INF entries is
        # NEG_INF + log(sk); the flash contract pins it to NEG_INF
        empty = ~mask.any(dim=-1)
        lse = torch.where(empty, NEG_INF, lse)
        return out, lse
    return out


def attention_reference_bwd(
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
    q_offset: int = 0,
    k_offset: int = 0,
    h_offset: int = 0,
    b_offset: int = 0,
    logit_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain flash-style backward from saved ``(o, lse)``: ``(dq, dk,
    dv)``, GQA grads summed over each kv head's group.  With
    ``delta = rowsum(dO * O)`` and ``P~`` the dropout-scaled ``P``:
    ``dS = (P~ * dO V^T - P * delta) * dcap``, ``dV = P~^T dO``."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hk
    offsets = (q_offset, k_offset, h_offset, b_offset)
    shift = _shift(q, k, offsets)
    s, dcap = _scores(q, k, scale, logit_softcap, alibi_slopes, shift)
    mask = _mask4(q, k, causal, window, q_segment_ids, kv_segment_ids,
                  shift)
    p = torch.where(mask, torch.exp(s - lse[..., None].float()), 0.0)
    p_tilde = _dropped(p, dropout_p, dropout_seed, offsets)
    kr = _repeat_kv(k, hq).float()
    vr = _repeat_kv(v, hq).float()
    qf, dof = q.float(), do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = (p_tilde * dp - p * delta[..., None]) * dcap * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_tilde, dof)
    if group > 1:
        dk = dk.reshape(b, sk, hk, group, d).sum(dim=3)
        dv = dv.reshape(b, sk, hk, group, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
