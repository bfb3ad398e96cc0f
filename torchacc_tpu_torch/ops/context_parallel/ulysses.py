"""Ulysses sequence parallelism: all-to-all on heads over the 'spu'
process group (the port of torchacc_tpu/ops/context_parallel/ulysses.py
``ulysses_attention``, :23).

Before attention an all-to-all scatters the heads and gathers the
sequence, so each rank sees the whole (ring) chunk for ``h / n`` of the
heads; after it the inverse all-to-all brings the sequence split back.
The moves are JAX's tiled ``all_to_all`` (``split_axis=2, concat_axis=1``
and its inverse) on ``all_to_all_single``: head group ``j`` goes to the
group's rank ``j``, and the received sequence chunks are concatenated
in rank order.  The segment ids are all-gathered.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist


def check_heads(hq: int, hk: int, n: int) -> None:
    """The all-to-all splits the head dim ``n`` ways, so the kv heads
    must divide too (JAX :39-43)."""
    if hq % n or hk % n:
        raise ValueError(
            f"ulysses degree {n} must divide both q heads ({hq}) and "
            f"kv heads ({hk})")


def heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[b, s, h, d]`` -> ``[b, n s, h / n, d]``: this rank's head group
    of every rank's sequence chunk."""
    b, s, h, d = x.shape
    send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`heads_to_seq`: ``[b, n s, h / n, d]`` ->
    ``[b, s, h, d]``."""
    b, ns, hn, d = x.shape
    s = ns // n
    send = x.reshape(b, n, s, hn, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s, n * hn, d)


def gather_seq(seg: Optional[torch.Tensor], group,
               n: int) -> Optional[torch.Tensor]:
    """``[b, s]`` segment ids -> ``[b, n s]``, every rank's chunk in rank
    order."""
    if seg is None:
        return None
    parts = [torch.empty_like(seg) for _ in range(n)]
    dist.all_gather(parts, seg.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def ulysses_attention(q, k, v, q_segment_ids, kv_segment_ids, group,
                      n: int, inner: Callable, with_aux: bool = False):
    """q/k/v ``[b, s_loc, h, d]`` -> ``[b, s_loc, h, d]``: ``inner(q, k,
    v, q_segment_ids, kv_segment_ids)`` on the gathered sequence and
    scattered heads, between the two all-to-alls.  ``with_aux``: inner
    returns ``(o, aux)`` and aux comes back beside the output, in the
    inner layout."""
    if n == 1:
        return inner(q, k, v, q_segment_ids, kv_segment_ids)
    check_heads(q.shape[2], k.shape[2], n)
    q_, k_, v_ = (heads_to_seq(t, group, n) for t in (q, k, v))
    res = inner(q_, k_, v_, gather_seq(q_segment_ids, group, n),
                gather_seq(kv_segment_ids, group, n))
    out, aux = res if with_aux else (res, None)
    out = seq_to_heads(out, group, n)
    return (out, aux) if with_aux else out
