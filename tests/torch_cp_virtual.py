"""``cp_attention``'s schedule on ``ring_n`` x ``ul_n`` ranks, run rank
after rank on one device (a helper, never collected): the tests hold it
against JAX's ``cp_attention`` on the CPU, and ``chip_smoke.py`` and the
card tests hold it against one whole kernel call at long context.

Each rank's offsets and ALiBi slopes come from the package's own code: a
:class:`CPLayout` of the rank and ``dispatch._inner_heads``, as
``cp_attention`` computes them on a mesh, and each ring step runs
through ``ring_fwd``/``ring_bwd`` (their step, skip and merge
functions) over a :class:`VirtualRing`.  Only the moves are emulated:
Ulysses rank ``j`` takes head group ``j`` of the whole q/k/v, as the
all-to-all would leave it, and ring rank ``me`` the sequence chunk
``me``.
"""

import torch

from torchacc_tpu_torch.ops.context_parallel import (
    CPLayout,
    VirtualRing,
    ring_bwd,
    ring_fwd,
)
from torchacc_tpu_torch.ops.context_parallel.dispatch import _inner_heads
from torchacc_tpu_torch.ops.context_parallel.ulysses import check_heads


def virtual_cp_attention(q, k, v, do=None, *, ring_n: int, ul_n: int = 1,
                         q_segment_ids=None, kv_segment_ids=None,
                         alibi_slopes=None, causal: bool = True,
                         tp_rank: int = 0, data_pos: int = 0, **kw):
    """The whole ``(o, lse)`` of ``[b, s, h, d]`` q/k/v (this 'tp'
    rank's heads, ``tp_rank``, and data shard, ``data_pos``, with their
    ``[h]`` slopes) and, given ``do``, ``(o, lse, dq, dk, dv)``, dk/dv
    summed into each source chunk's buffer.  ``causal`` and ``kw`` (the
    steps' ``window``, ``scale``, ``logit_softcap``, ``dropout_p``,
    ``dropout_seed``, ``impl``): as ``cp_attention`` takes them."""
    b, s, hq, _ = q.shape
    hk = k.shape[2]
    check_heads(hq, hk, ul_n)
    if s % ring_n:
        raise ValueError(f"sequence {s} is not divisible by ring {ring_n}")
    hqi, hki, w = hq // ul_n, hk // ul_n, s // ring_n
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    grads = None if do is None else (torch.empty_like(q),
                                     torch.empty_like(k),
                                     torch.empty_like(v))
    seg = lambda t, me: None if t is None else \
        t[:, me * w:(me + 1) * w].contiguous()
    for j in range(ul_n):
        lay = CPLayout(ring_n=ring_n, ul_n=ul_n, ul_rank=j, tp_rank=tp_rank,
                       data_pos=data_pos)
        h_off, slopes = _inner_heads(lay, q, alibi_slopes)
        step = dict(kw, causal=causal, h_offset=h_off,
                    b_offset=lay.b_offset(b), alibi_slopes=slopes)
        hs, ks = slice(j * hqi, (j + 1) * hqi), slice(j * hki, (j + 1) * hki)
        ring = VirtualRing(k[:, :, ks], v[:, :, ks], kv_segment_ids, ring_n,
                           grads=do is not None)
        for me in range(ring_n):
            rows = slice(me * w, (me + 1) * w)
            oc, lc = ring_fwd(q[:, rows, hs].contiguous(),
                              seg(q_segment_ids, me), ring.rank(me)[0],
                              me=me, n=ring_n, **step)
            o[:, rows, hs], lse[:, hs, rows] = oc, lc
        if do is None:
            continue
        for me in range(ring_n):
            rows = slice(me * w, (me + 1) * w)
            kv_at, grad_to = ring.rank(me)
            grads[0][:, rows, hs] = ring_bwd(
                q[:, rows, hs].contiguous(), seg(q_segment_ids, me),
                o[:, rows, hs].contiguous(), lse[:, hs, rows].contiguous(),
                do[:, rows, hs].contiguous(), kv_at, grad_to, me=me,
                n=ring_n, **step)
        grads[1][:, :, ks], grads[2][:, :, ks] = ring.dk, ring.dv
    return (o, lse) if do is None else (o, lse) + grads
