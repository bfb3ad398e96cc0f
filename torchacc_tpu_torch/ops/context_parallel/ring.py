"""Ring attention over the 'sp' process group (the port of
torchacc_tpu/ops/context_parallel/ring.py).

Each rank holds one contiguous chunk of the sequence: its queries stay,
and the kv chunks travel around the ring, one hop a step, so that after
``n`` steps every query chunk has met every kv chunk.  A step is one
flash-attention call at GLOBAL offsets (``q_offset = me * s``,
``k_offset = src * s``), so causality, windows, ALiBi and dropout see
the positions of the whole sequence; the partials merge through their
LSE (``merge.py``).  Steps whose band is provably empty are skipped
(``step_should_run``, JAX ``_step_should_run`` :55): ranks, sources and
chunk sizes are host ints here, so the test is made on the host, with
no ``lax.cond`` and no device sync.

The backward (JAX ``ring_attention_bwd`` :157) re-walks the ring from the
saved merged ``(o, lse)``: each step's flash backward against the
global lse is the step's share of the gradient.  dq stays home; dk/dv
accumulators travel with their kv chunk and arrive home after ``n``
hops.

The code is cut in two so that a rank's schedule runs without a process
group: :func:`ring_step_fwd`/:func:`ring_step_bwd` are one step's
attention at ``(me, src)``, and :func:`ring_fwd`/:func:`ring_bwd` the
loop, which asks ``kv_at(i)`` for step ``i``'s kv chunk and hands the
step's dk/dv to ``grad_to(i, grads)``.  :class:`RingTransport` moves
them over a process group (``batch_isend_irecv`` to rank + 1 and from
rank - 1, each rotation posted before the step's kernel, so that the
copy overlaps it); :class:`VirtualRing` indexes the chunks of one
tensor where a rank would receive them, and adds each step's dk/dv into
its source chunk's buffer (``tests/torch_cp_virtual.py`` drives
``cp_attention``'s schedule over n ranks on one device with it, for
``chip_smoke.py`` on the card and the tests on the CPU).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torchacc_tpu_torch.ops._common import NEG_INF
from torchacc_tpu_torch.ops.context_parallel.merge import merge_attention
from torchacc_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)

KV = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def step_should_run(me: int, src: int, s: int, causal: bool,
                    window: Tuple[int, int]) -> bool:
    """False when the band of (q chunk ``me``, kv chunk ``src``), chunks
    of ``s`` rows, is provably empty: the kv chunk lies wholly after the
    queries (causal), or further away than the window reaches."""
    left, right = window
    if causal and src > me:
        return False
    # the kv chunk ends at (src + 1) s - 1; the earliest key in band for
    # the chunk's queries is me * s - left
    if left >= 0 and (src + 1) * s - 1 < me * s - left:
        return False
    if right >= 0 and not causal and src * s > (me + 1) * s - 1 + right:
        return False
    return True


def ring_step_fwd(q, k, v, q_segment_ids, kv_segment_ids, *, me: int,
                  src: int, causal: bool, window=(-1, -1), scale=None,
                  logit_softcap: float = 0.0, alibi_slopes=None,
                  dropout_p: float = 0.0, dropout_seed=None,
                  h_offset: int = 0, b_offset: int = 0, impl: str = "auto"):
    """Rank ``me``'s step against kv chunk ``src``: ``(o, lse)`` of the
    flash forward at the chunks' global offsets, or None when
    :func:`step_should_run` skips it."""
    s = q.shape[1]
    if not step_should_run(me, src, s, causal, window):
        return None
    return flash_attention(
        q, k, v, causal=causal, window=window, scale=scale,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        alibi_slopes=alibi_slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed, q_offset=me * s, k_offset=src * s,
        h_offset=h_offset, b_offset=b_offset, return_lse=True,
        logit_softcap=logit_softcap, impl=impl)


def ring_step_bwd(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids, *,
                  me: int, src: int, causal: bool, window=(-1, -1),
                  scale=None, logit_softcap: float = 0.0, alibi_slopes=None,
                  dropout_p: float = 0.0, dropout_seed=None,
                  h_offset: int = 0, b_offset: int = 0, impl: str = "auto"):
    """Rank ``me``'s backward step against kv chunk ``src`` from the
    merged ``(o, lse)``: ``(dq, dk, dv)``, or None when skipped."""
    s = q.shape[1]
    if not step_should_run(me, src, s, causal, window):
        return None
    return flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal, window=window, scale=scale,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        alibi_slopes=alibi_slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed, q_offset=me * s, k_offset=src * s,
        h_offset=h_offset, b_offset=b_offset,
        logit_softcap=logit_softcap, impl=impl)


def ring_fwd(q, q_segment_ids, kv_at: Callable[[int], KV], *, me: int,
             n: int, **kw):
    """Rank ``me``'s forward over ``n`` steps: ``(out, lse)``, out in
    q's dtype, lse ``[b, h, s]`` f32.  ``kv_at(i)`` gives step ``i``'s
    ``(k, v, kv_segment_ids)``, the chunk of rank ``(me - i) % n``; it
    is called for every step, skipped or not, in order.  ``kw``: the
    step's arguments (:func:`ring_step_fwd`)."""
    out = lse = None
    for i in range(n):
        src = (me - i) % n
        k, v, kseg = kv_at(i)
        res = ring_step_fwd(q, k, v, q_segment_ids, kseg, me=me, src=src,
                            **kw)
        if res is None:
            continue
        o_i, lse_i = res
        if out is None:
            # merging into (0, NEG_INF) is the identity
            out, lse = o_i.float(), lse_i
        else:
            out, lse = merge_attention(out, lse, o_i.float(), lse_i)
    if out is None:
        b, s, h, _ = q.shape
        return torch.zeros_like(q), torch.full(
            (b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    return out.to(q.dtype), lse


def ring_bwd(q, q_segment_ids, o, lse, do, kv_at: Callable[[int], KV],
             grad_to: Callable[[int, Optional[Tuple]], None], *, me: int,
             n: int, **kw):
    """Rank ``me``'s backward over ``n`` steps from the merged ``(o,
    lse)``: returns dq (q's dtype), and hands each step's ``(dk, dv)``
    for kv chunk ``(me - i) % n`` to ``grad_to(i, grads)`` (None for a
    skipped step; called for every step, in order)."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        src = (me - i) % n
        k, v, kseg = kv_at(i)
        res = ring_step_bwd(q, k, v, o, lse, do, q_segment_ids, kseg,
                            me=me, src=src, **kw)
        if res is not None:
            dq += res[0].float()
            res = res[1:]
        grad_to(i, res)
    return dq.to(q.dtype)


class RingTransport:
    """The kv chunks and the dk/dv accumulators of one rank of a ring
    over ``group``: each hop sends to rank + 1 and receives from rank - 1
    in one ``batch_isend_irecv``.

    ``kv_at(i)`` waits for the hop that brings step ``i``'s chunk and,
    before returning it, posts the next hop, so that the copy runs under
    the step's kernel.  ``grad_to(i, grads)`` adds the step's dk/dv into
    the accumulator travelling with chunk ``(me - i) % n`` and sends it
    on; after ``n`` hops :meth:`home_grads` holds this rank's chunk's
    sums."""

    def __init__(self, group, k, v, kv_segment_ids=None,
                 grads: bool = False):
        self.group = group
        self.n = dist.get_world_size(group)
        self.me = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.me + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.me - 1) % self.n)
        self._kv = [t for t in (k, v, kv_segment_ids) if t is not None]
        self._has_seg = kv_segment_ids is not None
        self._kv_pending = None
        self._acc = None
        self._acc_pending = None
        if grads:
            self._acc = [torch.zeros(t.shape, dtype=torch.float32,
                                     device=t.device) for t in (k, v)]

    def _hop(self, tensors: Sequence[torch.Tensor]):
        recv = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self.next, self.group)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, t, self.prev, self.group)
                for t in recv]
        return recv, dist.batch_isend_irecv(ops)

    @staticmethod
    def _wait(pending) -> List[torch.Tensor]:
        recv, reqs = pending
        for r in reqs:
            r.wait()
        return recv

    def kv_at(self, i: int) -> KV:
        if i > 0:
            self._kv = self._wait(self._kv_pending)
            self._kv_pending = None
        if i + 1 < self.n:
            self._kv_pending = self._hop(self._kv)
        k, v = self._kv[0], self._kv[1]
        return k, v, self._kv[2] if self._has_seg else None

    def grad_to(self, i: int, grads) -> None:
        if i > 0:
            self._acc = self._wait(self._acc_pending)
        if grads is not None:
            for acc, g in zip(self._acc, grads):
                acc += g.float()
        self._acc_pending = self._hop(self._acc)

    def home_grads(self) -> List[torch.Tensor]:
        """dk, dv (f32) of this rank's own chunk, after the last hop."""
        self._acc = self._wait(self._acc_pending)
        self._acc_pending = None
        return self._acc


class VirtualRing:
    """``n`` ranks of a ring emulated on one device: chunk ``r`` of the
    whole ``k``/``v``/segment ids (along dim 1) is rank ``r``'s, copied
    once here into a contiguous tensor of its own, as a rank holds it.
    :meth:`rank` gives rank ``me``'s ``kv_at`` (the chunk it would
    receive at each step, indexed where it lies, with no copy) and
    ``grad_to`` (each step's dk/dv added into its source chunk's f32
    buffer, :attr:`dk`/:attr:`dv`)."""

    def __init__(self, k, v, kv_segment_ids, n: int, grads: bool = False):
        self.n = n
        chunks = lambda t: (None if t is None else
                            [c.contiguous() for c in t.chunk(n, dim=1)])
        self.k, self.v, self.seg = (chunks(t) for t in (k, v, kv_segment_ids))
        if grads:
            self.dk = torch.zeros(k.shape, dtype=torch.float32,
                                  device=k.device)
            self.dv = torch.zeros_like(self.dk)

    def _src(self, me: int, i: int) -> int:
        return (me - i) % self.n

    def rank(self, me: int):
        def kv_at(i: int) -> KV:
            src = self._src(me, i)
            return (self.k[src], self.v[src],
                    None if self.seg is None else self.seg[src])

        def grad_to(i: int, grads) -> None:
            if grads is None:
                return
            src = self._src(me, i)
            for buf, g in zip((self.dk, self.dv), grads):
                buf.chunk(self.n, dim=1)[src].add_(g.float())
        return kv_at, grad_to


def ring_attention_fwd(q, k, v, q_segment_ids, kv_segment_ids, *, group,
                       **kw):
    """:func:`ring_fwd` of this rank of ``group``: ``(out, lse)``."""
    ring = RingTransport(group, k, v, kv_segment_ids)
    return ring_fwd(q, q_segment_ids, ring.kv_at, me=ring.me, n=ring.n,
                    **kw)


def ring_attention_bwd(q, k, v, q_segment_ids, kv_segment_ids, o, lse, do,
                       *, group, **kw):
    """:func:`ring_bwd` of this rank of ``group``: ``(dq, dk, dv)`` of
    its own chunks, in the inputs' dtypes."""
    ring = RingTransport(group, k, v, kv_segment_ids, grads=True)
    dq = ring_bwd(q, q_segment_ids, o, lse, do, ring.kv_at, ring.grad_to,
                  me=ring.me, n=ring.n, **kw)
    dk, dv = ring.home_grads()
    return dq, dk.to(k.dtype), dv.to(v.dtype)
