"""``cp_attention``: the context-parallel attention front door (the port
of torchacc_tpu/ops/context_parallel/dispatch.py ``cp_attention``, :63).

It composes Ulysses (inner, the 'spu' process group, all-to-all) with
the ring (outer, the 'sp' group, P2P): the 2D composition of the
reference's FlashSequence.  It degenerates by itself: 'spu' of 1 is a
pure ring, 'sp' of 1 pure Ulysses, and both 1 plain attention.  The
sequence of ``[b, s, h, d]`` is split in contiguous chunks in the order
``('sp', 'spu')`` (JAX's ``seq`` spec), so rank ``(sp_idx, spu_idx)``
holds chunk ``sp_idx * ul_n + spu_idx``, and after the all-to-all the
ring's chunk ``sp_idx`` covers ``ul_n`` of them, at ``q_offset = sp_idx
* s_inner``.

Every flash call gets its GLOBAL offsets (JAX ``_offsets`` :125-150): the
batch offset from this rank's position over the data axes times the
local batch, the head offset from the 'tp' rank times the local heads
plus the 'spu' index times the heads after the all-to-all, and the
ALiBi slopes of those heads.  So windows, ALiBi and dropout see the
whole call's coordinates, and a run on a mesh draws the dropout masks
of the one-device run.

The forward is one ``torch.library`` custom op (``cp_fwd``), whose
outputs are the output and the inner-layout ``(o, lse)``; its autograd
formula redoes only the all-to-all moves and runs the explicit
ring/flash backward from the saved ``(o, lse)`` (JAX ``core_fwd`` /
``core_bwd`` :259-282).  The selective-checkpoint policies
(``utils/remat.py``) see the op whole, so under ``save_attn*`` its
outputs are kept (JAX's ``attn_ctx``/``attn_lse`` names) and a
recompute never walks the ring again.  The process groups cannot ride
the op's schema, so the op takes the key of a registered
:class:`CPLayout`.
"""

from __future__ import annotations

import itertools
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from torchacc_tpu_torch.ops.attn import attention
from torchacc_tpu_torch.ops.context_parallel.ring import (
    ring_attention_bwd,
    ring_attention_fwd,
)
from torchacc_tpu_torch.ops.context_parallel.ulysses import (
    check_heads,
    gather_seq,
    heads_to_seq,
    seq_to_heads,
    ulysses_attention,
)
from torchacc_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)

_keys = itertools.count()
# the layouts the custom op can name, alive while their owner (a model's
# attention layers, a mesh) keeps them
_LAYOUTS = weakref.WeakValueDictionary()


@dataclass(eq=False)
class CPLayout:
    """This rank's place on a mesh, as attention needs it: the ring
    ('sp') and Ulysses ('spu') process groups with their sizes and this
    rank's index in each, its position over the data axes and its 'tp'
    rank.  :meth:`from_mesh` reads it off a ``DeviceMesh``."""
    ring_group: Any = None
    ring_n: int = 1
    ring_rank: int = 0
    ul_group: Any = None
    ul_n: int = 1
    ul_rank: int = 0
    data_pos: int = 0
    tp_rank: int = 0
    key: int = field(default_factory=lambda: next(_keys))

    def __post_init__(self):
        _LAYOUTS[self.key] = self

    @classmethod
    def from_mesh(cls, mesh: DeviceMesh, ring_axis: str = "sp",
                  a2a_axis: str = "spu",
                  data_axes: Tuple[str, ...] = ("dp", "fsdp"),
                  tp_axis: str = "tp") -> "CPLayout":
        names = mesh.mesh_dim_names
        sizes = dict(zip(names, mesh.mesh.shape))

        def idx(ax):
            return mesh.get_local_rank(ax) if sizes.get(ax, 1) > 1 else 0

        def group(ax):
            return mesh.get_group(ax) if sizes.get(ax, 1) > 1 else None
        data_pos = 0
        for ax in data_axes:
            data_pos = data_pos * sizes.get(ax, 1) + idx(ax)
        return cls(ring_group=group(ring_axis),
                   ring_n=sizes.get(ring_axis, 1), ring_rank=idx(ring_axis),
                   ul_group=group(a2a_axis), ul_n=sizes.get(a2a_axis, 1),
                   ul_rank=idx(a2a_axis), data_pos=data_pos,
                   tp_rank=idx(tp_axis))

    @property
    def seq_n(self) -> int:
        """The sequence ranks: chunks of the sequence."""
        return self.ring_n * self.ul_n

    @property
    def seq_index(self) -> int:
        """This rank's chunk of the sequence (order ('sp', 'spu'))."""
        return self.ring_rank * self.ul_n + self.ul_rank

    def b_offset(self, b_local: int) -> int:
        """The global batch row of local row 0."""
        return self.data_pos * b_local

    def h_offset(self, h_local: int) -> int:
        """The global q head of local head 0, before the all-to-all."""
        return self.tp_rank * h_local


def _layout(mesh, ring_axis, a2a_axis, data_axes, tp_axis):
    """The :class:`CPLayout` of ``mesh`` (kept on the mesh, one per set
    of axis names)."""
    if mesh is None or isinstance(mesh, CPLayout):
        return mesh
    cache = mesh.__dict__.setdefault("_cp_layouts", {})
    key = (ring_axis, a2a_axis, tuple(data_axes), tp_axis)
    if key not in cache:
        cache[key] = CPLayout.from_mesh(mesh, *key)
    return cache[key]


def _inner_heads(lay: CPLayout, q, alibi):
    """(h_offset, slopes) of the heads after the all-to-all."""
    h_inner = q.shape[2] // lay.ul_n
    h_off = lay.h_offset(q.shape[2]) + lay.ul_rank * h_inner
    slopes = alibi
    if alibi is not None and lay.ul_n > 1:
        slopes = alibi[lay.ul_rank * h_inner:(lay.ul_rank + 1) * h_inner]
    return h_off, slopes


def _step_kw(params, h_off, b_off, slopes):
    causal, wl, wr, scale, softcap, dropout_p, seed, impl = params
    return dict(causal=causal, window=(wl, wr), scale=scale,
                logit_softcap=softcap, alibi_slopes=slopes,
                dropout_p=dropout_p, dropout_seed=seed, h_offset=h_off,
                b_offset=b_off, impl=impl)


@torch.library.custom_op("torchacc_tpu_torch::cp_fwd", mutates_args=())
def _cp_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_segment_ids: Optional[torch.Tensor],
               kv_segment_ids: Optional[torch.Tensor],
               alibi_slopes: Optional[torch.Tensor], layout: int,
               causal: bool, window_left: int, window_right: int,
               scale: float, logit_softcap: float, dropout_p: float,
               dropout_seed: int, impl: str
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, o_inner, lse): o_inner is empty without Ulysses (it is out
    itself then, and an op's outputs may not alias)."""
    lay = _LAYOUTS[layout]
    params = (causal, window_left, window_right, scale, logit_softcap,
              dropout_p, dropout_seed, impl)
    b_off = lay.b_offset(q.shape[0])
    h_off, slopes = _inner_heads(lay, q, alibi_slopes)
    kw = _step_kw(params, h_off, b_off, slopes)

    def local_attn(q_, k_, v_, qs_, ks_):
        if lay.ring_n > 1:
            o, lse = ring_attention_fwd(q_, k_, v_, qs_, ks_,
                                        group=lay.ring_group, **kw)
        else:
            o, lse = flash_attention(
                q_, k_, v_, q_segment_ids=qs_, kv_segment_ids=ks_,
                return_lse=True, **kw)
        return o, (o, lse)

    out, (o_in, lse) = ulysses_attention(
        q, k, v, q_segment_ids, kv_segment_ids, lay.ul_group, lay.ul_n,
        inner=local_attn, with_aux=True)
    if lay.ul_n == 1:
        o_in = out.new_empty((0,))
    return out, o_in, lse.contiguous()


def _setup_context(ctx, inputs, output):
    q, k, v, qseg, kseg, alibi = inputs[:6]
    out, o_in, lse = output
    ctx.save_for_backward(q, k, v, out if o_in.numel() == 0 else o_in, lse,
                          qseg, kseg, alibi)
    ctx.layout = inputs[6]
    ctx.params = inputs[7:]
    ctx.mark_non_differentiable(o_in, lse)


def _backward(ctx, dout, _do_in, _dlse):
    q, k, v, o_in, lse, qseg, kseg, alibi = ctx.saved_tensors
    lay = _LAYOUTS[ctx.layout]
    n = lay.ul_n
    dout = dout.contiguous()
    if n > 1:
        q_, k_, v_, do_ = (heads_to_seq(t, lay.ul_group, n)
                           for t in (q, k, v, dout))
        qs_ = gather_seq(qseg, lay.ul_group, n)
        ks_ = gather_seq(kseg, lay.ul_group, n)
    else:
        q_, k_, v_, do_, qs_, ks_ = q, k, v, dout, qseg, kseg
    h_off, slopes = _inner_heads(lay, q, alibi)
    kw = _step_kw(ctx.params, h_off, lay.b_offset(q.shape[0]), slopes)
    if lay.ring_n > 1:
        dq, dk, dv = ring_attention_bwd(q_, k_, v_, qs_, ks_, o_in, lse, do_,
                                        group=lay.ring_group, **kw)
    else:
        dq, dk, dv = flash_attention_bwd(q_, k_, v_, o_in, lse, do_,
                                         q_segment_ids=qs_,
                                         kv_segment_ids=ks_, **kw)
    if n > 1:
        dq, dk, dv = (seq_to_heads(t, lay.ul_group, n) for t in (dq, dk, dv))
    return (dq, dk, dv) + (None,) * 12


_cp_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def cp_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Tuple[int, int] = (-1, -1),
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    mesh=None,
    ring_axis: str = "sp",
    a2a_axis: str = "spu",
    data_axes: Tuple[str, ...] = ("dp", "fsdp"),
    tp_axis: str = "tp",
    impl: str = "auto",
):
    """``[b, s, h, d]`` attention of this rank's shard: the batch over
    ``data_axes``, the sequence over ``(ring_axis, a2a_axis)`` in
    contiguous chunks, the heads over ``tp_axis``.  ``mesh``: a
    ``DeviceMesh`` with those axis names, or a :class:`CPLayout`; None
    (or both sequence axes of extent 1) is plain ``attention``, at this
    rank's batch and head offsets.  ``alibi_slopes``: this rank's
    ``[h]`` slopes.  Differentiable in q, k and v."""
    lay = _layout(mesh, ring_axis, a2a_axis, data_axes, tp_axis)
    if lay is None or lay.seq_n == 1:
        b_off = 0 if lay is None else lay.b_offset(q.shape[0])
        h_off = 0 if lay is None else lay.h_offset(q.shape[2])
        return attention(q, k, v, causal=causal, window=window, scale=scale,
                         logit_softcap=logit_softcap,
                         q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids,
                         alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                         dropout_seed=dropout_seed, b_offset=b_off,
                         h_offset=h_off, impl=impl)
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be provided together")
    check_heads(q.shape[2], k.shape[2], lay.ul_n)
    if dropout_seed is not None and not isinstance(dropout_seed, int):
        raise TypeError("dropout_seed must be a host int")
    segs = [None if s is None else s.to(torch.int32).contiguous()
            for s in (q_segment_ids, kv_segment_ids)]
    if alibi_slopes is not None:
        alibi_slopes = alibi_slopes.detach().to(torch.float32).contiguous()
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, _, _ = _cp_fwd_op(
        q.contiguous(), k.contiguous(), v.contiguous(), *segs, alibi_slopes,
        lay.key, bool(causal), int(window[0]), int(window[1]), float(scale),
        float(logit_softcap), float(dropout_p),
        0 if dropout_seed is None else int(dropout_seed), impl)
    return out

