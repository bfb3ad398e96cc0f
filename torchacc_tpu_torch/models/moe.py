"""The mixture-of-experts MLP (the port of torchacc_tpu/models/moe.py:
``_sort_dispatch`` :19 and ``MoEMlp`` :60).

``MoEMlp`` is JAX's top-k token-choice MoE:

- the router, an f32 ``Dense(e)`` over ``x`` in f32 (:89-92), on
  whatever weights the step reads (the bf16 shadow's cast up, as JAX's
  f32 ``Dense`` casts its kernel), so that the top-k choice is JAX's;
  top-k then takes a softmax over the selected logits
  (``moe_renorm_topk``, Mixtral, :93-97) or the full softmax's selected
  probabilities (Qwen3-MoE's ``norm_topk_prob`` false, :98-103);
- the experts, SwiGLU FFNs whose products are plain batched matmuls in
  the compute dtype (JAX's einsums, which no Pallas kernel computes and
  ``compute.quant`` leaves alone);
- dense dispatch (``moe_capacity_factor`` None): every token through
  every expert, combined in f32 with the top-k weights (:117-126);
- capacity dispatch: ``cap = ceil(cf * k * n / e)`` slots an expert over
  the call's global token count ``n`` (:132), filled in JAX's
  slot-major priority (every token's top-1 claim before any top-2
  claim, :146-160); claims past ``cap`` are dropped;
- the load-balancing loss ``e * sum(frac_tokens * frac_probs)``, each a
  mean over the global tokens (:182-191), returned beside the output
  (JAX sows it), never appended to a list a remat recompute would add
  to twice.

Capacity dispatch has one mechanism for both ``moe_dispatch`` values:
the slot positions by a stable sort (``slot_positions``, JAX's
``_sort_dispatch`` order), the tokens gathered into the ``[e, cap, h]``
expert buffer (:func:`sort_dispatch`), and the combine un-permuted into
``[k, n, h]`` and summed over k (:func:`sort_combine`), so that no
scatter-add is needed and the sum is repeatable.  JAX's one-hot
``einsum`` path computes the same routing; ``moe_dispatch`` is
validated as JAX's is (:83-88) and ``dispatch_mechanism`` names what
JAX's ``auto`` would pick (PARITY.md).

On a mesh (``parallel/sharding.py``) the experts lie on 'ep' and their
ffn dim on 'tp'.  The batch splits over the data (and sequence) axes
only, so every rank of one 'ep' x 'tp' group holds the same tokens:
each computes its own experts' (and ffn columns') share on all of them,
and the shares are summed over the group (Megatron's pair over 'ep' x
'tp': the input's gradient and the combine weights' are summed there
too).  No tokens are exchanged.  Where the tokens are split over ranks
(``row_groups``, ``seq_group``) the cap, the positions and the aux
means cover the global batch, as JAX's do: the routing choices are
all-gathered for the positions, and the aux sums all-reduced (the
probabilities' sum with its gradient).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    _TPSumBoth,
    _tp_in,
    _tp_out,
)
from torchacc_tpu_torch.ops._common import to_local

DISPATCHES = ("auto", "einsum", "sort")
# JAX's 'auto' switches to the sort path above this many [n, e, cap]
# elements (:136-142)
SORT_ABOVE = 1 << 24


def check_dispatch(cfg: ModelConfig) -> None:
    """``moe_dispatch`` must be one of JAX's values (its message)."""
    if cfg.moe_dispatch not in DISPATCHES:
        raise ValueError(
            f"moe_dispatch must be 'auto' | 'einsum' | 'sort', "
            f"got {cfg.moe_dispatch!r}")


def capacity(cfg: ModelConfig, n: int) -> int:
    """Slots an expert for ``n`` tokens (JAX :132)."""
    return max(math.ceil(cfg.moe_capacity_factor * cfg.num_experts_per_tok
                         * n / cfg.num_experts), 1)


def dispatch_mechanism(cfg: ModelConfig, n: int, cap: int) -> str:
    """The capacity mechanism JAX runs for ``n`` tokens and ``cap``: the
    configured one, or under 'auto' sort above ``n * e * cap > 2^24``.
    Both give the same routing; the port runs one (module docstring)."""
    if cfg.moe_dispatch != "auto":
        return cfg.moe_dispatch
    return "sort" if n * cfg.num_experts * cap > SORT_ABOVE else "einsum"


def route(cfg: ModelConfig, logits: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(weights [n, k] f32, experts [n, k] int64)`` of the router's
    f32 ``logits [n, e]``: a softmax over the top-k logits
    (``moe_renorm_topk``), or the top-k of the full softmax."""
    k = cfg.num_experts_per_tok
    if cfg.moe_renorm_topk:
        top, sel = logits.topk(k, dim=-1)
        return torch.softmax(top, dim=-1), sel
    return torch.softmax(logits, dim=-1).topk(k, dim=-1)


def slot_positions(sel: torch.Tensor, num_experts: int) -> torch.Tensor:
    """``[n, k]``: each claim's place in its expert's buffer, in JAX's
    slot-major priority (``_sort_dispatch`` :40-49): the claims
    flattened slot by slot, a stable sort by expert, the place an
    index less its expert's start."""
    n, k = sel.shape
    sm = sel.t().reshape(-1)
    order = torch.argsort(sm, stable=True)
    counts = torch.bincount(sm, minlength=num_experts)
    starts = counts.cumsum(0) - counts
    pos = torch.empty_like(sm)
    pos[order] = torch.arange(n * k, device=sel.device) - starts[sm[order]]
    return pos.view(k, n).t()


def sort_dispatch(xf: torch.Tensor, sel: torch.Tensor, w: torch.Tensor,
                  pos: torch.Tensor, cap: int, lo: int, local: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The capacity dispatch of ``xf [n, h]`` to experts ``lo .. lo +
    local`` (0 and e on one device): the claims ``sel``/``w``/``pos``
    ``[n, k]`` that fall on them and within ``cap`` fill the expert
    buffer.  Returns ``(ex_in [local, cap, h]`` (empty slots zero),
    ``dest [k, n]`` (each claim's row of the flat ``[local * cap + 1,
    h]`` buffer; the last row, zero, takes the dropped and the other
    ranks' claims), ``w_keep [k, n]`` f32 (zero there)).  The buffer is
    a gather of ``xf``, so its gradient flows to ``xf``; the routing is
    not differentiated."""
    n, h = xf.shape
    k = sel.shape[1]
    mine = (sel >= lo) & (sel < lo + local) & (pos < cap)
    empty = local * cap
    dest = torch.where(mine, (sel - lo) * cap + pos, empty).t()
    w_keep = torch.where(mine, w, 0.0).t().float()
    slot_tok = torch.full((empty + 1,), n, dtype=torch.long,
                          device=xf.device)
    slot_tok[dest.reshape(-1)] = torch.arange(
        n, device=xf.device).repeat(k)
    xpad = torch.cat([xf, xf.new_zeros(1, h)])
    return xpad[slot_tok[:empty]].view(local, cap, h), dest, w_keep


def sort_combine(out: torch.Tensor, dest: torch.Tensor,
                 w_keep: torch.Tensor) -> torch.Tensor:
    """``[n, h]`` f32: each token's claims' expert outputs ``out [local,
    cap, h]`` times their weights, un-permuted into ``[k, n, h]`` and
    summed over k."""
    h = out.shape[-1]
    flat = torch.cat([out.reshape(-1, h).float(),
                      out.new_zeros(1, h, dtype=torch.float32)])
    return (flat[dest] * w_keep[..., None]).sum(0)


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class Experts(nn.Module):
    """The experts' stacked weights in ``nn.Linear``'s ``[out, in]``
    per expert: ``gate``/``up`` ``[e, f, h]`` and ``down`` ``[e, h,
    f]`` (JAX's ``experts/{gate,up}`` ``[e, h, f]`` and
    ``experts/down`` ``[e, f, h]``, each expert transposed, HF's
    per-expert layout stacked).  On a mesh they are this rank's experts
    and ffn columns."""

    def __init__(self, e: int, h: int, f: int, **factory):
        super().__init__()
        self.gate = nn.Parameter(torch.empty((e, f, h), **factory))
        self.up = nn.Parameter(torch.empty((e, f, h), **factory))
        self.down = nn.Parameter(torch.empty((e, h, f), **factory))


class MoEMlp(nn.Module):
    """The MoE block MLP (module docstring): ``router`` (``[e, h]``) and
    ``experts``.  ``forward(x)`` returns ``(y, aux)``: ``y`` in the
    compute dtype and the f32 load-balancing loss of this call."""

    # the 'ep' x 'tp' group over which the experts' shares are summed
    # (None on one device), the index of this rank's first expert, the
    # process groups over which the tokens are split: the data axes'
    # (major first) and the sequence ranks' (parallel/sharding.py)
    expert_group = None
    expert_offset = 0
    row_groups: Sequence = ()
    seq_group = None

    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        e, h, f = cfg.num_experts, cfg.hidden_size, cfg.ffn_size
        self.router = nn.Linear(h, e, bias=False, **factory)
        self.experts = Experts(e, h, f, **factory)

    def _token_groups(self):
        return tuple(self.row_groups) + (
            () if self.seq_group is None else (self.seq_group,))

    def _global_claims(self, sel: torch.Tensor, b: int, s: int
                       ) -> Tuple[torch.Tensor, int, int]:
        """``(sel of the global batch [B, S, k], this rank's first row,
        first column)``: the rows' claims gathered over the sequence
        ranks (along the sequence) and the data ranks (minor first,
        along the batch), JAX's global ``(b, s)`` order."""
        k = sel.shape[-1]
        t = sel.view(b, s, k)
        col = 0
        if self.seq_group is not None:
            t = _all_gather(t, self.seq_group, 1)
            col = dist.get_rank(self.seq_group) * s
        shard = 0
        for g in self.row_groups:
            shard = shard * dist.get_world_size(g) + dist.get_rank(g)
        for g in reversed(tuple(self.row_groups)):
            t = _all_gather(t, g, 0)
        return t, shard * b, col

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        check_dispatch(cfg)
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        b, s, h = x.shape
        n = b * s
        dt = cfg.dtype
        group = self.expert_group
        groups = self._token_groups()
        n_glob = n
        for g in groups:
            n_glob *= dist.get_world_size(g)
        logits = F.linear(x.reshape(n, h).float(),
                          to_local(self.router.weight).float())
        weights, sel = route(cfg, logits)
        # the combine weights' gradient is a share per rank: summed over
        # the group, as the experts' input's is
        wc = _tp_in(weights, group)
        xd = _tp_in(x.reshape(n, h).to(dt), group)
        wg, wu, wd = (to_local(p).to(dt) for p in (
            self.experts.gate, self.experts.up, self.experts.down))
        lo, local = self.expert_offset, wg.shape[0]
        if cfg.moe_capacity_factor is None:
            combine = torch.zeros((n, e), dtype=torch.float32,
                                  device=x.device).scatter(1, sel, wc)
            gate = torch.matmul(xd, wg.transpose(1, 2))      # [el, n, f]
            up = torch.matmul(xd, wu.transpose(1, 2))
            out = torch.matmul(F.silu(gate) * up, wd.transpose(1, 2))
            y = torch.einsum("enh,ne->nh", out.float(),
                             combine[:, lo:lo + local])
        else:
            cap = capacity(cfg, n_glob)
            if groups:
                # the global batch's positions, this rank's tokens kept
                sel_g, r0, c0 = self._global_claims(sel, b, s)
                pos = slot_positions(sel_g.reshape(-1, k), e).reshape(
                    sel_g.shape)[r0:r0 + b, c0:c0 + s].reshape(n, k)
            else:
                pos = slot_positions(sel, e)
            ex_in, dest, w_keep = sort_dispatch(xd, sel, wc, pos, cap, lo,
                                                local)
            gate = torch.bmm(ex_in, wg.transpose(1, 2))      # [el, cap, f]
            up = torch.bmm(ex_in, wu.transpose(1, 2))
            out = torch.bmm(F.silu(gate) * up, wd.transpose(1, 2))
            y = sort_combine(out, dest, w_keep)
        y = _tp_out(y, group)
        return y.to(dt).view(b, s, h), self._aux(logits, sel, n_glob,
                                                 groups)

    def _aux(self, logits: torch.Tensor, sel: torch.Tensor, n_glob: int,
             groups) -> torch.Tensor:
        """JAX's load-balancing loss (:182-191) over the global tokens:
        the claims' counts and the probabilities' sums all-reduced over
        the ranks that split the tokens (the probabilities' with their
        gradient), then divided by the global count."""
        e, k = self.cfg.num_experts, self.cfg.num_experts_per_tok
        counts = torch.bincount(sel.reshape(-1), minlength=e).float()
        psum = torch.softmax(logits, dim=-1).sum(0)
        for g in groups:
            dist.all_reduce(counts, group=g)
            psum = _TPSumBoth.apply(psum, g)
        frac_tokens = counts / n_glob / k
        frac_probs = psum / n_glob
        return e * torch.sum(frac_tokens * frac_probs)
