"""Mixed precision (the port of torchacc_tpu/train/amp.py): the fp16
dynamic loss scaler (``scaler_init`` :23, ``all_finite`` :33,
``scaler_update`` :38) and bf16 compute over f32
master weights (``shadow_cast`` :70, ``bf16_param_shadow`` :81,
``shadow_params`` :134, ``global_norm_f32`` :139).

On a mesh the gradients are sharded ``DTensor``s.  ``global_norm_f32``
then sums the squares of the local shards, each distinct shard on one
rank only (a shard replicated over 'dp' or 'tp' is counted once), and
all-reduces that one sum over every rank; under context parallelism the
sequence ranks hold the same all-reduced gradients outside the
DTensors' meshes, and only the first chunk's rank counts them (its
``counted`` argument, which the Trainer passes down through the
optimizer's ``update_(norm_counted=...)``).
``all_finite`` all-reduces its flag (MIN), so that no rank applies an
fp16 update another skips.
The bf16 shadow is not used on a mesh: FSDP2's mixed-precision policy
gives the blocks the same bf16 reads of the masters
(``parallel/sharding.py`` ``mixed_precision``).

The scaler lives on the device: its state is two 0-dim tensors, the
finite check is a device tensor and ``scaler_update`` is made of
``torch.where``s (torch GradScaler's semantics: growth 2x every
``growth_interval`` good steps, 0.5x backoff on overflow).  JAX's
``select_tree`` has no counterpart: the skipped step's select is made
per tensor inside ``schedules.AdamW.update_(keep=...)``, which also
says where the host reads the flag.

For the bf16 shadow, the optimizer state carries a bf16 copy of the f32 masters.  The
forward and backward read the copy, so gradients arrive in bf16; the
wrapped optimizer applies them to the masters and then refreshes the
copy as the bf16 cast of the masters.  Invariant: after every step,
``shadow == shadow_cast(masters)``.  In the port the shadow tensors are
the model's own parameters (``Trainer`` swaps them in), refreshed in
place.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from torchacc_tpu_torch.ops._common import to_local


def scaler_init(init_scale: float = 2.0 ** 15,
                device=None) -> Dict[str, torch.Tensor]:
    """Dynamic-loss-scale state: ``scale`` (f32) and ``growth_count``
    (int32), 0-dim tensors on ``device``."""
    return {"scale": torch.tensor(init_scale, dtype=torch.float32,
                                  device=device),
            "growth_count": torch.zeros((), dtype=torch.int32,
                                        device=device)}


def _sharded(tensors: List[torch.Tensor]) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def _counted_once(t: DTensor) -> bool:
    """Whether this rank's shard of ``t`` is the copy a reduction over
    every rank counts: its coordinate is 0 along each mesh dim ``t`` is
    replicated over."""
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, t.placements)
               if pl.is_replicate())


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-dim bool tensor: every element of every tensor is finite (of
    every rank's shards, for DTensors)."""
    tensors = list(tensors)
    ok = torch.stack([torch.isfinite(to_local(t)).all()
                      for t in tensors]).all()
    if not _sharded(tensors):
        return ok
    flag = ok.to(torch.float32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return flag > 0.0


def scaler_update(scaler: Dict[str, torch.Tensor], grads_finite,
                  *, growth_factor: float = 2.0, backoff_factor: float = 0.5,
                  growth_interval: int = 2000, max_scale: float = 2.0 ** 24,
                  min_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The next scaler state: on a finite step the count grows, and at
    ``growth_interval`` the scale doubles (to ``max_scale``) and the
    count resets; on overflow the scale halves (to ``min_scale``) and
    the count resets."""
    finite = torch.as_tensor(grads_finite, device=scaler["scale"].device)
    scale = scaler["scale"]
    count = scaler["growth_count"] + 1
    grow = finite & (count >= growth_interval)
    new_scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(scale * growth_factor, max=max_scale),
                    scale),
        torch.clamp(scale * backoff_factor, min=min_scale))
    new_count = torch.where(grow | ~finite, torch.zeros_like(count), count)
    return {"scale": new_scale, "growth_count": new_count}


def shadow_cast(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The one shadow cast policy: floating tensors to bf16, the rest
    as they are."""
    return {n: p.to(torch.bfloat16) if p.is_floating_point() else p
            for n, p in params.items()}


def global_norm_f32(tensors, counted: bool = True) -> torch.Tensor:
    """Global l2 norm with f32 accumulation whatever the leaf dtype (a
    0-dim tensor on the leaves' device; no host sync): a bf16 gradient
    tree would otherwise accumulate its norm in bf16.  Of DTensors: one
    all-reduce of the local sums of squares (module docstring), to which
    this rank adds nothing where ``counted`` is false (its gradients are
    a copy of another rank's beyond their DTensor placements: a
    sequence rank but the first).  ``counted`` may also be one flag a
    tensor: under pipeline parallelism the parameters every stage holds
    count on the first stage only."""
    tensors = list(tensors)
    if not _sharded(tensors):
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    flags = (list(counted) if isinstance(counted, (list, tuple))
             else [counted] * len(tensors))
    sq = torch.zeros((), dtype=torch.float32,
                     device=tensors[0].to_local().device)
    for t, c in zip(tensors, flags):
        if c and _counted_once(t):
            sq = sq + t.to_local().float().square().sum()
    dist.all_reduce(sq)
    return torch.sqrt(sq)


class _Shadowed:
    """``bf16_param_shadow``'s optimizer (the protocol of
    ``schedules.GradientTransformation``)."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return (self.inner.init(params), shadow_cast(params))

    @torch.no_grad()
    def update_(self, grads, state, params, keep=None, norm_counted=True):
        inner_state, shadow = state
        norm = self.inner.update_(grads, inner_state, params, keep=keep,
                                  norm_counted=norm_counted)
        for name, p in params.items():
            shadow[name].copy_(p)
        return norm


def bf16_param_shadow(inner):
    """Wrap an optimizer so its state is ``(inner_state, shadow)`` with a
    bf16 copy of the masters, refreshed after every update."""
    return _Shadowed(inner)


def shadow_params(opt_state) -> Dict[str, torch.Tensor]:
    """The bf16 shadow out of a ``bf16_param_shadow`` optimizer state."""
    return opt_state[1]
