"""Mixed precision (the port of torchacc_tpu/train/amp.py): the fp16
dynamic loss scaler (``scaler_init`` :23, ``all_finite`` :33,
``scaler_update`` :38) and bf16 compute over f32
master weights (``shadow_cast`` :70, ``bf16_param_shadow`` :81,
``shadow_params`` :134, ``global_norm_f32`` :139).

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

from typing import Dict, Iterable

import torch


def scaler_init(init_scale: float = 2.0 ** 15,
                device=None) -> Dict[str, torch.Tensor]:
    """Dynamic-loss-scale state: ``scale`` (f32) and ``growth_count``
    (int32), 0-dim tensors on ``device``."""
    return {"scale": torch.tensor(init_scale, dtype=torch.float32,
                                  device=device),
            "growth_count": torch.zeros((), dtype=torch.int32,
                                        device=device)}


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A 0-dim bool tensor: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


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


def global_norm_f32(tensors) -> torch.Tensor:
    """Global l2 norm with f32 accumulation whatever the leaf dtype (a
    0-dim tensor on the leaves' device; no host sync): a bf16 gradient
    tree would otherwise accumulate its norm in bf16."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class _Shadowed:
    """``bf16_param_shadow``'s optimizer (the protocol of
    ``schedules.GradientTransformation``)."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return (self.inner.init(params), shadow_cast(params))

    @torch.no_grad()
    def update_(self, grads, state, params, keep=None):
        inner_state, shadow = state
        norm = self.inner.update_(grads, inner_state, params, keep=keep)
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
