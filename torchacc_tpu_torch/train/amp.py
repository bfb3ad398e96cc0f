"""bf16 compute over f32 master weights (the port of the bf16-shadow
half of torchacc_tpu/train/amp.py: ``shadow_cast`` :70,
``bf16_param_shadow`` :81, ``shadow_params`` :134, ``global_norm_f32``
:139).  The fp16 loss scaler is not ported (ROADMAP A11).

The optimizer state carries a bf16 copy of the f32 masters.  The
forward and backward read the copy, so gradients arrive in bf16; the
wrapped optimizer applies them to the masters and then refreshes the
copy as the bf16 cast of the masters.  Invariant: after every step,
``shadow == shadow_cast(masters)``.  In the port the shadow tensors are
the model's own parameters (``Trainer`` swaps them in), refreshed in
place.
"""

from __future__ import annotations

from typing import Dict

import torch



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
    def update_(self, grads, state, params):
        inner_state, shadow = state
        norm = self.inner.update_(grads, inner_state, params)
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
