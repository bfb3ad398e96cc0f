"""Learning-rate schedules and the optimizer (the port of
torchacc_tpu/train/schedules.py): ``warmup_cosine`` (:18),
``clip_by_global_norm_f32`` (:40) and ``adamw`` (:66), on plain torch
tensors with no optax.

``adamw`` computes exactly optax's ``chain(clip_by_global_norm_f32,
adamw(lr, b1, b2, eps, weight_decay))``: the global norm accumulated in
f32; Adam moments ``mu = b1 mu + (1 - b1) g`` and ``nu = b2 nu + (1 -
b2) g^2`` with bias correction by ``1 - b^t`` (t counting from 1);
``eps`` outside the square root (``eps_root`` 0); decoupled weight decay
``+ wd * param`` on every leaf (optax's default mask is None); the step
``-lr(count) * update`` with the schedule read at the count *before*
the increment, as ``scale_by_schedule`` does.  Where optax builds a
new updates tree, the port updates the masters and the moments in
place, one parameter at a time, so that its transient memory is one
parameter's f32 copy (the port may update in place where that saves
memory).  Gradients are upcast to f32 per element before the moment
math; optax multiplies a bf16 gradient by ``1 - b`` in bf16 first.

On a mesh the masters, gradients and moments are sharded ``DTensor``s
with one placement each (the moments are made like their parameter);
the update reads and writes their local shards in place, with the same
arithmetic per element, and the global norm is reduced over the ranks
(``amp.global_norm_f32``).

Under the fp16 loss scaler an update may be skipped:
``update_(..., keep=flag)`` takes a 0-dim bool device tensor and
selects every write on it, so a skipped update leaves the masters and
both moments bitwise as they were.  The count, a host integer that the
schedule and the bias correction read, then advances only where the
flag says the update applied.  So the host reads the flag, once a
step: it is copied to pinned host memory as soon as it is known, and
the next update (or a read of ``count``) waits for that copy's event.
The wait lets the host run at most about one step ahead of the card;
it does not drain the card's queue, which still holds the previous
update and the next step's forward and backward.  ``AdamWState.
flag_wait_s`` sums the host's time in it.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Union

import torch

from torchacc_tpu_torch.ops._common import to_local
from torchacc_tpu_torch.train.amp import global_norm_f32

Schedule = Callable[[int], float]


def warmup_cosine(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr_ratio: float = 0.1) -> Schedule:
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then
    cosine decay to ``peak_lr * end_lr_ratio`` at ``total_steps``
    (optax ``warmup_cosine_decay_schedule`` / ``cosine_decay_schedule``)."""
    def cosine(count: int, init: float, decay_steps: int,
               alpha: float) -> float:
        count = min(count, decay_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init * ((1.0 - alpha) * decay + alpha)

    if warmup_steps <= 0:
        steps = max(total_steps, 1)
        return lambda count: cosine(count, peak_lr, steps, end_lr_ratio)
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    alpha = 0.0 if peak_lr == 0.0 else (peak_lr * end_lr_ratio) / peak_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return -peak_lr * frac + peak_lr
        return cosine(count - warmup_steps, peak_lr, decay_steps, alpha)
    return schedule


def clip_by_global_norm_f32(grads, max_norm: float):
    """``(scale, norm)``: the factor ``min(1, max_norm / max(norm,
    1e-16))`` by which every gradient is multiplied, and the f32 global
    norm, both 0-dim tensors on the device."""
    norm = global_norm_f32(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-16), max=1.0)
    return scale, norm


class AdamWState:
    """Adam moments per parameter name (f32) and the update count."""

    def __init__(self, mu: Dict[str, torch.Tensor],
                 nu: Dict[str, torch.Tensor], count: int = 0):
        self.mu, self.nu = mu, nu
        self._count = count
        # (host copy of the last update's keep flag, its copy's event)
        self._pending = None
        #: seconds the host has waited for a keep flag's copy
        self.flag_wait_s = 0.0

    @property
    def count(self) -> int:
        """Updates applied so far (reads a pending skip flag, waiting
        for its copy to land)."""
        if self._pending is not None:
            flag, event = self._pending
            if event is not None:
                t0 = time.perf_counter()
                event.synchronize()
                self.flag_wait_s += time.perf_counter() - t0
            self._pending = None
            if not bool(flag):
                self._count -= 1
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self._pending = None
        self._count = value


def _host_flag(keep: torch.Tensor):
    """(a host copy of ``keep``, the event after its copy): on the card
    a non-blocking copy into pinned memory, read once the event is
    done.  An update whose flag is false steps the count back when the
    count is next read."""
    if keep.is_cuda:
        flag = torch.empty((), dtype=torch.bool, pin_memory=True)
        flag.copy_(keep, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return flag, event
    return keep.clone(), None


class GradientTransformation:
    """The port's optimizer protocol: ``init(params) -> state`` and
    ``update_(grads, state, params) -> grad_norm`` applying one step in
    place to ``params`` (f32 masters) and ``state``."""

    def init(self, params: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def update_(self, grads: Dict[str, torch.Tensor], state,
                params: Dict[str, torch.Tensor],
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: a 0-dim bool device tensor; where false, nothing
        changes (the fp16 scaler's skipped step)."""
        raise NotImplementedError


class AdamW(GradientTransformation):
    def __init__(self, lr: Union[float, Schedule], *, weight_decay: float,
                 b1: float, b2: float, eps: float,
                 grad_clip_norm: Optional[float]):
        self.lr = lr if callable(lr) else (lambda count, v=lr: v)
        self.weight_decay, self.b1, self.b2 = weight_decay, b1, b2
        self.eps, self.grad_clip_norm = eps, grad_clip_norm

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(mu={n: zeros(p) for n, p in params.items()},
                          nu={n: zeros(p) for n, p in params.items()})

    @torch.no_grad()
    def update_(self, grads, state, params, keep=None):
        if self.grad_clip_norm:
            scale, norm = clip_by_global_norm_f32(grads.values(),
                                                  self.grad_clip_norm)
        else:
            scale, norm = None, global_norm_f32(grads.values())
        count = state.count
        # copied to the host before the update's work is queued, so that
        # the next update finds it landed
        pending = None if keep is None else _host_flag(keep)
        lr = float(self.lr(count))
        t = count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for name, p in params.items():
            g = to_local(grads[name])
            p = to_local(p)
            if scale is not None:
                # optax casts the clipped gradient back to its own dtype
                g = (g.float() * scale).to(g.dtype)
            g = g.float()
            mu, nu = to_local(state.mu[name]), to_local(state.nu[name])
            if keep is None:
                mu_new, nu_new = mu, nu
                mu_new.mul_(self.b1)
                nu_new.mul_(self.b2)
            else:
                mu_new, nu_new = mu.mul(self.b1), nu.mul(self.b2)
            mu_new.add_(g, alpha=1.0 - self.b1)
            nu_new.addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu_new / bc1).div_((nu_new / bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                upd.add_(p.float(), alpha=self.weight_decay)
            upd = upd.mul_(-lr).to(p.dtype)
            if keep is None:
                p.add_(upd)
            else:
                mu.copy_(torch.where(keep, mu_new, mu))
                nu.copy_(torch.where(keep, nu_new, nu))
                p.copy_(torch.where(keep, p + upd, p))
        state.count = t
        state._pending = pending
        return norm


def adamw(lr: Union[float, Schedule], *, weight_decay: float = 0.01,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          grad_clip_norm: Optional[float] = 1.0) -> AdamW:
    """AdamW with optional f32 global-norm clipping (the LLM-training
    default of the JAX package's ``schedules.adamw``)."""
    return AdamW(lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                 grad_clip_norm=grad_clip_norm)
