"""The Trainer, core only (the port of torchacc_tpu/train/trainer.py):
``shift_labels`` (:50), ``Trainer.__init__``/``init``/``step`` (:933,
the step of ``_build_train_step`` :563), ``eval_step`` and ``fit``
(:1272), on one device or on a mesh.

One step is forward -> loss (the fused linear + CE head by default) ->
backward -> f32 global-norm clip -> AdamW on the f32 masters; with
``compute.bf16_compute_params`` the forward and backward read the bf16
shadow, which the optimizer refreshes after the update (train/amp.py).
Where JAX jits one donated step function, the port runs eagerly and
updates the masters and moments in place.  ``step`` returns the loss
and the gradient norm as device tensors and does not synchronise;
``fit`` reads the loss back only on its logging steps, as the JAX loop
does.

With ``grad_accum`` = n > 1 the global batch splits into n micro-batches
along dim 0 (a batch size not divisible by n raises).  Each
micro-batch's loss *sum* (times the fp16 loss scale) is back-propagated,
and post-accumulate-grad hooks move each gradient into a buffer of
``compute.accum_dtype`` as it arrives (torch would otherwise add the
next micro-batch's gradient into ``.grad`` in the parameter's dtype,
bf16 under the shadow); the step's gradient is the sum over the
micro-batches divided by their summed token count, and so is its loss.
Micro-batch i draws attention dropout with the seed ``step * n + i``.

With ``compute.quant`` on, the delayed-scaling amax histories ride
``TrainState.quant``: each micro-batch's forward reads the histories the
previous one left (the first reads the step's), the sites put the
advanced histories aside, and the step commits the last micro-batch's
once, after the backward (a remat recompute reads the same histories
its forward did and advances nothing twice); ``eval_step`` reads and
records nothing.

With ``compute.dtype`` float16 the loss scaler of ``train/amp.py`` runs
on the device: the backward sees the loss times ``scaler["scale"]``,
the gradients are divided by it, and a non-finite gradient turns the
update into a no-op by a device-side select (masters and moments stay
bitwise as they were) while ``scaler_update`` halves the scale.
``step`` then also returns ``loss_scale``.  The optimizer's count, a
host integer, steps back for a skipped update: the next update waits
for the flag's copy to the host (``schedules.AdamWState``), so under
the scaler the host runs at most about one step ahead of the card.

On a mesh (``mesh``: ``Config.get_mesh()``; ``accelerate`` passes it
when a process group is up) ``init`` shards the model
(``parallel/sharding.py``: tensor parallelism over 'tp', FSDP2 over
'dp' x 'fsdp'), making a ``meta`` model's weights one block at a time
from ``config.seed``, the same weights on every rank; the masters,
gradients and AdamW moments are then sharded DTensors and the bf16
shadow is FSDP2's mixed-precision policy; without ``grad_accum`` the
step rounds its f32-reduced gradients to bf16, as the shadow's reach
the optimizer (on one device and in JAX).  Each rank steps its own rows
of the global batch (``parallel.mesh.data_shard``).  The loss is the
global sum over the global valid-token count, as in JAX (trainer.py
:667-670): each micro-batch's (sum, count) is all-reduced over the data
axes, FSDP2 sums the gradients (divide factor 1), and the step divides
by the global count.  Under ``grad_accum`` each micro-batch's gradients
are reduce-scattered as its backward ends and the hooks add the local
shards into ``accum_dtype`` buffers of the shard's shape.  With
``grad_accum`` the micro-batches split each rank's rows, where JAX
splits the global batch: the same sum, but quantized matmuls would see
other rows per micro-batch, so that combination raises on more than one
data shard (ROADMAP.md C2, A8b).  ``fit`` logs on rank 0 only.

Not ported: the tiered checkpoints (ROADMAP A9), and the resilience,
SDC, guard, telemetry and dispatch-ring hooks (A13).
"""

from __future__ import annotations

import itertools
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from torchacc_tpu_torch.config import Config
from torchacc_tpu_torch.models.transformer import (
    TransformerLM,
    check_training_supported,
    init_params,
    init_quant_state,
    loss_sum_count,
    materializer,
    quant_site_names,
)
from torchacc_tpu_torch.ops._common import resolve_device, to_local
from torchacc_tpu_torch.parallel.distributed import is_primary
from torchacc_tpu_torch.parallel.mesh import describe_mesh
from torchacc_tpu_torch.parallel.sharding import shard_model
from torchacc_tpu_torch.train.amp import (
    all_finite,
    bf16_param_shadow,
    scaler_init,
    scaler_update,
    shadow_params,
)
from torchacc_tpu_torch.train.schedules import GradientTransformation, adamw
from torchacc_tpu_torch.train.state import TrainState
from torchacc_tpu_torch.utils.logger import logger


def shift_labels(input_ids: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token labels from input_ids (last position ignored).  With
    packed sequences, a position whose next token belongs to another
    document (or to padding, segment -1) gets -100."""
    labels = torch.cat([input_ids[:, 1:],
                        torch.full_like(input_ids[:, :1], -100)], dim=1)
    if segment_ids is not None:
        next_seg = torch.cat([segment_ids[:, 1:],
                              torch.full_like(segment_ids[:, :1], -1)], dim=1)
        valid = (next_seg == segment_ids) & (segment_ids >= 0)
        labels = torch.where(valid, labels, -100)
    return labels


def _swap_param(model: nn.Module, name: str, tensor: torch.Tensor) -> None:
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    setattr(mod, leaf, tensor if isinstance(tensor, nn.Parameter)
            else nn.Parameter(tensor))


class Trainer:
    """Trains a port ``TransformerLM`` on one device or on a mesh.

    Parameters
    ----------
    model: a ``TransformerLM`` (weights on ``meta`` are made by
        :meth:`init` from ``config.seed``)
    config: the framework ``Config``
    optimizer: a ``schedules.GradientTransformation`` (default: optax's
        ``adamw(1e-4)`` defaults, no clipping)
    loss: ``loss(logits, batch)`` -> scalar mean or ``(sum, count)``;
        default next-token CE with -100 ignored
    device: where a ``meta`` model is made (None = the card)
    mesh: the ``DeviceMesh`` to shard over (``Config.get_mesh()``), or
        None for one device
    """

    def __init__(self, model: TransformerLM, config: Config,
                 optimizer: Optional[GradientTransformation] = None,
                 loss: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        config.validate()
        self.model = model
        self.config = config
        self.mesh = mesh
        self.optimizer = optimizer or adamw(
            1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
            grad_clip_norm=None)
        # on a mesh FSDP2's mixed-precision policy takes the shadow's place
        self._shadow_on = config.compute.bf16_compute_params and mesh is None
        self._bf16_reduced = (config.compute.bf16_compute_params
                              and mesh is not None)
        if self._shadow_on:
            self.optimizer = bf16_param_shadow(self.optimizer)
        self.loss = loss or (lambda logits, batch: loss_sum_count(
            logits, batch.get("labels", shift_labels(
                batch["input_ids"], batch.get("segment_ids")))))
        self._use_fused_ce = (loss is None and config.compute.fused_kernels
                              and isinstance(model, TransformerLM)
                              and not model.cfg.head_bias)
        self.device = (resolve_device(device) if model.device.type == "meta"
                       else model.device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the model "
                             f"on {self.device}")
        # the batch rows of one step are split over this many ranks
        self._data_shards = 1
        if mesh is not None:
            sizes = describe_mesh(mesh)
            self._data_shards = sizes["dp"] * sizes["fsdp"]
        if isinstance(model, TransformerLM):
            # an unported composition (the 'head' quant site, ...) raises
            # by name here, not at the first step
            check_training_supported(model.cfg)
        self.state: Optional[TrainState] = None
        # the gradient accumulators of the micro-batch loop (name ->
        # buffer in compute.accum_dtype), filled by the parameters'
        # post-accumulate-grad hooks; None outside that loop
        self._acc: Optional[Dict[str, torch.Tensor]] = None

    # -- init ---------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> TrainState:
        """The train state: weights made from ``seed`` (default
        ``config.seed``) when the model is on ``meta``, else the model's
        own weights, as f32 masters; the optimizer state; step 0."""
        cfg = self.model.cfg
        pdt = self.config.compute.param_dtype
        seed = self.config.seed if seed is None else seed
        if self.mesh is not None:
            masters = self._shard(seed, pdt)
        else:
            if self.model.device.type == "meta":
                self.model = init_params(cfg, seed=seed, device=self.device,
                                         dtype=pdt)
            masters = {}
            for name, p in list(self.model.named_parameters()):
                m = p.detach().to(pdt)
                masters[name] = m
                if not self._shadow_on:
                    _swap_param(self.model, name, nn.Parameter(m))
                    masters[name] = self.model.get_parameter(name)
        opt_state = self.optimizer.init(masters)
        if self._shadow_on:
            # the shadow IS the model's parameters: one bf16 copy, which
            # the optimizer refreshes in place
            shadow = shadow_params(opt_state)
            for name in list(shadow):
                _swap_param(self.model, name, shadow[name])
                shadow[name] = self.model.get_parameter(name)
        self.model.requires_grad_(True).train()
        if self.config.grad_accum > 1:
            for name, p in self.model.named_parameters():
                p.register_post_accumulate_grad_hook(
                    self._accumulate_hook(name))
        scaler = (scaler_init(device=self.device)
                  if self.config.compute.dtype == torch.float16 else None)
        # zero histories: "no observation yet", so the first quantized
        # step falls back to just-in-time scales
        self.state = TrainState(step=0, params=masters, opt_state=opt_state,
                                scaler=scaler,
                                quant=init_quant_state(cfg, self.device))
        n = sum(p.numel() for p in masters.values())
        logger.info(f"initialised {n / 1e6:.1f}M params on {self.device}")
        return self.state

    def _shard(self, seed: int, pdt: torch.dtype) -> Dict[str, torch.Tensor]:
        """Shard the model over the mesh (a ``meta`` model's weights made
        block by block from ``seed``, the same on every rank); the
        masters are the sharded parameters themselves."""
        make = None
        if self.model.device.type == "meta":
            make = materializer(seed, self.device)
        else:
            for name, p in list(self.model.named_parameters()):
                if p.dtype != pdt:
                    _swap_param(self.model, name,
                                nn.Parameter(p.detach().to(pdt)))
        shard_model(self.model, self.mesh, self.config, make)
        return dict(self.model.named_parameters())

    # -- train step -----------------------------------------------------------
    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _forward_sum_count(self, batch, train: bool = True,
                           dropout_seed: Optional[int] = None, quant=None):
        """(loss_sum, token_count, new_quant) of one batch.  ``quant``:
        the histories this forward reads (default the state's).  On a
        train step the quantized sites' advanced histories come back as
        the third element (None when quant is off, and in evaluation,
        which reads the scales and records nothing) and attention
        dropout draws with ``dropout_seed`` (default the step)."""
        cfg = self.model.cfg
        kw = dict(positions=batch.get("positions"),
                  segment_ids=batch.get("segment_ids"))
        new_quant = None
        if self.state.quant is not None:
            new_quant = {} if train else None
            kw.update(quant=self.state.quant if quant is None else quant,
                      quant_out=new_quant)
        if train and cfg.attn_dropout > 0.0:
            kw["dropout_seed"] = (self.state.step if dropout_seed is None
                                  else dropout_seed)
        l_sum, count = self._loss_sum_count(batch, kw)
        return l_sum, count, new_quant

    def _loss_sum_count(self, batch, kw):
        if self._use_fused_ce:
            labels = batch.get("labels", shift_labels(
                batch["input_ids"], batch.get("segment_ids")))
            return self.model(batch["input_ids"], labels=labels, **kw)
        res = self.loss(self.model(batch["input_ids"], **kw), batch)
        if isinstance(res, tuple):
            return res
        return res, torch.ones((), dtype=torch.float32, device=self.device)

    def _accumulate_hook(self, name: str):
        # a weak reference: the hook lives on the parameter, and a strong
        # one would keep the trainer (and its optimizer state) alive in a
        # cycle past the last reference to it
        ref = weakref.ref(self)

        def hook(p: torch.Tensor) -> None:
            trainer = ref()
            acc = None if trainer is None else trainer._acc
            if acc is not None:
                acc[name].add_(to_local(p.grad))
                p.grad = None
        return hook

    def _global(self, l_sum: torch.Tensor, count: torch.Tensor):
        """``(loss_sum, count)`` summed over the data axes' ranks: the
        global batch's (as they are on one device)."""
        tot = torch.stack([l_sum.detach().float(), count.float()])
        for group in getattr(self.model, "data_groups", ()):
            dist.all_reduce(tot, group=group)
        return tot[0], tot[1]

    def _check_quant(self, new_quant) -> None:
        missing = set(quant_site_names(self.model.cfg)) - set(new_quant)
        if missing:
            raise RuntimeError(f"quantized sites that recorded no amax "
                               f"this step: {sorted(missing)}")

    def _grads_one(self, batch, scale):
        """(loss, gradients, new_quant) of one unsplit batch: the
        gradient of the mean loss (times ``scale``, then divided by
        it)."""
        l_sum, count, new_quant = self._forward_sum_count(batch)
        g_sum, g_count = self._global(l_sum, count)
        denom = torch.clamp(g_count, min=1.0)
        loss = l_sum / denom
        (loss if scale is None else loss * scale).backward()
        grads = {}
        for n, p in self.model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self._bf16_reduced:
                # FSDP2 reduces in f32; the shadow's gradients reach the
                # optimizer in bf16
                g, p.grad = g.to(torch.bfloat16), None
            if scale is not None:
                to_local(g).div_(scale)
            grads[n] = g
        return g_sum / denom, grads, new_quant

    def _grads_accumulated(self, batch, scale):
        """(loss, gradients, new_quant) over ``grad_accum`` micro-batches:
        Σ loss_sum / Σ count and the gradients summed in
        ``compute.accum_dtype``, divided by Σ count (and ``scale``) in
        f32."""
        accum = self.config.grad_accum
        bsz = batch["input_ids"].shape[0]
        if bsz % accum:
            raise ValueError(f"batch size {bsz} not divisible by "
                             f"grad_accum {accum}")
        mb = bsz // accum
        acc_dt = self.config.compute.accum_dtype
        params = dict(self.model.named_parameters())
        self._acc = {n: torch.zeros(to_local(p).shape, dtype=acc_dt,
                                    device=self.device)
                     for n, p in params.items()}
        l_tot = c_tot = None
        quant = self.state.quant
        try:
            for i in range(accum):
                micro = {k: v if v.ndim == 0 else v[i * mb:(i + 1) * mb]
                         for k, v in batch.items()}
                l_sum, count, new_quant = self._forward_sum_count(
                    micro, dropout_seed=self.state.step * accum + i,
                    quant=quant)
                (l_sum if scale is None else l_sum * scale).backward()
                l_sum, count = l_sum.detach().float(), count.detach()
                l_tot = l_sum if l_tot is None else l_tot + l_sum
                c_tot = count if c_tot is None else c_tot + count
                if new_quant is not None:
                    self._check_quant(new_quant)
                    quant = new_quant
            acc = self._acc
        finally:
            self._acc = None
        l_tot, c_tot = self._global(l_tot, c_tot)
        c_tot = torch.clamp(c_tot, min=1.0)
        denom = c_tot if scale is None else c_tot * scale
        grads = {}
        for n, a in acc.items():
            g = (a.div_(denom) if a.dtype == torch.float32
                 else a.float().div_(denom))
            p = params[n]
            grads[n] = g if not isinstance(p, DTensor) else DTensor.from_local(
                g, p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride())
        return (l_tot / c_tot, grads,
                quant if self.state.quant is not None else None)

    def step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step.  Returns ``{"loss", "grad_norm"}`` (and
        ``"loss_scale"`` under the fp16 scaler) as device tensors,
        without synchronising."""
        if self.state is None:
            self.init()
        batch = self._batch(batch)
        scaler = self.state.scaler
        scale = None if scaler is None else scaler["scale"]
        if self.config.grad_accum > 1:
            loss, grads, new_quant = self._grads_accumulated(batch, scale)
        else:
            loss, grads, new_quant = self._grads_one(batch, scale)
        if new_quant is not None:
            # committed once, after the backward: a recompute has read
            # the histories its micro-batch started with
            self._check_quant(new_quant)
            self.state.quant = new_quant
        finite = None if scaler is None else all_finite(grads.values())
        grad_norm = self.optimizer.update_(grads, self.state.opt_state,
                                           self.state.params, keep=finite)
        for p in self.model.parameters():
            p.grad = None
        self.state.step += 1
        out = {"loss": loss, "grad_norm": grad_norm}
        if scaler is not None:
            self.state.scaler = scaler_update(scaler, finite)
            out["loss_scale"] = self.state.scaler["scale"]
        return out

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The loss of one batch without a gradient or an update: no
        dropout, and the quantized sites read their scales and leave the
        histories as they are."""
        if self.state is None:
            self.init()
        was_training = self.model.training
        self.model.eval()
        try:
            l_sum, count, _ = self._forward_sum_count(self._batch(batch),
                                                      train=False)
        finally:
            self.model.train(was_training)
        l_sum, count = self._global(l_sum, count)
        return {"loss": l_sum / torch.clamp(count, min=1.0)}

    # -- loop -----------------------------------------------------------------
    def fit(self, loader, *, max_steps: Optional[int] = None,
            log_every: int = 50) -> List[Dict[str, Any]]:
        """Run ``step`` over ``loader`` (at most ``max_steps`` batches).
        Returns a ``{step, loss, time_s, steps_per_sec,
        tokens_per_sec}`` record for every ``log_every``-th step; only
        those steps read the loss back to the host.  On a mesh
        ``loader`` yields this rank's rows, ``tokens_per_sec`` counts the
        global batch's and only rank 0 logs."""
        if self.state is None:
            self.init()
        history = []
        t0 = time.perf_counter()
        t_prev, s_prev = t0, self.state.step
        for batch in itertools.islice(loader, max_steps):
            r = self.state.step
            m = self.step(batch)
            if not (log_every and r % log_every == 0):
                continue
            loss = float(m["loss"])
            now = time.perf_counter()
            rec = {"step": r, "loss": loss, "time_s": round(now - t0, 2)}
            if r > s_prev:
                rec["steps_per_sec"] = round(
                    (r - s_prev) / max(now - t_prev, 1e-9), 3)
                ids = batch["input_ids"]
                rec["tokens_per_sec"] = round(
                    rec["steps_per_sec"] * ids.shape[0] * ids.shape[1]
                    * self._data_shards, 1)
            t_prev, s_prev = now, r
            history.append(rec)
            if is_primary():
                logger.info(f"step {r}: loss {loss:.4f}")
        return history
