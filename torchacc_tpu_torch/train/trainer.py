"""The Trainer, core only (the port of torchacc_tpu/train/trainer.py):
``shift_labels`` (:50), ``Trainer.__init__``/``init``/``step`` (:933),
``eval_step`` and ``fit`` (:1272), on one device.

One step is forward -> loss (the fused linear + CE head by default) ->
backward -> f32 global-norm clip -> AdamW on the f32 masters; with
``compute.bf16_compute_params`` the forward and backward read the bf16
shadow, which the optimizer refreshes after the update (train/amp.py).
Where JAX jits one donated step function, the port runs eagerly and
updates the masters and moments in place.  ``step`` returns the loss
and the gradient norm as device tensors and does not synchronise;
``fit`` reads the loss back only on its logging steps, as the JAX loop
does.  With ``compute.quant`` on, the delayed-scaling amax histories
ride ``TrainState.quant``: a step's forward reads them, the sites put
the advanced histories aside, and the step commits those once, after
the backward (a remat recompute reads the same histories the forward
did and advances nothing twice); ``eval_step`` reads and records
nothing.  With ``attn_dropout`` set, a train step passes its step
number as the dropout seed; evaluation passes none.  The resilience, SDC, guard, telemetry, tiered-checkpoint and
dispatch-ring hooks are not ported (ROADMAP A9, A13).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import nn

from torchacc_tpu_torch.config import Config
from torchacc_tpu_torch.models.transformer import (
    TransformerLM,
    check_training_supported,
    head_weight,
    init_params,
    init_quant_state,
    loss_sum_count,
    quant_site_names,
)
from torchacc_tpu_torch.ops._common import resolve_device
from torchacc_tpu_torch.ops.fused import fused_linear_cross_entropy
from torchacc_tpu_torch.train.amp import bf16_param_shadow, shadow_params
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
    """Trains a port ``TransformerLM`` on one device.

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
    """

    def __init__(self, model: TransformerLM, config: Config,
                 optimizer: Optional[GradientTransformation] = None,
                 loss: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None):
        config.validate()
        self.model = model
        self.config = config
        self.optimizer = optimizer or adamw(
            1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
            grad_clip_norm=None)
        self._shadow_on = config.compute.bf16_compute_params
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
        if isinstance(model, TransformerLM):
            # an unported composition (the 'head' quant site, ...) raises
            # by name here, not at the first step
            check_training_supported(model.cfg)
        self.state: Optional[TrainState] = None

    # -- init ---------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> TrainState:
        """The train state: weights made from ``seed`` (default
        ``config.seed``) when the model is on ``meta``, else the model's
        own weights, as f32 masters; the optimizer state; step 0."""
        cfg = self.model.cfg
        pdt = self.config.compute.param_dtype
        if self.model.device.type == "meta":
            self.model = init_params(
                cfg, seed=self.config.seed if seed is None else seed,
                device=self.device, dtype=pdt)
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
        # zero histories: "no observation yet", so the first quantized
        # step falls back to just-in-time scales
        self.state = TrainState(step=0, params=masters, opt_state=opt_state,
                                quant=init_quant_state(cfg, self.device))
        n = sum(p.numel() for p in masters.values())
        logger.info(f"initialised {n / 1e6:.1f}M params on {self.device}")
        return self.state

    # -- train step -----------------------------------------------------------
    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _forward_sum_count(self, batch, train: bool = True):
        """(loss_sum, token_count, new_quant) of one batch.  On a train
        step the quantized sites' advanced histories come back as the
        third element (None when quant is off, and in evaluation, which
        reads the scales and records nothing) and attention dropout gets
        the step as its seed."""
        cfg = self.model.cfg
        kw = dict(positions=batch.get("positions"),
                  segment_ids=batch.get("segment_ids"))
        new_quant = None
        if self.state.quant is not None:
            new_quant = {} if train else None
            kw.update(quant=self.state.quant, quant_out=new_quant)
        if train and cfg.attn_dropout > 0.0:
            kw["dropout_seed"] = self.state.step
        l_sum, count = self._loss_sum_count(batch, kw)
        return l_sum, count, new_quant

    def _loss_sum_count(self, batch, kw):
        if self._use_fused_ce:
            hidden = self.model(batch["input_ids"], return_hidden=True, **kw)
            labels = batch.get("labels", shift_labels(
                batch["input_ids"], batch.get("segment_ids")))
            return fused_linear_cross_entropy(
                hidden, head_weight(self.model).t(), labels,
                logit_softcap=self.model.cfg.logit_softcap)
        res = self.loss(self.model(batch["input_ids"], **kw), batch)
        if isinstance(res, tuple):
            return res
        return res, torch.ones((), dtype=torch.float32, device=self.device)

    def step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step.  Returns ``{"loss", "grad_norm"}`` as
        device tensors, without synchronising."""
        if self.state is None:
            self.init()
        batch = self._batch(batch)
        l_sum, count, new_quant = self._forward_sum_count(batch)
        loss = l_sum / torch.clamp(count, min=1.0)
        loss.backward()
        if new_quant is not None:
            # committed once, after the backward: a recompute has read
            # the histories this step started with
            missing = set(quant_site_names(self.model.cfg)) - set(new_quant)
            if missing:
                raise RuntimeError(f"quantized sites that recorded no amax "
                                   f"this step: {sorted(missing)}")
            self.state.quant = new_quant
        named = list(self.model.named_parameters())
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named}
        grad_norm = self.optimizer.update_(grads, self.state.opt_state,
                                           self.state.params)
        for _, p in named:
            p.grad = None
        self.state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

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
        return {"loss": l_sum / torch.clamp(count, min=1.0)}

    # -- loop -----------------------------------------------------------------
    def fit(self, loader, *, max_steps: Optional[int] = None,
            log_every: int = 50) -> List[Dict[str, Any]]:
        """Run ``step`` over ``loader`` (at most ``max_steps`` batches).
        Returns a ``{step, loss, time_s, steps_per_sec,
        tokens_per_sec}`` record for every ``log_every``-th step; only
        those steps read the loss back to the host."""
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
                    rec["steps_per_sec"] * ids.shape[0] * ids.shape[1], 1)
            t_prev, s_prev = now, r
            history.append(rec)
            logger.info(f"step {r}: loss {loss:.4f}")
        return history
