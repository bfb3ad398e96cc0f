"""The Trainer, core only (the port of torchacc_tpu/train/trainer.py):
``shift_labels`` (:50), ``Trainer.__init__``/``init``/``step`` (:933,
the step of ``_build_train_step`` :563), ``init_from_params`` and
``swap_params`` (:296, :333), ``eval_step``, ``save`` and ``restore``
(:1114, :1147) and ``fit`` (:1272-1515, with its evaluation :1629-1660
and its checkpoint saves :1805-1845), on one device or on a mesh.

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
its forward did and advances nothing twice); a step the fp16 scaler
skips keeps the old ones, by a device-side select.  The 'head' site
needs the materialised logits: with the fused CE on it raises, as in
JAX.  ``eval_step`` reads and records nothing.

A mixture of experts (``num_experts`` > 0) adds ``router_aux_weight *
aux * count`` to each (micro-)batch's loss sum, ``aux`` the forward's
router losses summed over the layers and ``count`` the batch's tokens,
as the JAX Trainer does (:133-134, :557-559); under 'pp' each chunk
adds its own with its micro-batch's count (``pp_forward_sum_count``).

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
shards into ``accum_dtype`` buffers of the shard's shape.  Where a step
splits micro-batches (``grad_accum`` or 'pp') on more than one data
shard, each rank first takes its share of JAX's micro-batches, which
cut the global batch (``_jax_rows``): micro-batch i's quantized amax,
dropout coordinates and mixture-of-experts routing are JAX's.  ``fit``
logs on rank 0 only.

Under context parallelism ('sp' x 'spu' above 1) the sequence ranks of
one data shard take the same rows; ``step`` and ``eval_step`` compute
the labels (``shift_labels``), the default positions and the segment
ids on those whole rows, then keep this rank's chunk of the sequence
(``parallel.mesh.seq_shard``): the label of a chunk's last token, the
documents and RoPE are the whole row's.  The loss's (sum, count) is
summed over the sequence ranks as over the data ranks, and so are the
quantized sites' amax reductions; the gradients, partial sums over each
rank's tokens, are all-reduced over the sequence ranks, one group over
'sp' x 'spu' (``parallel.sharding.seq_group``), after the backward and
before the optimizer reads them; only the first chunk's rank counts
them in the global norm.

Under pipeline parallelism (``dist.pp``, ``parallel/pp.py``) each rank
is one stage and holds its stage's blocks; the step's micro-batch loop
(``grad_accum`` an outer loop, as in JAX) runs the schedule on each
``grad_accum`` micro-batch: ``pp.num_micro_batches`` pipeline
micro-batches, the backward driven stage by stage as the schedule goes
(``models.transformer.pp_forward_sum_count``), the gradients reaching
the accumulators through the same hooks.  The loss and count live on
the last stage and are summed over 'pp' with the data axes; the
gradients of the embedding, the final norm and the head (every stage
holds them) are summed over 'pp'; the global norm counts each stage's
blocks once and the replicated parameters on the first stage only.
``eval_step`` runs the forward ticks alone.  ``pipeline`` replaces the
mesh's stage and transport, e.g. with every stage in one process.

Checkpoints (``checkpoint/``): ``save``/``restore`` write and read the
whole state (masters, AdamW moments and count, the fp16 scaler, the
amax histories, the step); ``fit(checkpoint_dir=...)`` saves through a
``CheckpointManager`` and resumes with ``resume='auto'``.  A restore
writes the masters in place, so it makes the bf16 shadow again (on a
mesh FSDP2 casts the masters at every forward by itself).

Not ported: the tiered checkpoints, the emergency save on a preemption
signal, and the resilience, SDC, guard, telemetry and dispatch-ring
hooks (ROADMAP A13).
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

from torchacc_tpu_torch.checkpoint.io import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from torchacc_tpu_torch.config import DATA_AXES, Config
from torchacc_tpu_torch.errors import (
    CheckpointCorruptionError,
    CheckpointNotFoundError,
    TrainerStateError,
)
from torchacc_tpu_torch.models.hf_stream import copy_full
from torchacc_tpu_torch.models.transformer import (
    TransformerLM,
    check_training_supported,
    init_params,
    init_quant_state,
    loss_sum_count,
    materializer,
    pp_forward_sum_count,
    quant_site_names,
)
from torchacc_tpu_torch.ops._common import resolve_device, to_local
from torchacc_tpu_torch.parallel.distributed import is_primary
from torchacc_tpu_torch.parallel.mesh import (
    data_shard,
    describe_mesh,
    pp_ranks,
    pp_stage,
    seq_shard,
)
from torchacc_tpu_torch.parallel.pp import Pipeline, ProcessGroupTransport
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
from torchacc_tpu_torch.utils.metrics import counters


# elements of one all-reduce of the gradients over the sequence ranks
_SEQ_BUCKET = 1 << 26


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


def jax_micro_rows(local_rows: int, units: int, shards: int,
                   index: int) -> torch.Tensor:
    """The global rows, in order, that data shard ``index`` of
    ``shards`` steps when a step cuts its global batch of ``local_rows
    * shards`` rows into ``units`` micro-batches as JAX does (consecutive
    rows, each micro-batch split over the data shards): ``units`` runs of
    ``B / (units * shards)`` rows.  A micro-batch that does not split
    over the shards raises by name."""
    b = local_rows * shards
    if b % (units * shards):
        raise ValueError(
            f"a global batch of {b} rows in {units} micro-batches "
            f"(grad_accum x pp.num_micro_batches) does not split over the "
            f"{shards} data shards: JAX's micro-batch of {b // units} rows "
            f"must be a multiple of {shards}")
    rows = b // (units * shards)
    first = torch.arange(units) * (b // units) + index * rows
    return (first[:, None] + torch.arange(rows)).reshape(-1)


def _copy_named(dest: Dict[str, torch.Tensor],
                params: Dict[str, torch.Tensor],
                stage_only: bool = False) -> None:
    """Write the full tensors ``params`` into ``dest`` by name (this
    rank's shards of DTensors).  The names and shapes must be the same;
    they are checked before anything is written.  ``stage_only``: the
    blocks ``dest`` lacks are another pipeline stage's, and are left
    out."""
    if stage_only:
        params = {n: t for n, t in params.items()
                  if n in dest or not n.startswith("layers.")}
    bad = [f"{n}: shape {list(t.shape)}, the model's "
           f"{list(dest[n].shape)}" for n, t in params.items()
           if n in dest and tuple(t.shape) != tuple(dest[n].shape)]
    if set(dest) != set(params) or bad:
        raise TrainerStateError(
            f"the parameters do not match the model's: missing "
            f"{sorted(set(dest) - set(params))[:5]}, unexpected "
            f"{sorted(set(params) - set(dest))[:5]}; " + "; ".join(bad[:8]))
    for name, t in params.items():
        copy_full(dest[name], t)


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
    pipeline: under ``dist.pp``, the ``parallel.pp.Pipeline`` the step
        runs (its stages and transport); default: this rank's stage of
        the mesh over a process-group transport.  A pipeline of every
        stage in one process (``tests/torch_pp_virtual.py``) runs the
        schedule on one device.
    """

    def __init__(self, model: TransformerLM, config: Config,
                 optimizer: Optional[GradientTransformation] = None,
                 loss: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None, pipeline: Optional[Pipeline] = None):
        config.validate()
        self.model = model
        self.config = config
        self.mesh = mesh
        self._custom_loss = loss
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
        if (config.compute.quant != "none"
                and "head" in getattr(getattr(model, "cfg", None),
                                      "quant_sites", ())
                and self._use_fused_ce):
            # JAX :150-160: the fused CE never reaches lm_head, so a
            # 'head' site would be silently inert
            raise TrainerStateError(
                "compute.quant_sites includes 'head' but the fused "
                "linear+CE loss path is active — the chunked head "
                "stays in the compute dtype.  Set "
                "compute.fused_kernels=False to quantize the "
                "materialised head, or drop 'head' from quant_sites.")
        # the weight of a mixture of experts' router losses in the loss
        # (JAX :133-134); 0 for a dense model
        mc = getattr(model, "cfg", None)
        self._aux_weight = (mc.router_aux_weight
                            if getattr(mc, "num_experts", 0) > 0 else 0.0)
        self.device = (resolve_device(device) if model.device.type == "meta"
                       else model.device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the model "
                             f"on {self.device}")
        # the batch rows of one step are split over this many ranks, and
        # each row's sequence in (chunks, this rank's chunk)
        self._data_shards = 1
        self._seq = (1, 0)
        if mesh is not None:
            sizes = describe_mesh(mesh)
            self._data_shards = sizes["dp"] * sizes["fsdp"]
            self._seq = seq_shard(mesh)
        if isinstance(model, TransformerLM):
            # an unported composition (the 'head' quant site, ...) raises
            # by name here, not at the first step
            check_training_supported(model.cfg)
        self._pipeline = pipeline
        # this rank's (stages, stage) over 'pp', and whether its
        # process-group transport has made its first exchange
        self._pp_rank = (1, 0) if mesh is None else pp_stage(mesh)
        self._pp_warm = False
        pp = config.dist.pp
        self._pp_on = pp.size > 1
        if self._pp_on:
            self._check_pipeline(pp, pipeline)
        self.state: Optional[TrainState] = None
        # the gradient accumulators of the micro-batch loop (name ->
        # buffer in compute.accum_dtype), filled by the parameters'
        # post-accumulate-grad hooks; None outside that loop
        self._acc: Optional[Dict[str, torch.Tensor]] = None

    def _check_pipeline(self, pp, pipeline) -> None:
        cfg = getattr(self.model, "cfg", None)
        if cfg is None or (cfg.pp_size, cfg.pp_num_micro, cfg.pp_virtual) \
                != (pp.size, pp.num_micro_batches, pp.virtual_stages):
            raise ValueError(
                "dist.pp needs a TransformerLM whose pp_size, pp_num_micro "
                "and pp_virtual are dist.pp's size, num_micro_batches and "
                "virtual_stages (accelerate() sets them)")
        if pipeline is None and self._pp_rank[0] != pp.size:
            raise ValueError(
                f"dist.pp.size {pp.size} needs a mesh with 'pp' "
                f"{pp.size} over a process group (accelerate() builds it) "
                "or a pipeline")
        if pipeline is not None and (
                pipeline.pp_size, pipeline.num_micro, pipeline.schedule,
                pipeline.virtual) != (pp.size, pp.num_micro_batches,
                                      pp.schedule, pp.virtual_stages):
            raise ValueError("the pipeline's stages, micro-batches, "
                             "schedule and chunks are not dist.pp's")

    # -- init ---------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> TrainState:
        """The train state: weights made from ``seed`` (default
        ``config.seed``) when the model is on ``meta``, else the model's
        own weights, as f32 masters; the optimizer state; step 0."""
        return self._init(self.config.seed if seed is None else seed)

    def init_from_params(self, params) -> TrainState:
        """The train state from given weights (``init_from_params`` of
        the JAX Trainer, :296): a ``meta`` model gets storage without a
        random init first, the weights are written into the masters
        (this rank's shards on a mesh), the optimizer state starts fresh
        and the step at 0, and the bf16 shadow is made from them.

        ``params``: the full tensors by the port's parameter names, on
        any device (``models.hf.load_hf_model``), or a function that
        fills, in place, the masters it is given by name
        (``models.hf_stream.stream_params`` over a checkpoint's files,
        one tensor at a time)."""
        fill = params if callable(params) else (
            lambda dest: _copy_named(dest, params, self._pp_rank[0] > 1))
        return self._init(None, fill)

    def _init(self, seed: Optional[int], fill=None) -> TrainState:
        """``init`` from ``seed``, or with ``fill`` writing the weights
        into masters made without values."""
        cfg = self.model.cfg
        pdt = self.config.compute.param_dtype
        if self.mesh is not None:
            masters = self._shard(seed, pdt, empty=fill is not None)
        else:
            if self.model.device.type == "meta":
                self.model = (
                    init_params(cfg, seed=seed, device=self.device,
                                dtype=pdt) if fill is None
                    else TransformerLM(cfg, device="meta", dtype=pdt)
                    .to_empty(device=self.device).requires_grad_(False))
            masters = {}
            for name, p in list(self.model.named_parameters()):
                m = p.detach().to(pdt)
                masters[name] = m
                if not self._shadow_on:
                    _swap_param(self.model, name, nn.Parameter(m))
                    masters[name] = self.model.get_parameter(name)
        if fill is not None:
            with torch.no_grad():
                fill(masters)
        opt_state = self.optimizer.init(masters)
        if self._shadow_on:
            # the shadow IS the model's parameters: one bf16 copy, which
            # the optimizer refreshes in place
            shadow = shadow_params(opt_state)
            for name in list(shadow):
                _swap_param(self.model, name, shadow[name])
                shadow[name] = self.model.get_parameter(name)
        self.model.requires_grad_(True).train()
        if self.config.grad_accum > 1 or self._pp_on:
            for name, p in self.model.named_parameters():
                p.register_post_accumulate_grad_hook(
                    self._accumulate_hook(name))
        scaler = (scaler_init(device=self.device)
                  if self.config.compute.dtype == torch.float16 else None)
        # zero histories: "no observation yet", so the first quantized
        # step falls back to just-in-time scales
        self.state = TrainState(step=0, params=masters, opt_state=opt_state,
                                scaler=scaler,
                                quant=init_quant_state(cfg, self.device),
                                pp_size=self._pp_rank[0],
                                num_layers=cfg.num_layers)
        n = sum(p.numel() for p in masters.values())
        logger.info(f"initialised {n / 1e6:.1f}M params on {self.device}")
        return self.state

    def _shard(self, seed: Optional[int], pdt: torch.dtype,
               empty: bool = False) -> Dict[str, torch.Tensor]:
        """Shard the model over the mesh (a ``meta`` model's weights made
        block by block from ``seed``, the same on every rank, or, with
        ``empty``, given storage only); the masters are the sharded
        parameters themselves."""
        make = None
        if self.model.device.type == "meta":
            make = (materializer(seed, self.device) if not empty else
                    lambda module, prefix: module.to_empty(
                        device=self.device))
        else:
            for name, p in list(self.model.named_parameters()):
                if p.dtype != pdt:
                    _swap_param(self.model, name,
                                nn.Parameter(p.detach().to(pdt)))
        shard_model(self.model, self.mesh, self.config, make,
                    draws=not empty)
        return dict(self.model.named_parameters())

    # -- train step -----------------------------------------------------------
    def _batch(self, batch: Dict[str, Any], split: bool = False
               ) -> Dict[str, torch.Tensor]:
        """``batch`` on the device; with ``split`` (a train step) in the
        rows of JAX's micro-batches (:meth:`_jax_rows`); under context
        parallelism this rank's chunk of the sequence."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        if split:
            batch = self._jax_rows(batch)
        return self._seq_chunk(batch) if self._seq[0] > 1 else batch

    def _jax_rows(self, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """This rank's rows of each of JAX's micro-batches, in order.

        JAX cuts the global batch ``[B, ...]`` into ``U`` micro-batches
        of consecutive rows (``to_micro`` :646-651, then the pipeline's
        own split :1438-1453), each split over the data ranks, so rank
        ``r`` of ``S`` takes rows ``u B/U + [r B/(U S), (r+1) B/(U S))``
        of micro-batch ``u``; a rank is fed rows ``[r B/S, (r+1)
        B/S)``.  Where ``U`` and ``S`` are both above 1 the step's
        tensors are all-gathered over the data axes (integer ids,
        labels, positions and segment ids: a few hundred kilobytes) and
        those rows kept, in micro-batch order, so that the step's
        contiguous splits take JAX's rows: micro-batch ``i``'s amax, its
        mixture of experts' cap and drops, and its rows' dropout
        coordinates (``CPLayout.b_offset``) are JAX's.  The sum of the
        gradients is the same either way."""
        # grad_accum's split, then the pipeline's inside each (JAX's)
        units = self.config.grad_accum * (
            self.config.dist.pp.num_micro_batches if self._pp_on else 1)
        shards = self._data_shards
        if units == 1 or shards == 1:
            return batch
        keep = jax_micro_rows(batch["input_ids"].shape[0], units,
                              *data_shard(self.mesh)).to(self.device)
        sizes = describe_mesh(self.mesh)
        groups = [self.mesh.get_group(a) for a in DATA_AXES if sizes[a] > 1]
        out = {}
        for k, v in batch.items():
            if v.ndim:
                # the minor data axis first: the whole batch in rank order
                for group in reversed(groups):
                    parts = [torch.empty_like(v) for _ in range(
                        dist.get_world_size(group))]
                    dist.all_gather(parts, v.contiguous(), group=group)
                    v = torch.cat(parts)
                v = v.index_select(0, keep)
            out[k] = v
        return out

    def _seq_chunk(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """This rank's chunk of the sequence of every ``[b, s, ...]``
        field, with the labels and positions made on the whole rows
        first."""
        n, c = self._seq
        ids = batch["input_ids"]
        b, s = ids.shape[:2]
        if s % n:
            raise ValueError(f"sequence length {s} is not divisible by the "
                             f"{n} sequence ranks (dist.sp.size)")
        batch = dict(batch)
        if "labels" not in batch:
            batch["labels"] = shift_labels(ids, batch.get("segment_ids"))
        if "positions" not in batch:
            batch["positions"] = torch.arange(
                s, device=ids.device).expand(b, s)
        w = s // n
        return {k: v[:, c * w:(c + 1) * w].contiguous()
                if v.ndim >= 2 and v.shape[1] == s else v
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
        if self._pp_on:
            l_sum, count = self._pp_sum_count(
                batch, train, self.state.step if dropout_seed is None
                else dropout_seed)
            return l_sum, count, None
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
        """``(loss_sum, count)``, the sum with a mixture of experts'
        ``router_aux_weight * aux * count`` (JAX trainer.py :557-559;
        ``aux`` summed over the layers)."""
        w_aux = self._aux_weight
        if w_aux:
            kw = dict(kw, with_aux=True)
        if self._use_fused_ce:
            labels = batch.get("labels", shift_labels(
                batch["input_ids"], batch.get("segment_ids")))
            out = self.model(batch["input_ids"], labels=labels, **kw)
            (l_sum, count), aux = out if w_aux else (out, None)
        else:
            out = self.model(batch["input_ids"], **kw)
            logits, aux = out if w_aux else (out, None)
            res = self.loss(logits, batch)
            l_sum, count = res if isinstance(res, tuple) else (
                res, torch.ones((), dtype=torch.float32, device=self.device))
        if w_aux:
            l_sum = l_sum + w_aux * aux * count
        return l_sum, count

    def _pp_sum_count(self, batch, train: bool, dropout_seed: int,
                      scale: Optional[torch.Tensor] = None):
        """``(loss_sum, count)`` of ``batch`` through the pipeline (the
        last stage's; zeros on the others), and on a train step the
        gradients of ``loss_sum * scale`` on the parameters, attention
        dropout drawing with ``dropout_seed``."""
        labels = batch.get("labels", shift_labels(
            batch["input_ids"], batch.get("segment_ids")))
        l_sum, count = pp_forward_sum_count(
            self.model, self._pipeline_for(batch), batch, labels,
            dropout_seed=dropout_seed if train else None,
            use_fused_ce=self._use_fused_ce, custom_loss=self._custom_loss,
            train=train, scale=scale)
        as_t = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                         device=self.device)
        return as_t(l_sum), as_t(count)

    def _pipeline_for(self, batch) -> Pipeline:
        """The given pipeline, or this rank's stage of the mesh's over a
        process-group transport for ``batch``'s micro-batch shape."""
        if self._pipeline is not None:
            return self._pipeline
        pp, cfg = self.config.dist.pp, self.model.cfg
        b, s = batch["input_ids"].shape[:2]
        like = torch.empty((max(b // pp.num_micro_batches, 1), s,
                            cfg.hidden_size), dtype=cfg.dtype,
                           device=self.device)
        stage = self._pp_rank[1]
        transport = ProcessGroupTransport(pp_ranks(self.mesh), stage, like)
        if not self._pp_warm:
            transport.warm()
            self._pp_warm = True
        return Pipeline(pp.size, pp.num_micro_batches, pp.schedule,
                        pp.virtual_stages, stages=[stage],
                        transport=transport)

    def _pp_reduce(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the gradients of the parameters every stage holds (the
        embedding, the final norm, the head) over the 'pp' ranks, in
        place: the first stage's embedding and the last stage's head
        (both, under tied embeddings) meet there."""
        group = getattr(self.model, "pp_group", None)
        if group is None:
            return
        for name in sorted(grads):
            if not name.startswith("layers."):
                dist.all_reduce(to_local(grads[name]), group=group)

    def _norm_counted(self, grads: Dict[str, torch.Tensor]):
        """``update_``'s ``norm_counted``: the first sequence chunk's rank
        counts its gradients; over 'pp' each stage counts its blocks and
        the first stage the parameters every stage holds."""
        counted = self._seq[1] == 0
        if getattr(self.model, "pp_group", None) is None:
            return counted
        first = self._pp_rank[1] == 0
        return [counted and (first or n.startswith("layers."))
                for n in grads]

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
        """``(loss_sum, count)`` summed over the 'pp', data and sequence
        axes' ranks: the global batch's (as they are on one device)."""
        tot = torch.stack([l_sum.detach().float(), count.float()])
        pp_group = getattr(self.model, "pp_group", None)
        for group in ((() if pp_group is None else (pp_group,))
                      + tuple(getattr(self.model, "data_groups", ()))):
            dist.all_reduce(tot, group=group)
        return tot[0], tot[1]

    def _reduce_seq(self, grads: List[torch.Tensor]) -> None:
        """Sum the gradients' local tensors over the sequence ranks, in
        place: the tensors of one dtype flattened into buckets of at
        most ``_SEQ_BUCKET`` elements, one all-reduce a bucket over the
        sequence ranks, in the same order on every rank."""
        group = getattr(self.model, "seq_group", None)
        if group is None:
            return
        buckets: List[List[torch.Tensor]] = []
        size = 0
        for t in (to_local(g) for g in grads):
            if (not buckets or buckets[-1][0].dtype != t.dtype
                    or size + t.numel() > _SEQ_BUCKET):
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += t.numel()
        for same in buckets:
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.all_reduce(flat, group=group)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))

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
        params = dict(self.model.named_parameters())
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._reduce_seq([p.grad for p in params.values()])
        grads = {}
        for n, p in params.items():
            g = p.grad
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
                seed = self.state.step * accum + i
                if self._pp_on:
                    # the schedule back-propagates as it goes
                    l_sum, count = self._pp_sum_count(micro, True, seed,
                                                      scale)
                    new_quant = None
                else:
                    l_sum, count, new_quant = self._forward_sum_count(
                        micro, dropout_seed=seed, quant=quant)
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
        self._pp_reduce(acc)
        self._reduce_seq(list(acc.values()))
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
        batch = self._batch(batch, split=True)
        scaler = self.state.scaler
        scale = None if scaler is None else scaler["scale"]
        if self.config.grad_accum > 1 or self._pp_on:
            loss, grads, new_quant = self._grads_accumulated(batch, scale)
        else:
            loss, grads, new_quant = self._grads_one(batch, scale)
        finite = None if scaler is None else all_finite(grads.values())
        if new_quant is not None:
            # committed once, after the backward: a recompute has read
            # the histories its micro-batch started with.  A step the
            # fp16 scaler skips keeps the old ones (JAX :725-728): its
            # activations may be the non-finite values it skips
            self._check_quant(new_quant)
            if finite is not None:
                new_quant = {n: torch.where(finite, h, self.state.quant[n])
                             for n, h in new_quant.items()}
            self.state.quant = new_quant
        # the sequence ranks hold the same gradients: one counts them
        grad_norm = self.optimizer.update_(
            grads, self.state.opt_state, self.state.params, keep=finite,
            norm_counted=self._norm_counted(grads))
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

    # -- checkpoints ----------------------------------------------------------
    def save(self, path: str, blocking: bool = True):
        """A sharded checkpoint of the whole train state at ``path``
        (``checkpoint.save_checkpoint``).  ``blocking=False`` stages the
        state to host memory and writes in the background; call
        ``.wait()`` on the returned handle before relying on it."""
        if self.state is None:
            raise TrainerStateError(
                "nothing to save — call init() (or step) first")
        return save_checkpoint(path, self.state, blocking=blocking)

    def restore(self, path: str) -> TrainState:
        """Load the checkpoint at ``path`` into the train state, in place
        (its devices and layout; ``init`` first makes the state to load
        into when there is none), and make the bf16 shadow again."""
        if self.state is None:
            self.init()
        restore_checkpoint(path, self.state)
        self._after_restore()
        return self.state

    def swap_params(self, params: Dict[str, torch.Tensor], *,
                    reinit_opt: bool = True,
                    verify_shadow: bool = False) -> TrainState:
        """Replace the weights of an initialised trainer and everything
        made from them (``swap_params`` of the JAX Trainer, :333): the
        only safe way to load new weights.  Writing into
        ``state.params`` by hand leaves the bf16 shadow, which the
        forward reads, holding the old weights.

        ``params``: full tensors by the port's parameter names, of the
        masters' shapes and dtypes, written in place (this rank's shards
        on a mesh).  ``reinit_opt=True`` starts the optimizer state
        afresh (moments and count zero); ``False`` keeps it.  Either way
        the shadow is made again from the new masters, as ``restore``
        does.  ``verify_shadow=True`` then checks every shadow tensor
        against the cast of its master, bitwise, and raises if one
        differs.  The step, the fp16 scaler and the amax histories are
        kept."""
        if self.state is None:
            raise TrainerStateError(
                "swap_params needs an initialised trainer: call init(), "
                "init_from_params() or restore() first")
        live = self.state.params
        bad = [f"{n}: {params[n].dtype}, live {live[n].dtype}"
               for n in live
               if n in params and params[n].dtype != live[n].dtype]
        if bad:
            raise TrainerStateError(
                "swap_params: the new parameters' dtypes are not the live "
                "state's: " + "; ".join(bad[:8]))
        with torch.no_grad():
            _copy_named(live, params, self._pp_rank[0] > 1)
        if reinit_opt:
            if self._shadow_on:
                self.state.opt_state = (self.optimizer.inner.init(live),
                                        shadow_params(self.state.opt_state))
            else:
                self.state.opt_state = self.optimizer.init(live)
        self._after_restore()
        if verify_shadow and not self._shadow_consistent():
            raise AssertionError(
                "bf16 shadow != cast(params) after swap_params")
        return self.state

    def _shadow_consistent(self) -> bool:
        """Every shadow tensor equals the bf16 cast of its master,
        bitwise (true when there is no shadow)."""
        if not self._shadow_on or self.state is None:
            return True
        shadow = shadow_params(self.state.opt_state)
        return all(torch.equal(shadow[n], m.to(shadow[n].dtype))
                   for n, m in self.state.params.items())

    @torch.no_grad()
    def _after_restore(self) -> None:
        """The bf16 shadow is the cast of the masters: after a load into
        the masters, the forward must not read the old one."""
        if self._shadow_on:
            shadow = shadow_params(self.state.opt_state)
            for name, m in self.state.params.items():
                shadow[name].copy_(m)

    def _manager(self, checkpoint_dir: str,
                 checkpoint_every: int) -> CheckpointManager:
        res = self.config.resilience
        return CheckpointManager(
            checkpoint_dir, save_interval_steps=checkpoint_every,
            retry_policy=res.retry_policy(res.ckpt_retries),
            coord_timeout_s=res.coord_timeout_s,
            elastic_resume=res.elastic_resume)

    def _resume(self, mgr: CheckpointManager) -> int:
        """``fit(resume='auto')``'s restore: the step restored, or 0 when
        the directory holds nothing restorable."""
        try:
            _, step = mgr.restore_latest_valid(self.state)
        except CheckpointNotFoundError:
            logger.info("resume='auto': no checkpoint yet — starting fresh")
            return 0
        except CheckpointCorruptionError as e:
            # every step is unreadable (the run died in its very first
            # save): the restart must still start the run.  A failed
            # read leaves the state as it was (checkpoint/io.py).
            logger.warning(f"resume='auto': no restorable checkpoint ({e}); "
                           "starting fresh")
            return 0
        self._after_restore()
        counters.inc("resumes")
        return step

    # -- loop -----------------------------------------------------------------
    def fit(self, loader, *, max_steps: Optional[int] = None,
            eval_loader=None, eval_every: Optional[int] = None,
            log_every: int = 50, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1000, metrics_step_offset: int = 0,
            resume: Optional[str] = None) -> List[Dict[str, Any]]:
        """Run ``step`` over ``loader`` until ``max_steps`` steps have been
        taken, counting the steps a resume restored.  Returns a ``{step,
        loss, time_s, steps_per_sec, tokens_per_sec}`` record for every
        ``log_every``-th step; only those steps read the loss back to
        the host.  On a mesh ``loader`` yields this rank's rows,
        ``tokens_per_sec`` counts the global batch's and only rank 0
        logs.

        ``eval_loader`` (re-iterable) with ``eval_every``: after every
        ``eval_every``-th step but the first, ``eval_step`` runs over
        all of it and the step's record (made for that step if it is
        not a logging one) gets ``eval_loss``, the mean of its batches'
        losses; the next interval's rates leave the evaluation's time
        out.  ``metrics_step_offset`` is taken and has no effect: the
        JAX package shifts only its metrics files' steps by it, and the
        port writes no metrics files yet (ROADMAP A13).  The log lines
        name ``state.step``, as JAX's do.

        ``checkpoint_dir``: a ``CheckpointManager`` there saves the state
        after the steps ``should_save`` picks (each a multiple of
        ``checkpoint_every``, and the first when the directory is empty),
        labelled with the number of steps taken, with the loader's
        ``state_dict()`` beside it; it is closed (the last save's marker
        committed) on every exit.  ``resume='auto'`` (needs
        ``checkpoint_dir``) restores the newest valid step (commit-marked,
        digest matching this state, payload readable; falling back a step
        on corruption) and continues from there: the loader is
        repositioned from the step's ``loader_state.json`` through its
        ``load_state_dict``, else by ``skip_batches`` (or by consuming
        the batches).  An empty directory, or one whose every step is
        corrupt (with a warning), starts fresh; a state that drifted
        from the checkpoint's raises.  The port makes no emergency save
        on a preemption signal (ROADMAP A13)."""
        if self.state is None:
            self.init()
        if resume is not None and resume != "auto":
            raise ValueError(f"resume must be None or 'auto', got {resume!r}")
        if resume is not None and checkpoint_dir is None:
            raise TrainerStateError(
                "fit(resume='auto') requires checkpoint_dir")
        mgr = (None if checkpoint_dir is None
               else self._manager(checkpoint_dir, checkpoint_every))
        data_it = None
        try:
            start_step = 0 if resume is None else self._resume(mgr)
            data_it, bounded = self._data(loader, mgr, start_step, max_steps)
            loader_state = getattr(loader, "state_dict", None)
            history = []
            t0 = time.perf_counter()
            t_prev, s_prev = t0, self.state.step
            for step_idx, batch in enumerate(bounded, start=start_step):
                r = self.state.step
                m = self.step(batch)
                if mgr is not None:
                    mgr.save(step_idx + 1, self.state,
                             loader_state=loader_state)
                do_eval = bool(eval_loader is not None and eval_every
                               and r and r % eval_every == 0)
                if not (log_every and r % log_every == 0) and not do_eval:
                    continue
                loss = float(m["loss"])
                now = time.perf_counter()
                rec = {"step": r, "loss": loss,
                       "time_s": round(now - t0, 2)}
                if r > s_prev:
                    rec["steps_per_sec"] = round(
                        (r - s_prev) / max(now - t_prev, 1e-9), 3)
                    ids = batch["input_ids"]
                    rec["tokens_per_sec"] = round(
                        rec["steps_per_sec"] * ids.shape[0] * ids.shape[1]
                        * self._data_shards, 1)
                if do_eval:
                    # every batch queued first, then one read-back each
                    evs = [self.eval_step(eb)["loss"] for eb in eval_loader]
                    rec["eval_loss"] = (sum(float(v) for v in evs)
                                        / max(len(evs), 1))
                t_prev, s_prev = time.perf_counter(), r
                history.append(rec)
                if is_primary():
                    logger.info(
                        f"step {r}: loss {loss:.4f}"
                        + (f", eval_loss {rec['eval_loss']:.4f}"
                           if do_eval else ""))
            return history
        finally:
            # an early exit must stop the loader's producer thread now
            close = getattr(data_it, "close", None)
            if close is not None:
                close()
            if mgr is not None:
                mgr.close()

    def _data(self, loader, mgr, start_step: int, max_steps: Optional[int]):
        """(the loader's iterator, the batches this fit steps over): after
        a resume the loader is repositioned past the ``start_step``
        batches the restored state consumed."""
        left = None if max_steps is None else max(max_steps - start_step, 0)
        load = getattr(loader, "load_state_dict", None)
        loader_state = (mgr.read_loader_state(start_step)
                        if start_step and load is not None else None)
        skip = getattr(loader, "skip_batches", None)
        prefix = 0
        if loader_state is not None:
            # O(1): the loader seeks from its durable state
            load(loader_state)
            data_it = iter(loader)
        elif start_step and skip is not None:
            counters.inc("resume_replayed_batches", start_step)
            logger.warning(
                f"resume='auto': no durable loader state at step "
                f"{start_step} — replaying {start_step} consumed batches "
                "(skip-replay)")
            data_it = skip(start_step)
        else:
            data_it = iter(loader)
            if start_step:
                # no durable state and no skip support: the consumed
                # prefix is read and dropped
                counters.inc("resume_replayed_batches", start_step)
                prefix = start_step
        if start_step:
            logger.info(f"resume='auto': restored step {start_step}; "
                        + ("restoring durable loader state"
                           if loader_state is not None else
                           f"skipping {start_step} consumed batches"))
        stop = None if left is None else prefix + left
        return data_it, itertools.islice(data_it, prefix, stop)
