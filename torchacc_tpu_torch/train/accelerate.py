"""``accelerate()`` — the one-call entry point (the port of
torchacc_tpu/train/accelerate.py ``accelerate``, :68, and
``apply_config_to_model``, :31).

It validates the config, folds its compute and memory settings into the
model config, builds the ``Trainer`` and wraps a dataloader in an
``AsyncLoader`` on the trainer's device.  It takes a ``ModelConfig``
(the model is made by ``Trainer.init`` from ``config.seed``) or a port
``TransformerLM`` (its weights are trained).  Hugging Face models and
checkpoints wait for the model-breadth slice (ROADMAP A10) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Tuple, Union

import torch

from torchacc_tpu_torch.config import Config
from torchacc_tpu_torch.data.async_loader import AsyncLoader
from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    TransformerLM,
    set_model_config,
)
from torchacc_tpu_torch.train.schedules import GradientTransformation
from torchacc_tpu_torch.train.trainer import Trainer
from torchacc_tpu_torch.utils.remat import offload_is_live


def apply_config_to_model(mc: ModelConfig, config: Config) -> ModelConfig:
    """Fold the framework's compute and memory settings into the model
    config (the fields this port implements): ``offload_activations``
    forces the host-offload remat policy, ``gc_cls``/``gc_cnt`` pick the
    submodules and the number of layers that remat."""
    mem = config.memory
    return dataclasses.replace(
        mc,
        dtype=config.compute.dtype,
        param_dtype=config.compute.param_dtype,
        attention_impl=config.compute.attention_impl,
        remat=mem.gc or mem.offload_activations,
        remat_policy=("offload_dots" if offload_is_live(mem)
                      else mem.gc_policy),
        remat_cls=tuple(mem.gc_cls) if mem.gc_cls else None,
        remat_cnt=mem.gc_cnt,
        quant=config.compute.quant,
        quant_sites=tuple(config.compute.quant_sites),
        quant_amax_history_len=config.compute.quant_amax_history_len,
        quant_impl=config.compute.quant_impl,
    )


def accelerate(
    model: Any,
    dataloader: Optional[Iterable] = None,
    config: Optional[Config] = None,
    optimizer: Optional[GradientTransformation] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
    **trainer_kwargs,
) -> Tuple[Trainer, Optional[AsyncLoader]]:
    """Returns ``(trainer, loader)``: ``loader`` is ``dataloader`` (any
    iterable of dict batches, e.g. a ``PackedDataset``) wrapped in an
    ``AsyncLoader`` that uploads to the trainer's device, or None
    without one; give it to ``trainer.fit``.  A ``ModelConfig``'s model
    is made on ``device`` (None = the card); a ``TransformerLM`` trains
    where it lies."""
    config = config or Config()
    config.validate()
    if config.compute.matmul_precision != "default":
        torch.set_float32_matmul_precision(config.compute.matmul_precision)
    if isinstance(model, ModelConfig):
        model = TransformerLM(apply_config_to_model(model, config),
                              device="meta")
    elif isinstance(model, TransformerLM):
        set_model_config(model, apply_config_to_model(model.cfg, config))
    else:
        raise NotImplementedError(
            f"accelerate() takes a ModelConfig or a torchacc_tpu_torch "
            f"TransformerLM; {type(model).__name__} (Hugging Face models "
            f"and checkpoints) waits for the model-breadth slice "
            f"(ROADMAP A10)")
    trainer = Trainer(model, config, optimizer=optimizer, device=device,
                      **trainer_kwargs)
    loader = (None if dataloader is None else
              AsyncLoader(dataloader, config, device=trainer.device))
    return trainer, loader
