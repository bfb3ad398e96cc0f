"""``accelerate()`` — the one-call entry point (the port of
torchacc_tpu/train/accelerate.py ``accelerate``, :68, and
``apply_config_to_model``, :31).

It validates the config, folds its compute and memory settings into the
model config, builds the ``Trainer`` and wraps a dataloader in an
``AsyncLoader`` on the trainer's device.  When a ``torch.distributed``
process group is up (``parallel.initialize_distributed``), the trainer
gets the mesh of ``config.dist`` (``Config.get_mesh``) and shards the
model over it; the dataloader then yields this rank's rows
(``parallel.mesh.data_shard``): a ``PackedDataset`` cut for other
shards raises.  Without one the trainer runs on one
device, and a ``dist`` that asks for more than one rank raises.  It
takes a ``ModelConfig`` (the model is made by ``Trainer.init`` from
``config.seed``) or a port ``TransformerLM`` (its weights are
trained).  Hugging Face models and
checkpoints wait for the model-breadth slice (ROADMAP A10) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist

from torchacc_tpu_torch.config import Config, ConfigError
from torchacc_tpu_torch.data.async_loader import AsyncLoader
from torchacc_tpu_torch.data.dataset import PackedDataset
from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    TransformerLM,
    set_model_config,
)
from torchacc_tpu_torch.ops._common import resolve_device
from torchacc_tpu_torch.parallel.mesh import data_shard
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
    d = config.dist
    if not dist.is_initialized() and max(d.dp.size, 1) * d.tp.size \
            * d.fsdp.size > 1:
        raise ConfigError(
            "config.dist asks for more than one rank but no "
            "torch.distributed process group is up: call "
            "parallel.initialize_distributed() first (ROADMAP.md A8)")
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
    mesh = None
    if dist.is_initialized():
        dev = (resolve_device(device) if model.device.type == "meta"
               else model.device)
        mesh = config.get_mesh(dev.type)
        if isinstance(dataloader, PackedDataset):
            got = (dataloader.num_shards, dataloader.shard_index)
            want = data_shard(mesh)
            if got != want:
                raise ConfigError(
                    f"the PackedDataset yields shard {got[1]} of {got[0]}, "
                    f"this rank's rows are shard {want[1]} of {want[0]}: "
                    f"make it with (num_shards, shard_index) = "
                    f"parallel.data_shard(mesh) (ROADMAP.md A8)")
    trainer = Trainer(model, config, optimizer=optimizer, device=device,
                      mesh=mesh, **trainer_kwargs)
    loader = (None if dataloader is None else
              AsyncLoader(dataloader, config, device=trainer.device))
    return trainer, loader
