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
``config.seed``), a port ``TransformerLM`` (its weights are trained),
or a Hugging Face Llama/Qwen2 model (``models/hf.py``): an object with
``.config`` and ``.state_dict()``, or a local checkpoint directory.
The HF config becomes the model config (``config_from_hf``, with
``dtype``/``param_dtype`` from ``config.compute``), the model is made on
``meta`` and the trainer comes back initialised from the HF weights
(``Trainer.init_from_params``): a directory's safetensors are copied
one tensor at a time from the mapped files into the masters, or this
rank's shards of them (``hf_stream.stream_params``, :79-153 of the JAX
file); ``pytorch_model*.bin`` files are read with ``torch.load``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist

from torchacc_tpu_torch.config import Config, ConfigError
from torchacc_tpu_torch.data.async_loader import AsyncLoader
from torchacc_tpu_torch.data.dataset import PackedDataset
from torchacc_tpu_torch.models.hf import (
    check_local_dir,
    config_from_hf,
    load_hf_model,
)
from torchacc_tpu_torch.models.hf_stream import (
    checkpoint_tensor_names,
    read_hf_config,
    resolve_checkpoint_files,
    stream_params,
    streamable_names,
)
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
    submodules and the number of layers that remat, ``dist.sp.size``
    above 1 turns on ``context_parallel``, ``dist.pp`` gives the
    pipeline's stages, micro-batches and chunks,
    ``perf.overlap_fsdp`` sets ``overlap_fsdp`` (which the training
    check refuses, ROADMAP.md A8b), and ``dist.ep.capacity_factor``
    becomes a mixture of experts' ``moe_capacity_factor`` unless the
    model config sets its own (JAX :62-64)."""
    mem = config.memory
    cf = mc.moe_capacity_factor
    if (config.dist.ep.capacity_factor is not None
            and mc.num_experts > 0 and cf is None):
        cf = config.dist.ep.capacity_factor
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
        context_parallel=config.dist.sp.size > 1,
        pp_size=config.dist.pp.size,
        pp_num_micro=config.dist.pp.num_micro_batches,
        pp_virtual=config.dist.pp.virtual_stages,
        overlap_fsdp=mc.overlap_fsdp or config.perf.overlap_fsdp,
        moe_capacity_factor=cf,
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
    without one; give it to ``trainer.fit``.  A ``ModelConfig``'s model,
    and a Hugging Face model's, is made on ``device`` (None = the card);
    a ``TransformerLM`` trains where it lies."""
    config = config or Config()
    config.validate()
    d = config.dist
    # a given pipeline (every stage in this process) needs no group
    pp_ranks = 1 if trainer_kwargs.get("pipeline") is not None \
        else d.pp.size
    if not dist.is_initialized() and max(d.dp.size, 1) * d.tp.size \
            * d.fsdp.size * d.sp.size * d.ep.size * pp_ranks > 1:
        raise ConfigError(
            "config.dist asks for more than one rank but no "
            "torch.distributed process group is up: call "
            "parallel.initialize_distributed() first (ROADMAP.md A8)")
    if config.compute.matmul_precision != "default":
        torch.set_float32_matmul_precision(config.compute.matmul_precision)
    hf_params = None
    if isinstance(model, (str, os.PathLike)) or (
            hasattr(model, "state_dict")
            and not isinstance(model, TransformerLM)):
        model, hf_params = _hf_source(model, config)
    if isinstance(model, ModelConfig):
        model = TransformerLM(apply_config_to_model(model, config),
                              device="meta")
    elif isinstance(model, TransformerLM):
        set_model_config(model, apply_config_to_model(model.cfg, config))
    else:
        raise TypeError(
            f"accelerate() takes a ModelConfig, a torchacc_tpu_torch "
            f"TransformerLM, a Hugging Face model or a local Hugging Face "
            f"checkpoint directory; got {type(model).__name__}")
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
    if hf_params is not None:
        trainer.init_from_params(hf_params)
    loader = (None if dataloader is None else
              AsyncLoader(dataloader, config, device=trainer.device))
    return trainer, loader


def _hf_source(model: Any, config: Config):
    """(the ``ModelConfig`` of a Hugging Face model or checkpoint
    directory, what ``Trainer.init_from_params`` takes for its
    weights): a directory's safetensors in the plan's layout are
    streamed, every other input (GPT-2's, GPT-NeoX's and Phi's
    checkpoints among them, as in JAX) is converted by
    ``load_hf_model``."""
    dtypes = dict(dtype=config.compute.dtype,
                  param_dtype=config.compute.param_dtype)
    if isinstance(model, (str, os.PathLike)):
        path = os.fspath(model)
        check_local_dir(path)
        files = resolve_checkpoint_files(path)
        if files is not None and streamable_names(
                checkpoint_tensor_names(path)):
            mc = config_from_hf(read_hf_config(path), **dtypes)
            return mc, functools.partial(stream_params, files, mc)
    return load_hf_model(model, **dtypes)
