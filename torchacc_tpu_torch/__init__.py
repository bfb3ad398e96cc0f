"""torchacc_tpu_torch — the PyTorch/CUDA port of torchacc_tpu.

The JAX package ``torchacc_tpu`` is the reference; this package keeps
its module names so every counterpart is easy to find, and runs on an
NVIDIA Hopper card.  Every kernel that the JAX package wrote in Pallas
is written again by hand for ``sm_90a`` under ``csrc/`` and built with
``nvcc`` at first use (``ops/_build.py``).

Three slices are ported.  Serving: ``serve.ServeEngine`` over a paged KV
cache, driving ``models.TransformerLM`` through
``serve.scheduler.PagedDecoder`` and the paged-attention kernel
(``ops.paged_attention``).  Training: ``train.accelerate`` ->
``train.Trainer`` (``step``/``fit``) over ``TransformerLM``'s forward,
with the flash-attention kernels forward and backward
(``ops.flash_attention``), the fused linear + CE head, selective remat
and AdamW over f32 masters with a bf16 compute shadow.  Quantized
training: ``compute.quant`` = 'int8' | 'fp8' runs the forward product of
the attention and MLP projections through the fused
quantize-matmul-dequantize kernel (``ops.quantized_matmul``) with
delayed scaling, its amax histories carried in ``TrainState.quant``.
The data feed and the rest of the step: ``accelerate(model, dataloader,
config)`` wraps the dataloader (``data.PackedDataset`` or any iterable
of dict batches) in a ``data.AsyncLoader`` that uploads through pinned
memory, and ``Trainer.fit`` runs gradient accumulation, fp16 with the
loss scaler and every remat policy, host offload included.
Parallelism: with a process group up (``parallel.initialize_distributed``)
``accelerate`` shards the model over the mesh of ``Config.dist``
(``parallel``): data parallelism, FSDP2 over 'dp' x 'fsdp', tensor
parallelism over heads, MLP and vocab, and expert parallelism over
'ep'.  Mixtures of experts (``models.moe``, Mixtral and Qwen3-MoE):
dense and capacity dispatch, their router loss in the Trainer's loss.
Checkpoints: ``checkpoint`` saves and restores the train state on
``torch.distributed.checkpoint`` with the JAX package's commit protocol,
and ``Trainer.fit(checkpoint_dir=..., resume='auto')`` resumes a run.
Hugging Face models: ``accelerate`` takes an HF Llama/Qwen2 model or a
local checkpoint directory (``models.hf``, ``models.hf_stream``: the
port reads ``config.json`` and safetensors itself),
``HFTrainerAdapter`` stands in for ``transformers.Trainer``, and
``ServeEngine.from_train_state`` serves the trained weights.
It imports
torch, numpy and the standard library only — never jax, flax,
torchacc_tpu, transformers or safetensors.
"""

__version__ = "0.4.0"

from torchacc_tpu_torch.config import (  # noqa: E402
    ComputeConfig,
    Config,
    ConfigError,
    DataConfig,
    DistConfig,
    DPConfig,
    EPConfig,
    FSDPConfig,
    MemoryConfig,
    PerfConfig,
    PPConfig,
    ResilienceConfig,
    ServeConfig,
    SPConfig,
    TPConfig,
)
from torchacc_tpu_torch.data import (  # noqa: E402
    AsyncLoader,
    PackedDataset,
    pack_sequences,
)
from torchacc_tpu_torch.models import (  # noqa: E402
    ModelConfig,
    TransformerLM,
    config_from_hf,
    get_preset,
    init_params,
    load_hf_model,
)
from torchacc_tpu_torch.serve import (  # noqa: E402
    Request,
    RequestResult,
    ServeEngine,
)

from torchacc_tpu_torch.train import (  # noqa: E402
    HFTrainerAdapter,
    Trainer,
    accelerate,
)

__all__ = [
    "Config", "ConfigError", "ServeConfig", "ComputeConfig", "MemoryConfig",
    "DataConfig", "DistConfig", "DPConfig", "TPConfig", "FSDPConfig",
    "PPConfig", "SPConfig", "EPConfig", "ResilienceConfig", "PerfConfig",
    "AsyncLoader", "PackedDataset",
    "pack_sequences", "ModelConfig", "TransformerLM", "get_preset",
    "init_params", "Request", "RequestResult", "ServeEngine", "Trainer", "accelerate",
    "load_hf_model", "config_from_hf", "HFTrainerAdapter",
]
