"""torchacc_tpu_torch — the PyTorch/CUDA port of torchacc_tpu.

The JAX package ``torchacc_tpu`` is the reference; this package keeps
its module names so every counterpart is easy to find, and runs on an
NVIDIA Hopper card.  Every kernel that the JAX package wrote in Pallas
is written again by hand for ``sm_90a`` under ``csrc/`` and built with
``nvcc`` at first use (``ops/_build.py``).

This first slice is the serving path: ``serve.ServeEngine`` over a
paged KV cache, driving ``models.TransformerLM`` through
``serve.scheduler.PagedDecoder`` and the paged-attention kernel
(``ops.paged_attention``).  It imports torch, numpy and the standard
library only — never jax, flax or torchacc_tpu.
"""

__version__ = "0.1.0"

from torchacc_tpu_torch.config import Config, ServeConfig  # noqa: E402
from torchacc_tpu_torch.models import (  # noqa: E402
    ModelConfig,
    TransformerLM,
    get_preset,
    init_params,
)
from torchacc_tpu_torch.serve import (  # noqa: E402
    Request,
    RequestResult,
    ServeEngine,
)

__all__ = [
    "Config", "ServeConfig", "ModelConfig", "TransformerLM", "get_preset",
    "init_params", "Request", "RequestResult", "ServeEngine",
]
