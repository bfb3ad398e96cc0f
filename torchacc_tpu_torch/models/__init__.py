"""Model zoo of the port (the Llama family the serving slice runs)."""

from torchacc_tpu_torch.models.convert import params_from_jax
from torchacc_tpu_torch.models.presets import PRESETS, get_preset
from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    TransformerLM,
    head_logits,
    init_params,
)

__all__ = ["ModelConfig", "TransformerLM", "head_logits", "init_params",
           "params_from_jax", "get_preset", "PRESETS"]
