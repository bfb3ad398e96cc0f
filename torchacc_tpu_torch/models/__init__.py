"""Model zoo of the port (the Llama family the serving and training
slices run) and Hugging Face Llama/Qwen2 ingestion."""

from torchacc_tpu_torch.models.convert import params_from_jax, params_to_jax
from torchacc_tpu_torch.models.generate import generate
from torchacc_tpu_torch.models.hf import (
    config_from_hf,
    load_hf_model,
    params_from_hf_state_dict,
)
from torchacc_tpu_torch.models.presets import PRESETS, get_preset
from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    TransformerLM,
    head_logits,
    init_params,
)

__all__ = ["ModelConfig", "TransformerLM", "head_logits", "init_params",
           "params_from_jax", "params_to_jax", "get_preset", "PRESETS",
           "generate", "config_from_hf", "load_hf_model",
           "params_from_hf_state_dict"]
