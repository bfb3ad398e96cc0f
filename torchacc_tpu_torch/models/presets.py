"""Model presets (torchacc_tpu/models/presets.py, the Llama family that
the serving slice supports)."""

from __future__ import annotations

from torchacc_tpu_torch.models.transformer import ModelConfig


def llama_tiny(**kw) -> ModelConfig:
    defaults = dict(vocab_size=32000, hidden_size=256, num_layers=4,
                    num_heads=8, num_kv_heads=4, intermediate_size=688,
                    max_seq_len=2048)
    defaults.update(kw)
    return ModelConfig(**defaults)


def llama3_8b(**kw) -> ModelConfig:
    defaults = dict(vocab_size=128256, hidden_size=4096, num_layers=32,
                    num_heads=32, num_kv_heads=8, intermediate_size=14336,
                    max_seq_len=8192, rope_theta=500000.0)
    defaults.update(kw)
    return ModelConfig(**defaults)


PRESETS = {
    "llama-tiny": llama_tiny,
    "llama3-8b": llama3_8b,
}


def get_preset(name: str, **kw) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**kw)
