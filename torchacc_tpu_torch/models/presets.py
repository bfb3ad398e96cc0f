"""Model presets (torchacc_tpu/models/presets.py, field for field: GPT-2,
Llama, Qwen2, Gemma and Mixtral, every preset of the JAX package)."""

from __future__ import annotations

from torchacc_tpu_torch.models.transformer import ModelConfig


def gpt2_tiny(**kw) -> ModelConfig:
    """The reference's tiny-GPT benchmark model (its
    benchmarks/transformer.py)."""
    defaults = dict(vocab_size=50257, hidden_size=256, num_layers=4,
                    num_heads=8, max_seq_len=512, pos_emb="learned",
                    norm="layernorm", activation="gelu",
                    tie_embeddings=True, rope_theta=10000.0)
    defaults.update(kw)
    return ModelConfig(**defaults)


def gpt2(**kw) -> ModelConfig:
    defaults = dict(vocab_size=50257, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=1024, pos_emb="learned",
                    norm="layernorm", activation="gelu",
                    tie_embeddings=True, rope_theta=10000.0)
    defaults.update(kw)
    return ModelConfig(**defaults)


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


def llama3_70b(**kw) -> ModelConfig:
    defaults = dict(vocab_size=128256, hidden_size=8192, num_layers=80,
                    num_heads=64, num_kv_heads=8, intermediate_size=28672,
                    max_seq_len=8192, rope_theta=500000.0)
    defaults.update(kw)
    return ModelConfig(**defaults)


def qwen2_7b(**kw) -> ModelConfig:
    defaults = dict(vocab_size=152064, hidden_size=3584, num_layers=28,
                    num_heads=28, num_kv_heads=4, intermediate_size=18944,
                    max_seq_len=32768, qkv_bias=True, rope_theta=1000000.0)
    defaults.update(kw)
    return ModelConfig(**defaults)


def gemma_2b(**kw) -> ModelConfig:
    defaults = dict(vocab_size=256000, hidden_size=2048, num_layers=18,
                    num_heads=8, num_kv_heads=1, head_dim=256,
                    intermediate_size=16384, max_seq_len=8192,
                    rope_theta=10000.0, norm="rmsnorm1p",
                    activation="geglu", embed_scale=True,
                    tie_embeddings=True, norm_eps=1e-6)
    defaults.update(kw)
    return ModelConfig(**defaults)


def gemma_7b(**kw) -> ModelConfig:
    defaults = dict(vocab_size=256000, hidden_size=3072, num_layers=28,
                    num_heads=16, num_kv_heads=16, head_dim=256,
                    intermediate_size=24576, max_seq_len=8192,
                    rope_theta=10000.0, norm="rmsnorm1p",
                    activation="geglu", embed_scale=True,
                    tie_embeddings=True, norm_eps=1e-6)
    defaults.update(kw)
    return ModelConfig(**defaults)


def gemma2_2b(**kw) -> ModelConfig:
    # HF google/gemma-2-2b config.json (sandwich norms, alternating
    # sliding/global attention, score + logit soft-capping, fixed query
    # scale query_pre_attn_scalar=256)
    defaults = dict(vocab_size=256000, hidden_size=2304, num_layers=26,
                    num_heads=8, num_kv_heads=4, head_dim=256,
                    intermediate_size=9216, max_seq_len=8192,
                    rope_theta=10000.0, norm="rmsnorm1p",
                    activation="geglu", embed_scale=True,
                    tie_embeddings=True, norm_eps=1e-6, sandwich_norms=True,
                    layer_pattern=("sliding", "global"), window=(4095, -1),
                    attn_logit_softcap=50.0, logit_softcap=30.0,
                    query_scale=256.0 ** -0.5)
    defaults.update(kw)
    return ModelConfig(**defaults)


def gemma3_1b(**kw) -> ModelConfig:
    # HF google/gemma-3-1b-pt config.json (5:1 sliding/global pattern,
    # dual rope bases, qk-norm; no soft-capping)
    defaults = dict(vocab_size=262144, hidden_size=1152, num_layers=26,
                    num_heads=4, num_kv_heads=1, head_dim=256,
                    intermediate_size=6912, max_seq_len=32768,
                    rope_theta=1000000.0, rope_local_theta=10000.0,
                    norm="rmsnorm1p", activation="geglu", embed_scale=True,
                    tie_embeddings=True, norm_eps=1e-6, sandwich_norms=True,
                    qk_norm=True, layer_pattern=("sliding",) * 5 + ("global",),
                    window=(511, -1), query_scale=256.0 ** -0.5)
    defaults.update(kw)
    return ModelConfig(**defaults)


def mixtral_8x7b(**kw) -> ModelConfig:
    defaults = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                    num_heads=32, num_kv_heads=8, intermediate_size=14336,
                    max_seq_len=32768, rope_theta=1000000.0, num_experts=8,
                    num_experts_per_tok=2)
    defaults.update(kw)
    return ModelConfig(**defaults)


PRESETS = {
    "gpt2-tiny": gpt2_tiny,
    "gpt2": gpt2,
    "llama-tiny": llama_tiny,
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "qwen2-7b": qwen2_7b,
    "gemma-2b": gemma_2b,
    "gemma-7b": gemma_7b,
    "gemma2-2b": gemma2_2b,
    "gemma3-1b": gemma3_1b,
    "mixtral-8x7b": mixtral_8x7b,
}


def get_preset(name: str, **kw) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**kw)
