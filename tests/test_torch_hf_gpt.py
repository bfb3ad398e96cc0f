"""Hugging Face GPT-2, StarCoder2, GPT-NeoX, Nemotron, Phi, Phi-3
(packed ``qkv_proj``/``gate_up_proj``, partial rotary, longrope),
Cohere (interleaved RoPE, ``logit_scale``, a biasless shared norm, a
tied head), OLMo2 (post-norms, the flat qk-norm) and a yarn-scaled
Llama into the port (``models/hf.py``, ``models/hf_stream.py``) against
the JAX package's conversion and ``transformers``' own forward, on the
CPU.

Small HF models are built offline by ``transformers`` from configs
written here (hidden 64 with 4 heads, Phi's 160 with 2 heads of 80; 2
layers; vocab 256), with weights drawn from numpy seeds, and saved with
``save_pretrained``.  Held, for each family:

- ``config_from_hf`` field for field against JAX's, from the config
  object and from ``config.json`` as the port reads it;
- the converted weights bitwise JAX's ``params_from_hf_state_dict``
  (GPT-2's Conv1D layout with its packed q|k|v, GPT-NeoX's per-head
  packing, Phi's ``dense``/``fc1``/``fc2``/biased head);
- the logits of ``accelerate(checkpoint_dir)``'s weights against HF's
  forward and JAX's ``load_hf_model`` -> ``TransformerLM``, within 2e-5
  of the largest logit; the directory streams where JAX's plan streams
  it (StarCoder2, Nemotron) and goes through the materialising
  converter where JAX's does (GPT-2, GPT-NeoX, Phi); Phi-3's logits
  on both sides of longrope's switch (original context 16: 40 tokens
  and 12);
- the activation and tied-head refusals, with JAX's messages.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from torch_module_env import port_module_env
from test_torch_hf import _same_config
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models.hf import config_from_hf as jax_config_from_hf
from torchacc_tpu.models.hf import load_hf_model as jax_load_hf_model
from torchacc_tpu.models.hf import (
    params_from_hf_state_dict as jax_params_from_hf,
)
from torchacc_tpu.models.hf_stream import (
    streamable_names as jax_streamable_names,
)
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.models.convert import params_to_jax
from torchacc_tpu_torch.models.hf import (
    config_from_hf,
    params_from_hf_state_dict,
)
from torchacc_tpu_torch.models.hf_stream import (
    checkpoint_tensor_names,
    read_hf_config,
    streamable_names,
)
from torchacc_tpu_torch.train import accelerate

# the module (the package's ``accelerate`` name is the function)
accelerate_mod = importlib.import_module("torchacc_tpu_torch.train.accelerate")

LOGIT_TOL = 2e-5
_BASE = dict(vocab_size=256, hidden_size=64, num_attention_heads=4,
             num_hidden_layers=2, intermediate_size=128,
             max_position_embeddings=128)

# family: (config class, model class, config fields, streams)
FAMILIES = {
    "gpt2": (transformers.GPT2Config, transformers.GPT2LMHeadModel,
             dict(vocab_size=256, n_embd=64, n_head=4, n_layer=2,
                  n_positions=128), False),
    "starcoder2": (transformers.Starcoder2Config,
                   transformers.Starcoder2ForCausalLM,
                   dict(_BASE, num_key_value_heads=2), True),
    "gpt_neox": (transformers.GPTNeoXConfig, transformers.GPTNeoXForCausalLM,
                 dict(_BASE, rotary_pct=0.25), False),
    "nemotron": (transformers.NemotronConfig,
                 transformers.NemotronForCausalLM,
                 dict(_BASE, num_key_value_heads=2, head_dim=16), True),
    # Phi-2's heads of 80 and its 0.4 partial rotary at a small width
    "phi": (transformers.PhiConfig, transformers.PhiForCausalLM,
            dict(_BASE, hidden_size=160, num_attention_heads=2,
                 intermediate_size=256, partial_rotary_factor=0.4), False),
    # Phi-4-mini's partial rotary 0.75 (6 rotating pairs of d 16) and
    # Phi-3.5's longrope with seeded factors, the original context 16
    "phi3": (transformers.Phi3Config, transformers.Phi3ForCausalLM,
             dict(_BASE, num_key_value_heads=2, partial_rotary_factor=0.75,
                  pad_token_id=0,
                  original_max_position_embeddings=16,
                  rope_scaling=dict(
                      type="longrope",
                      short_factor=[1.0, 1.1, 1.25, 1.5, 1.75, 2.0],
                      long_factor=[1.5, 2.0, 3.0, 4.5, 6.0, 8.0])), True),
    "cohere": (transformers.CohereConfig, transformers.CohereForCausalLM,
               dict(_BASE, num_key_value_heads=2, logit_scale=0.0625),
               True),
    "olmo2": (transformers.Olmo2Config, transformers.Olmo2ForCausalLM,
              dict(_BASE, num_key_value_heads=2), True),
    "llama_yarn": (transformers.LlamaConfig, transformers.LlamaForCausalLM,
                   dict(_BASE, rope_scaling=dict(
                       rope_type="yarn", factor=4.0,
                       original_max_position_embeddings=32)), True),
}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


@torch.no_grad()
def hf_model(family, seed=0):
    """An HF causal LM of ``family`` in f32 with weights from a numpy
    seed: matrices and biases normal(0.05), norm scales 1 +
    normal(0.1)."""
    cfg_cls, model_cls, fields, _ = FAMILIES[family]
    model = model_cls(cfg_cls(**fields)).float().eval()
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        x = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        norm = ("norm" in name or ".ln_" in name) and name.endswith("weight")
        p.copy_(torch.from_numpy(1.0 + 0.1 * x if norm else 0.05 * x))
    return model


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_and_weights_match_jax(family, tmp_path):
    model = hf_model(family, seed=1)
    port = config_from_hf(model.config, dtype=torch.float32)
    _same_config(port, jax_config_from_hf(model.config, dtype=jnp.float32))
    model.config.save_pretrained(str(tmp_path))
    assert config_from_hf(read_hf_config(str(tmp_path)),
                          dtype=torch.float32) == port
    sd = model.state_dict()
    got = params_to_jax(port, params_from_hf_state_dict(sd, port))
    want = jax_params_from_hf(sd, jax_config_from_hf(model.config,
                                                      dtype=jnp.float32))
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_dir_logits_match_hf_and_jax(family, tmp_path,
                                                monkeypatch):
    model = hf_model(family, seed=2)
    path = str(tmp_path / "ckpt")
    model.save_pretrained(path, safe_serialization=True)
    names = checkpoint_tensor_names(path)
    streams = FAMILIES[family][3]
    assert streamable_names(names) == jax_streamable_names(names) == streams
    streamed = []
    real = accelerate_mod.stream_params
    monkeypatch.setattr(accelerate_mod, "stream_params",
                        lambda *a: streamed.append(1) or real(*a))
    trainer, _ = accelerate(path, None, tt.Config(
        compute=tt.ComputeConfig(dtype=torch.float32)), device="cpu")
    assert bool(streamed) == streams
    jcfg, jparams = jax_load_hf_model(model, dtype=jnp.float32)
    for n in (40, 12) if family == "phi3" else (40,):
        ids = np.random.default_rng(5).integers(0, 256, (2, n))
        with torch.no_grad():
            got = trainer.model(torch.from_numpy(ids)).numpy()
            hf = model(torch.from_numpy(ids)).logits.numpy()
        jl = np.asarray(JaxLM(jcfg).apply({"params": jparams},
                                          jnp.asarray(ids, jnp.int32)))
        scale = float(np.abs(hf).max())
        np.testing.assert_allclose(got, hf, rtol=0, atol=LOGIT_TOL * scale)
        np.testing.assert_allclose(got, jl, rtol=0, atol=LOGIT_TOL * scale)


@pytest.mark.parametrize("family,fields,match", [
    ("gpt2", dict(activation_function="relu"),
     "gpt2 activation_function 'relu' is not implemented"),
    ("starcoder2", dict(hidden_act="silu"),
     "starcoder2 hidden_act 'silu' is not implemented"),
    ("gpt_neox", dict(hidden_act="relu"),
     "gpt_neox hidden_act 'relu' is not implemented"),
    ("nemotron", dict(hidden_act="silu"),
     "nemotron hidden_act 'silu' is not implemented"),
    ("phi", dict(tie_word_embeddings=True),
     "phi with tie_word_embeddings=True is not supported"),
    ("cohere", dict(use_qk_norm=True),
     "cohere use_qk_norm=True .* is not implemented"),
    ("llama_yarn", dict(rope_scaling=dict(rope_type="yarn", factor=4.0,
                                          mscale=0.707)),
     "yarn mscale variants .* are not implemented")])
def test_refusals_match_jax(family, fields, match):
    cfg_cls, _, base, _ = FAMILIES[family]
    hc = cfg_cls(**{**base, **fields})
    for convert in (config_from_hf, jax_config_from_hf):
        with pytest.raises(NotImplementedError, match=match):
            convert(hc)
