"""Hugging Face Gemma, Gemma2, Gemma3 (``gemma3_text``), Mistral and Qwen3
into the port (``models/hf.py``, ``models/hf_stream.py``) against the
JAX package's ingestion and against ``transformers``' own forward, on
the CPU.

Small HF models are built offline from configs written here (heads of
256 where the family has them, windows of 6 keys that the 40-token rows
outgrow, gemma3's linear rope scaling on its global layers), with
weights drawn from numpy seeds and saved as local safetensors; nothing
is downloaded.  Held: ``config_from_hf`` field for field against JAX's,
from the config object and from ``config.json`` as the port reads it
(gemma3's ``layer_types`` pattern and rope scaling included); the
converted weights bitwise JAX's ``params_from_hf_state_dict``;
``stream_params`` from the saved files equal to the state-dict
conversion (the sandwich norms' and q/k norms' names); the logits
against HF's forward (eager attention, which applies the softcaps) and
JAX's ``load_hf_model`` -> ``TransformerLM``, f32, within 2e-5 of the
largest logit (``tests/test_torch_hf.py``'s tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from torch_module_env import port_module_env
from test_torch_hf import LOGIT_TOL, _flat, _ids, _port_logits, _same_config
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models.hf import config_from_hf as jax_config_from_hf
from torchacc_tpu.models.hf import load_hf_model as jax_load_hf_model
from torchacc_tpu.models.hf import (
    params_from_hf_state_dict as jax_params_from_hf,
)
from torchacc_tpu_torch.models import TransformerLM
from torchacc_tpu_torch.models.convert import params_to_jax
from torchacc_tpu_torch.models.hf import (
    config_from_hf,
    load_hf_model,
    params_from_hf_state_dict,
)
from torchacc_tpu_torch.models.hf_stream import (
    read_hf_config,
    resolve_checkpoint_files,
    stream_params,
)

BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
            max_position_embeddings=512, rms_norm_eps=1e-6)
# name: (config class, model class, fields)
HF_CASES = {
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM,
              dict(head_dim=256)),
    "gemma2": (transformers.Gemma2Config, transformers.Gemma2ForCausalLM,
               dict(head_dim=256, sliding_window=6, query_pre_attn_scalar=128,
                    attn_logit_softcapping=5.0,
                    final_logit_softcapping=3.0)),
    "gemma3_text": (transformers.Gemma3TextConfig,
                    transformers.Gemma3ForCausalLM,
                    dict(head_dim=256, num_hidden_layers=4, sliding_window=6,
                         layer_types=["sliding_attention", "full_attention"]
                         * 2, rope_local_base_freq=10000.0,
                         rope_scaling=dict(rope_type="linear", factor=4.0))),
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM,
                dict(sliding_window=6, num_key_value_heads=2)),
    "qwen3": (transformers.Qwen3Config, transformers.Qwen3ForCausalLM,
              dict(head_dim=256)),
}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def hf_config(case):
    cls, _, fields = HF_CASES[case]
    cfg = cls(**{**BASE, **fields})
    cfg._attn_implementation = "eager"      # the softcaps, as HF advises
    return cfg


@torch.no_grad()
def hf_model(case, seed=0):
    """An HF causal LM of ``case`` in f32 with weights from a numpy seed:
    matrices normal(0.05), norm scales normal(0.1) about their init (0
    for Gemma's 1 + w norms, 1 for the others)."""
    cfg = hf_config(case)
    model = HF_CASES[case][1](cfg).float().eval()
    one = 0.0 if case.startswith("gemma") else 1.0
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        x = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        p.copy_(torch.from_numpy(one + 0.1 * x if "norm" in name
                                 else 0.05 * x))
    return model


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_config_from_hf_matches_jax_field_for_field(case, tmp_path):
    hc = hf_config(case)
    port = config_from_hf(hc, dtype=torch.float32)
    _same_config(port, jax_config_from_hf(hc, dtype=jnp.float32))
    hc.save_pretrained(str(tmp_path))
    assert config_from_hf(read_hf_config(str(tmp_path)),
                          dtype=torch.float32) == port
    want = {"gemma": dict(norm="rmsnorm1p", activation="geglu",
                          embed_scale=True, head_dim=256),
            "gemma2": dict(sandwich_norms=True, window=(5, -1),
                           layer_pattern=("sliding", "global"),
                           attn_logit_softcap=5.0, logit_softcap=3.0,
                           query_scale=128 ** -0.5),
            "gemma3_text": dict(qk_norm=True, window=(5, -1),
                                layer_pattern=("sliding", "global"),
                                rope_local_theta=10000.0, rope_scale=4.0),
            "mistral": dict(window=(5, -1), norm="rmsnorm"),
            "qwen3": dict(qk_norm=True, norm="rmsnorm", head_dim=256)}[case]
    for k, v in want.items():
        assert getattr(port, k) == v, k


def test_gemma3_pattern_from_older_configs_and_other_scalings():
    from torchacc_tpu_torch.models.hf import _pattern_from_layer_types
    assert _pattern_from_layer_types(None, sliding_window_pattern=6) == \
        ("sliding",) * 5 + ("global",)
    kinds = ["sliding_attention"] * 5 + ["full_attention"]
    assert _pattern_from_layer_types(kinds * 4 + kinds[:2]) == tuple(
        "sliding" if k.startswith("s") else "global"
        for k in kinds * 4 + kinds[:2])
    yarn = hf_config("gemma3_text")
    yarn.rope_scaling = dict(rope_type="yarn", factor=4.0)
    with pytest.raises(NotImplementedError, match="gemma3 rope_scaling"):
        config_from_hf(yarn)


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_converted_weights_are_bitwise_jax(case):
    model = hf_model(case, seed=1)
    sd = model.state_dict()
    cfg = config_from_hf(model.config, dtype=torch.float32)
    got = _flat(params_to_jax(cfg, params_from_hf_state_dict(sd, cfg)))
    want = _flat(jax_params_from_hf(sd, jax_config_from_hf(
        model.config, dtype=jnp.float32)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("case", ["gemma2", "gemma3_text", "qwen3"])
def test_stream_params_takes_the_new_norms(case, tmp_path):
    model = hf_model(case, seed=4)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = config_from_hf(read_hf_config(str(tmp_path)), dtype=torch.float32)
    dest = {n: torch.full_like(p, float("nan")) for n, p in
            TransformerLM(cfg, device="cpu").named_parameters()}
    stream_params(resolve_checkpoint_files(str(tmp_path)), cfg, dest)
    want = params_from_hf_state_dict(model.state_dict(), cfg)
    assert sorted(dest) == sorted(want)
    for n, t in dest.items():
        assert torch.equal(t, want[n]), n
    norms = {n for n in dest if n.startswith("layers.0.")
             and ("norm" in n or ".ln" in n)}
    assert norms == ({"layers.0.ln1.weight", "layers.0.ln2.weight"}
                     | ({"layers.0.ln1_post.weight",
                         "layers.0.ln2_post.weight"}
                        if cfg.sandwich_norms else set())
                     | ({"layers.0.attn.q_norm.weight",
                         "layers.0.attn.k_norm.weight"}
                        if cfg.qk_norm else set()))


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_logits_match_hf_and_jax(tmp_path, case):
    model = hf_model(case, seed=2)
    ids = _ids(5)
    model.save_pretrained(str(tmp_path / "ckpt"), safe_serialization=True)
    cfg, params = load_hf_model(str(tmp_path / "ckpt"), dtype=torch.float32)
    got = _port_logits(cfg, params, ids)
    with torch.no_grad():
        hf = model(torch.from_numpy(ids)).logits.numpy()
    jcfg, jparams = jax_load_hf_model(model, dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    jl = np.asarray(JaxLM(jcfg).apply({"params": jparams},
                                      jnp.asarray(ids, jnp.int32)))
    scale = float(np.abs(hf).max())
    np.testing.assert_allclose(got, hf, rtol=0, atol=LOGIT_TOL * scale)
    np.testing.assert_allclose(got, jl, rtol=0, atol=LOGIT_TOL * scale)
