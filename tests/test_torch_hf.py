"""Hugging Face Llama/Qwen2 and Mixtral/Qwen3-MoE ingestion of the port
(``models/hf.py``, ``models/hf_stream.py``) against the JAX package's
and against ``transformers`` and ``safetensors``, on the CPU.

Small HF models are built offline from configs written here, with
weights drawn from numpy seeds, and saved with ``save_pretrained``.
Held: ``config_from_hf`` field for field against JAX's (from the config
object and from ``config.json`` as the port reads it); the port's
safetensors reader bitwise ``safetensors.safe_open``; the converted
weights bitwise JAX's ``params_from_hf_state_dict``; the logits against
HF's own forward and JAX's ``load_hf_model`` -> ``TransformerLM``, f32,
within 2e-5 of the largest logit (read <= 1.2e-6: the same f32 math in
other orders); a mixture of experts' checkpoint streamed
(``stream_params``, each expert's tensor into its row of the stacked
parameter) bitwise as it is materialised; and what raises by name.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors import safe_open
from safetensors.torch import save_file

from torch_module_env import port_module_env
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
    SafetensorsFile,
    checkpoint_tensor_names,
    read_hf_config,
    resolve_checkpoint_files,
    stream_params,
)

LOGIT_TOL = 2e-5

# the HF configs held here: head dims 128 and 64, llama3 rope, the o and
# mlp biases, qwen2's qkv bias, tied and untied heads
HF_CASES = {
    "llama_d128": ("llama", dict(hidden_size=256, num_attention_heads=2,
                                 num_key_value_heads=1)),
    "llama31_rope_d64": ("llama", dict(
        hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
        rope_theta=500000.0, rope_scaling=dict(
            rope_type="llama3", factor=32.0, low_freq_factor=1.0,
            high_freq_factor=4.0, original_max_position_embeddings=64))),
    "llama_o_mlp_bias_d64": ("llama", dict(
        hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
        attention_bias=True, mlp_bias=True)),
    # Llama-3.2-1B's shape at a small width: head dim 64, 4 q heads a kv
    # head, llama3 rope, tied embeddings
    "llama32_tied_d64": ("llama", dict(
        hidden_size=256, num_attention_heads=4, num_key_value_heads=1,
        head_dim=64, tie_word_embeddings=True, rope_theta=500000.0,
        rope_scaling=dict(rope_type="llama3", factor=32.0,
                          low_freq_factor=1.0, high_freq_factor=4.0,
                          original_max_position_embeddings=64))),
    "qwen2_d128": ("qwen2", dict(hidden_size=256, num_attention_heads=2,
                                 num_key_value_heads=2, rope_theta=1e6)),
    # the mixtures of experts: Mixtral's block_sparse_moe (softmax, top-k,
    # renormalised), Qwen3-MoE's mlp.experts with norm_topk_prob both ways
    "mixtral_d64": ("mixtral", dict(hidden_size=128, num_attention_heads=2,
                                    num_key_value_heads=1,
                                    num_local_experts=4,
                                    num_experts_per_tok=2)),
    "qwen3_moe_d64": ("qwen3_moe", dict(
        hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
        head_dim=64, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=96, norm_topk_prob=False)),
    "qwen3_moe_d64_norm_topk": ("qwen3_moe", dict(
        hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
        head_dim=64, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=96, norm_topk_prob=True)),
}
MOE_CASES = ("mixtral_d64", "qwen3_moe_d64", "qwen3_moe_d64_norm_topk")
_FAMILIES = {  # model_type: (config class, causal LM class)
    "llama": ("LlamaConfig", "LlamaForCausalLM"),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM"),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM"),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM"),
}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def hf_config(case, **kw):
    family, extra = HF_CASES[case]
    cls = getattr(transformers, _FAMILIES[family][0])
    base = dict(vocab_size=256, intermediate_size=384, num_hidden_layers=2,
                max_position_embeddings=512, rms_norm_eps=1e-5)
    return cls(**{**base, **extra, **kw})


@torch.no_grad()
def hf_model(case, seed=0, **kw):
    """An HF causal LM of ``case`` in f32 with weights from a numpy seed:
    matrices and biases normal(0.05), norm scales 1 + normal(0.1)."""
    cfg = hf_config(case, **kw)
    model = getattr(transformers, _FAMILIES[cfg.model_type][1])(
        cfg).float().eval()
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        x = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        p.copy_(torch.from_numpy(1.0 + 0.1 * x if "norm" in name
                                 else 0.05 * x))
    return model


def saved(model, path, dtype=torch.float32, shard=None):
    """``model`` saved at ``path`` with ``save_pretrained`` in ``dtype``
    (``shard``: a max shard size, giving an index and several files)."""
    m = model.to(dtype)
    kw = {} if shard is None else dict(max_shard_size=shard)
    m.save_pretrained(str(path), safe_serialization=True, **kw)
    model.float()
    return str(path)


def _ids(seed, b=2, s=40, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _same_config(port, jcfg):
    for f in dataclasses.fields(jcfg):
        jv, pv = getattr(jcfg, f.name), getattr(port, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert jnp.dtype(jv).name == str(pv).split(".")[-1], f.name
        else:
            assert pv == jv, (f.name, pv, jv)


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_config_from_hf_matches_jax_field_for_field(case, tmp_path):
    hc = hf_config(case)
    port = config_from_hf(hc, dtype=torch.float32)
    _same_config(port, jax_config_from_hf(hc, dtype=jnp.float32))
    # the same from config.json as the port reads it
    hc.save_pretrained(str(tmp_path))
    assert config_from_hf(read_hf_config(str(tmp_path)),
                          dtype=torch.float32) == port
    d = 64 if "d64" in case else 128
    assert port.head_size == d


def test_unsupported_families_and_rope_types_raise_by_name():
    small = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=1, num_attention_heads=2)
    # Phi-3, Cohere and yarn convert now (tests/test_torch_hf_gpt.py),
    # and so do Qwen3-MoE and Mixtral (the cases above); the other
    # mixtures of experts raise by name, and a rope type neither
    # package implements raises in both
    assert config_from_hf(transformers.Qwen3MoeConfig(**small)) \
        .num_experts == 128
    assert config_from_hf(transformers.MixtralConfig(**small)) \
        .num_experts == 8
    with pytest.raises(NotImplementedError,
                       match="'olmoe'.*mixtral and qwen3_moe"):
        config_from_hf(transformers.OlmoeConfig(**small))
    dyn = transformers.LlamaConfig(**small, rope_scaling=dict(
        rope_type="dynamic", factor=4.0))
    for convert in (config_from_hf, jax_config_from_hf):
        with pytest.raises(NotImplementedError,
                           match="rope_scaling type 'dynamic' is not "
                                 "implemented"):
            convert(dyn)
    # a sliding window converts now, as JAX converts it: sliding_window
    # keys, so a left window of one less
    sliding = transformers.Qwen2Config(**small, use_sliding_window=True,
                                       sliding_window=32)
    assert config_from_hf(sliding).window == (31, -1) == \
        jax_config_from_hf(sliding).window


def _safe_open_tensors(path):
    with safe_open(path, framework="pt") as f:
        return list(f.keys()), {n: f.get_tensor(n) for n in f.keys()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("layout", ["single", "sharded", "tied"])
def test_safetensors_reader_is_bitwise_safe_open(tmp_path, layout, dtype):
    case = "llama32_tied_d64" if layout == "tied" else "llama_o_mlp_bias_d64"
    path = saved(hf_model(case, seed=3), tmp_path, dtype,
                 shard="300KB" if layout == "sharded" else None)
    files = resolve_checkpoint_files(path)
    assert len(files) > 1 if layout == "sharded" else len(files) == 1
    names = []
    for fpath in files:
        keys, want = _safe_open_tensors(fpath)
        with SafetensorsFile(fpath) as f:
            assert sorted(f.keys()) == sorted(keys)
            for n in keys:
                got = f.get_tensor(n)
                assert got.dtype == want[n].dtype == dtype, n
                assert f.shape(n) == tuple(want[n].shape)
                assert torch.equal(got.view(torch.uint8),
                                   want[n].contiguous().view(torch.uint8)), n
        names += keys
    assert sorted(checkpoint_tensor_names(path)) == sorted(names)
    if layout == "tied":
        assert "lm_head.weight" not in names


def test_reader_refuses_other_dtypes_by_name(tmp_path):
    path = str(tmp_path / "x.safetensors")
    save_file({"a": torch.zeros(3, dtype=torch.float32),
               "b": torch.zeros(2, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        SafetensorsFile(path)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


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


def _port_logits(cfg, params, ids):
    model = TransformerLM(cfg, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
        return model(torch.from_numpy(ids)).numpy()


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_logits_match_hf_and_jax(tmp_path, case):
    model = hf_model(case, seed=2)
    ids = _ids(5)
    cfg, params = load_hf_model(saved(model, tmp_path / "ckpt", shard=(
        "400KB" if case == "qwen2_d128" else None)), dtype=torch.float32)
    got = _port_logits(cfg, params, ids)
    with torch.no_grad():
        hf = model(torch.from_numpy(ids)).logits.numpy()
    jcfg, jparams = jax_load_hf_model(model, dtype=jnp.float32)
    jl = np.asarray(JaxLM(jcfg).apply({"params": jparams},
                                      jnp.asarray(ids, jnp.int32)))
    scale = float(np.abs(hf).max())
    np.testing.assert_allclose(got, hf, rtol=0, atol=LOGIT_TOL * scale)
    np.testing.assert_allclose(got, jl, rtol=0, atol=LOGIT_TOL * scale)


def test_stream_params_fills_in_place_and_checks_the_checkpoint(tmp_path):
    model = hf_model("llama_o_mlp_bias_d64", seed=4)
    path = saved(model, tmp_path / "ok", torch.bfloat16, shard="300KB")
    cfg = config_from_hf(read_hf_config(path), dtype=torch.float32)
    dest = {n: torch.full_like(p, float("nan")) for n, p in
            TransformerLM(cfg, device="cpu").named_parameters()}
    stream_params(resolve_checkpoint_files(path), cfg, dest)
    want = params_from_hf_state_dict(
        {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}, cfg)
    for n, t in dest.items():
        assert torch.equal(t, want[n]), n
    # a checkpoint short of a tensor, with a wrong shape, or with an
    # unmapped tensor is refused by name
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    bad = tmp_path / "bad"
    os.makedirs(bad)
    for cut, match in (
            (lambda d: d.pop("model.layers.1.mlp.up_proj.bias"),
             "missing .*layers.1.mlp.up_proj.bias"),
            (lambda d: d.update({"model.norm.weight": torch.ones(3)}),
             "model.norm.weight: checkpoint shape"),
            (lambda d: d.update({"model.layers.0.self_attn.q_norm.weight":
                                 torch.ones(64)}), "q_norm.weight")):
        part = dict(sd)
        cut(part)
        save_file(part, str(bad / "model.safetensors"))
        with pytest.raises((ValueError, KeyError), match=match):
            stream_params([str(bad / "model.safetensors")], cfg, dest)


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_checkpoint_streams_as_it_materialises(tmp_path, case):
    model = hf_model(case, seed=8)
    path = saved(model, tmp_path / "ckpt", torch.bfloat16, shard="200KB")
    cfg, want = load_hf_model(path, dtype=torch.float32)
    assert len(resolve_checkpoint_files(path)) > 1
    dest = {n: torch.full_like(p, float("nan")) for n, p in
            TransformerLM(cfg, device="cpu").named_parameters()}
    stream_params(resolve_checkpoint_files(path), cfg, dest)
    assert sorted(dest) == sorted(want)
    assert dest["layers.1.moe.experts.down"].shape == (4, 128, cfg.ffn_size)
    for n, t in dest.items():
        assert torch.equal(t, want[n]), n


def test_bin_checkpoints_and_model_objects_load_alike(tmp_path):
    model = hf_model("qwen2_d128", seed=6)
    model.save_pretrained(str(tmp_path / "bin"), safe_serialization=False)
    assert resolve_checkpoint_files(str(tmp_path / "bin")) is None
    cfg_b, p_b = load_hf_model(str(tmp_path / "bin"))
    cfg_o, p_o = load_hf_model(model)
    cfg_s, p_s = load_hf_model(saved(model, tmp_path / "st"))
    assert cfg_b == cfg_o == cfg_s and cfg_o.qkv_bias and not cfg_o.o_bias
    for n in p_o:
        assert torch.equal(p_b[n], p_o[n]) and torch.equal(p_s[n], p_o[n]), n
    with pytest.raises(FileNotFoundError, match="local directories"):
        load_hf_model(str(tmp_path / "meta-llama" / "Llama-3.2-1B"))
