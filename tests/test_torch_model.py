"""The port's model pieces against the JAX package on the tiny config of
tests/test_serving.py (f32): RMSNorm, RoPE (positions past 1k), the
weight carry-over of ``params_from_jax``, and one prefill chunk of the
port's ``PagedDecoder`` against JAX ``PagedDecoder._prefill_impl`` with
``impl='xla'`` on identical pools.  All inputs come from numpy seeds."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torchacc_tpu.config import ServeConfig as JaxServeConfig
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.transformer import Norm, _rope
from torchacc_tpu.serve.scheduler import PagedDecoder as JaxDecoder
from torchacc_tpu_torch.config import ServeConfig
from torchacc_tpu_torch.models import get_preset, init_params, params_from_jax
from torchacc_tpu_torch.models.transformer import rms_norm, rope
from torchacc_tpu_torch.serve.scheduler import PagedDecoder

VOCAB = 257
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2,
            intermediate_size=128, vocab_size=VOCAB, max_seq_len=128)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


def _tiny(**kw):
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, **TINY, **kw)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = get_preset("llama-tiny", dtype=torch.float32, **TINY, **kw)
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, params, cfg, model


def test_rms_norm_matches_jax():
    jcfg, _, cfg, _ = _tiny()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3.0
    scale = rng.standard_normal(64).astype(np.float32)
    ref = Norm(jcfg).apply({"params": {"scale": jnp.asarray(scale)}},
                           jnp.asarray(x))
    out = rms_norm(cfg, torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("rope_scale", [1.0, 4.0])
def test_rope_matches_jax_past_1k(rope_scale):
    jcfg, _, cfg, _ = _tiny(rope_scale=rope_scale)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 7, 1023, 1500, 4095],
                      [2048, 2049, 3000, 3001, 8000, 8191]], np.int32)
    jp = (jnp.asarray(pos).astype(jnp.float32) / rope_scale
          if rope_scale != 1.0 else jnp.asarray(pos))
    tp = (torch.from_numpy(pos).float() / rope_scale
          if rope_scale != 1.0 else torch.from_numpy(pos))
    rq, rk = _rope(jnp.asarray(q), jnp.asarray(k), jp, jcfg)
    oq, ok = rope(torch.from_numpy(q), torch.from_numpy(k), tp, cfg)
    # angles up to 8191 rad: one f32 ulp of the angle is ~5e-4, so the
    # two frameworks' cos/sin may part by a few 1e-4 at the far end
    np.testing.assert_allclose(oq.numpy(), np.asarray(rq), atol=2e-3)
    np.testing.assert_allclose(ok.numpy(), np.asarray(rk), atol=2e-3)
    near = pos < 1024
    np.testing.assert_allclose(oq.numpy()[near], np.asarray(rq)[near],
                               atol=1e-5)


def test_params_from_jax_carries_every_weight():
    _, params, cfg, model = _tiny(qkv_bias=True)
    blk = params["layers"]["block"]
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    q = np.asarray(blk["attn"]["q_proj"]["kernel"][1])          # [h, H, d]
    np.testing.assert_array_equal(
        model.layers[1].attn.q_proj.weight.numpy(), q.reshape(64, -1).T)
    np.testing.assert_array_equal(
        model.layers[0].attn.k_proj.bias.numpy(),
        np.asarray(blk["attn"]["k_proj"]["bias"][0]).reshape(-1))
    np.testing.assert_array_equal(
        model.lm_head.weight.numpy(),
        np.asarray(params["lm_head"]["kernel"]).T)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, **TINY)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = get_preset("llama-tiny", dtype=torch.float32, **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, jax.tree.map(np.asarray, params))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, seed=0)


@pytest.mark.parametrize("qkv_bias,t0,n_valid", [
    (False, 13, 6),       # mid-sequence chunk, padded tail on the JAX side
    (True, 0, 8),         # first full chunk, qkv biases
])
def test_prefill_chunk_logits_match_jax(qkv_bias, t0, n_valid):
    jcfg, params, cfg, model = _tiny(qkv_bias=qkv_bias)
    bs, chunk, nb, mb = 8, 8, 16, 6
    rng = np.random.default_rng(2)
    shape = (cfg.num_layers, nb, bs, cfg.kv_heads, cfg.head_size)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    table = np.zeros(mb, np.int32)
    table[:3] = rng.permutation(np.arange(1, nb))[:3]
    toks = np.zeros(chunk, np.int32)
    toks[:n_valid] = rng.integers(1, VOCAB, size=n_valid)

    jdec = JaxDecoder(jcfg, JaxServeConfig(block_size=bs, num_blocks=nb,
                                           prefill_chunk=chunk),
                      attention_impl="xla")
    (jk, jv), ref = jdec._prefill_impl(
        params, (jnp.asarray(k_pool), jnp.asarray(v_pool)),
        jnp.asarray(table), jnp.asarray(t0, jnp.int32), jnp.asarray(toks),
        jnp.asarray(n_valid, jnp.int32), True)

    dec = PagedDecoder(model, ServeConfig(block_size=bs, num_blocks=nb,
                                          prefill_chunk=chunk),
                       attention_impl="torch")
    pools = (torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy()))
    with torch.inference_mode():
        out = dec.prefill(
            pools, torch.from_numpy(table[None]),
            torch.tensor([t0], dtype=torch.int32),
            torch.from_numpy(toks[None, :n_valid]),
            torch.tensor([n_valid], dtype=torch.int32), with_head=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=1e-4)
    # the chunk's k/v landed in the same pool slots (the null block 0
    # holds garbage in both and is left out)
    np.testing.assert_allclose(pools[0][:, 1:].numpy(),
                               np.asarray(jk)[:, 1:], atol=1e-5)
    np.testing.assert_allclose(pools[1][:, 1:].numpy(),
                               np.asarray(jv)[:, 1:], atol=1e-5)


def test_unsupported_fields_rejected_by_name():
    for bad in (dict(num_experts=4), dict(norm="layernorm"),
                dict(window=(16, -1)), dict(activation="gelu"),
                dict(rope_llama3=(8.0, 1.0, 4.0, 8192.0))):
        cfg = get_preset("llama-tiny", dtype=torch.float32, **TINY, **bad)
        model = init_params(cfg, seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match=next(iter(bad))):
            PagedDecoder(model, ServeConfig())
