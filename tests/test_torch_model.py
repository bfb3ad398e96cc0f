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

from torch_module_env import port_module_env
from torchacc_tpu.config import ServeConfig as JaxServeConfig
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.transformer import Norm, _rope
from torchacc_tpu.serve.scheduler import PagedDecoder as JaxDecoder
from torchacc_tpu_torch.config import ServeConfig
from torchacc_tpu_torch.models import get_preset, init_params, params_from_jax
from torchacc_tpu_torch.models.convert import params_to_jax
from torchacc_tpu_torch.models.transformer import norm, rope
from torchacc_tpu_torch.serve.scheduler import PagedDecoder

VOCAB = 257
TINY = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2,
            intermediate_size=128, vocab_size=VOCAB, max_seq_len=128)


def seeded_jax_params(seed=0, **fields):
    """Seeded llama-tiny weights (with ``fields``) in the JAX package's
    layout, as numpy: the port's ``init_params``, whose draws follow the
    flax initialisers' distributions (normal(0.02) matrices and
    embeddings, unit norm scales, zero biases), carried over by
    ``params_to_jax``.  No XLA compile, where ``TransformerLM.init``
    costs one a config; the other test files draw their JAX weights
    here."""
    cfg = get_preset("llama-tiny", dtype=torch.float32, **fields)
    return params_to_jax(cfg, dict(init_params(
        cfg, seed=seed, device="cpu").named_parameters()))


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


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
    out = norm(cfg, torch.from_numpy(x), torch.from_numpy(scale))
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
    # interleaved RoPE, logit_scale and the flat qk-norm are served now
    # (tests/test_torch_gpt.py); pipeline and context parallelism and
    # post-norms are not, as in JAX
    for bad in (dict(num_experts=4), dict(pp_size=2),
                dict(window=(16, -1)), dict(context_parallel=True),
                dict(norm_placement="post"),
                dict(sandwich_norms=True),
                dict(layer_pattern=("sliding", "global"))):
        cfg = get_preset("llama-tiny", dtype=torch.float32, **TINY, **bad)
        model = init_params(cfg, seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match=next(iter(bad))):
            PagedDecoder(model, ServeConfig())


# -- generate(): ragged batches, the recompute path, param_dtype, the
# pipelined decode in one process, and the demotion of a 'pp' config.
# The weights: llama-tiny at TINY's width and 4 layers (two stages of
# two, or four chunks of one), f32, from the port's seeded init; JAX's
# generate() runs its XLA attention.  Tokens are compared exactly.

DEC = dict(TINY, num_layers=4)
LENS = (9, 4, 7)


def _dec_models():
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32,
                      attention_impl="xla", **DEC)
    params = jax.tree.map(jnp.asarray, seeded_jax_params(4, **DEC))
    cfg = get_preset("llama-tiny", dtype=torch.float32, **DEC)
    return jcfg, params, params_from_jax(cfg, params, device="cpu")


def _left_padded(lens, seed=5):
    rng = np.random.default_rng(seed)
    p = max(lens)
    ids = np.zeros((len(lens), p), np.int32)
    mask = np.zeros((len(lens), p), np.int32)
    rows = [rng.integers(1, VOCAB, n) for n in lens]
    for r, row in enumerate(rows):
        ids[r, p - len(row):], mask[r, p - len(row):] = row, 1
    return ids, mask, rows


def test_ragged_generate_matches_jax():
    """Greedy tokens of a left-padded batch equal JAX's
    ``generate(prompt_mask=)``; ``use_cache=False`` equals the cached
    path, and each row equals that row decoded alone."""
    from torchacc_tpu.models.generate import generate as jax_generate
    from torchacc_tpu_torch.models.generate import generate
    jcfg, params, model = _dec_models()
    ids, mask, rows = _left_padded(LENS)
    want = np.asarray(jax_generate(JaxLM(jcfg), params, jnp.asarray(ids),
                                   prompt_mask=jnp.asarray(mask),
                                   max_new_tokens=6))
    got = generate(model, ids, prompt_mask=mask, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)
    slow = generate(model, ids, prompt_mask=mask, max_new_tokens=6,
                    use_cache=False)
    np.testing.assert_array_equal(slow.numpy(), got.numpy())
    for r, row in enumerate(rows):
        alone = generate(model, [row], max_new_tokens=6)[0, len(row):]
        np.testing.assert_array_equal(alone.numpy(),
                                      got[r, ids.shape[1]:].numpy())


def test_sampled_ragged_rows_ignore_their_batch_mates():
    """A sampled row draws at its own positions: its tokens stay the
    same when a batch-mate's length changes, and equal the row alone."""
    from torchacc_tpu_torch.models.generate import generate
    _, _, model = _dec_models()
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=40, seed=11)
    ids, mask, rows = _left_padded(LENS)
    first = generate(model, ids, prompt_mask=mask, **kw)
    ids2, mask2, rows2 = _left_padded((3, 4, 12))
    ids2[1, -4:] = rows[1]
    second = generate(model, ids2, prompt_mask=mask2, **kw)
    alone = generate(model, [rows[1]], **kw)[0, 4:]
    np.testing.assert_array_equal(first[1, ids.shape[1]:].numpy(),
                                  alone.numpy())
    np.testing.assert_array_equal(second[1, ids2.shape[1]:].numpy(),
                                  alone.numpy())


@pytest.mark.parametrize("bad,match", [
    ([[1, 1, 1], [1, 0, 1]], "LEFT-padded"),
    ([[1, 1, 0], [0, 1, 1]], "LEFT-padded|last column"),
    ([[0, 1, 1], [0, 1, 0]], "LEFT-padded|last column"),
    ([[1, 1], [1, 1]], "shape"),
])
def test_prompt_mask_refusals_match_jax(bad, match):
    """JAX's ValueErrors for a mask of another shape or one that is not
    left-padded, in both packages (the port's message names the
    same)."""
    from torchacc_tpu.models.generate import generate as jax_generate
    from torchacc_tpu_torch.models.generate import generate
    jcfg, params, model = _dec_models()
    ids = np.ones((2, 3), np.int32)
    msgs = []
    for call in (lambda: jax_generate(JaxLM(jcfg), params, jnp.asarray(ids),
                                      prompt_mask=jnp.asarray(bad),
                                      max_new_tokens=2),
                 lambda: generate(model, ids, prompt_mask=bad,
                                  max_new_tokens=2)):
        with pytest.raises(ValueError, match=match) as e:
            call()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_generate_param_dtype_cast():
    """``param_dtype`` (JAX's test_generate_param_dtype_cast): the tokens
    of a bf16 copy cast once equal those of a model cast by hand and
    JAX's ``generate(param_dtype=bf16)`` in f32 compute; the caller's
    model stays f32."""
    from torchacc_tpu.models.generate import generate as jax_generate
    from torchacc_tpu_torch.models.generate import generate
    jcfg, params, model = _dec_models()
    ids, mask, _ = _left_padded(LENS, seed=6)
    auto = generate(model, ids, prompt_mask=mask, max_new_tokens=8,
                    param_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    manual = params_from_jax(model.cfg, params, device="cpu",
                             dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        auto.numpy(), generate(manual, ids, prompt_mask=mask,
                               max_new_tokens=8).numpy())
    want = jax_generate(JaxLM(jcfg), params, jnp.asarray(ids),
                        prompt_mask=jnp.asarray(mask), max_new_tokens=8,
                        param_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(auto.numpy(), np.asarray(want))


@pytest.mark.parametrize("virtual", [1, 2])
def test_pipelined_decode_in_one_process(virtual):
    """Every stage of a 2-stage pipeline in this process
    (``tests/torch_pp_virtual.py``): the same tokens as the unpipelined
    decode, greedy and sampled, ragged; each stage's chunks run its own
    blocks against the cache of those blocks."""
    import importlib
    from torch_pp_virtual import virtual_pipeline
    gen = importlib.import_module("torchacc_tpu_torch.models.generate")
    _, _, model = _dec_models()
    ids, mask, _ = _left_padded(LENS)
    pipe = virtual_pipeline(2, 1, "gpipe", virtual)
    for kw in (dict(), dict(temperature=0.8, seed=3)):
        want = gen.generate(model, ids, prompt_mask=mask, max_new_tokens=5,
                            **kw)
        got = gen.generate(model, ids, prompt_mask=mask, max_new_tokens=5,
                           pipeline=pipe, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    calls = []
    real = gen._cached_forward

    def spy(m, ids, start, cache, impl, positions, layers=None,
            hidden=None):
        calls.append((start, list(layers), hidden is None))
        return real(m, ids, start, cache, impl, positions, layers, hidden)
    gen._cached_forward = spy
    try:
        gen.generate(model, ids, prompt_mask=mask, max_new_tokens=2,
                     pipeline=pipe)
    finally:
        gen._cached_forward = real
    per = 4 // (2 * virtual)
    order = [list(range(s * per, (s + 1) * per)) for s in range(2 * virtual)]
    assert calls == [(start, layers, s == 0) for start in (0, ids.shape[1])
                     for s, layers in enumerate(order)]


@pytest.mark.parametrize("virtual", [1, 2])
def test_pipelined_decode_goes_through_the_transport(virtual):
    """Every hop of the one-process decode is a message through the
    pipeline's transport: V * P - 1 of them a pass, one pass for the
    prefill and one a decode step; a transport that zeroes the
    activations it hands on (a control) changes the greedy tokens."""
    import importlib
    from torch_pp_virtual import VirtualTransport, virtual_pipeline
    gen = importlib.import_module("torchacc_tpu_torch.models.generate")

    class Counting(VirtualTransport):
        def __init__(self):
            self.shapes = []

        def deliver(self, kind, dst, m, tensor):
            self.shapes.append((kind, dst, tuple(tensor.shape)))
            return tensor

    class Zeroing(VirtualTransport):
        def deliver(self, kind, dst, m, tensor):
            return torch.zeros_like(tensor)

    _, _, model = _dec_models()
    ids, mask, _ = _left_padded(LENS)
    b, p = ids.shape
    new = 4
    want = gen.generate(model, ids, prompt_mask=mask, max_new_tokens=new)
    counting = Counting()
    got = gen.generate(model, ids, prompt_mask=mask, max_new_tokens=new,
                       pipeline=virtual_pipeline(2, 1, "gpipe", virtual,
                                                 transport=counting))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    h = model.cfg.hidden_size
    hops = [("F", (s + 1) % 2, t) for t in [(b, p, h)] + [(b, 1, h)] *
            (new - 1) for s in range(2 * virtual - 1)]
    assert counting.shapes == hops
    broken = gen.generate(model, ids, prompt_mask=mask, max_new_tokens=new,
                          pipeline=virtual_pipeline(2, 1, "gpipe", virtual,
                                                    transport=Zeroing()))
    assert not torch.equal(broken[:, p:], want[:, p:])


def test_generate_pp_config_without_mesh_demotes():
    """A model whose config has pp_size 2 but holds every block decodes
    as one device, as JAX demotes it (test_extras.py:417); one that
    holds a stage's blocks and is given no pipeline raises by name."""
    import dataclasses
    from torchacc_tpu.models.generate import generate as jax_generate
    from torchacc_tpu_torch.models.generate import generate
    from torchacc_tpu_torch.models.transformer import StageLayers
    jcfg, params, model = _dec_models()
    ids = np.random.default_rng(0).integers(1, VOCAB, (2, 7))
    ref = generate(model, ids, max_new_tokens=6)
    jpp = dataclasses.replace(jcfg, pp_size=2, pp_num_micro=2)
    want = jax_generate(JaxLM(jpp), params, jnp.asarray(ids, jnp.int32),
                        max_new_tokens=6)
    pp_cfg = dataclasses.replace(model.cfg, pp_size=2, pp_num_micro=2)
    pp_model = params_from_jax(pp_cfg, params, device="cpu")
    got = generate(pp_model, ids, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pp_model.layers = StageLayers({0: pp_model.layers[0],
                                   1: pp_model.layers[1]})
    with pytest.raises(ValueError, match="pipeline of its stages"):
        generate(pp_model, ids, max_new_tokens=2)
