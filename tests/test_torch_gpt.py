"""The LayerNorm / non-gated-MLP families (GPT-2, GPT-NeoX, Phi,
StarCoder2, Nemotron) and the rest of the dense forward (Phi-3's
partial rotary and longrope, Cohere's interleaved RoPE and
``logit_scale``, OLMo2's post-norms and flat qk-norm, YaRN) in the port
against the JAX package, on the CPU in f32 at a narrow width: hidden
64, 4 heads of 16 (Phi's case 2 heads of 80), vocab 128.

Held, each from numpy-seeded inputs with the JAX weights carried over
by ``params_from_jax`` (norm scales drawn about their init, biases and
the position table drawn too, so that nothing hides behind a zero):

- logits and every parameter's gradient against JAX ``TransformerLM``
  for gpt2-tiny and Phi-, NeoX-, Nemotron- and StarCoder2-style
  configs, which between them hold every feature of the slice
  (``CASES``), for ALiBi and for a LayerNorm without biases, and for
  Cohere-, OLMo2-, Phi-3- (longrope on both sides of its switch) and
  YaRN-style configs; JAX's attention is its plain reference, and for
  Phi, ALiBi with GQA and OLMo2 also its Pallas kernels in interpret
  mode;
- ``norm_bias=False`` changes the logits (the field is honoured, not
  inert);
- ``num_params`` against the model's parameters and JAX's count;
- a 5-step ``accelerate()`` -> ``Trainer`` trajectory of a Phi-style
  model (the head bias takes the materialised logits), and of gpt2-tiny
  and an OLMo2-style model under int8 ``compute.quant``, against the
  JAX Trainer;
- GPipe over virtual stages with learned positions, the parallel block
  and the head bias, and with OLMo2's post-norms, against the JAX
  Trainer's pipeline;
- ``generate()`` greedy, token for token, against JAX ``generate()``
  (Phi-style; ALiBi; Cohere; OLMo2; Phi-3 across longrope's cache
  rebuild at an original context of 16, with and without a row frozen
  at eos before it);
- GPT-2, Nemotron, YaRN and longrope (all positions on one side of the
  switch) through ``ServeEngine`` against the port's ``generate()``;
  the parallel block (Cohere's too), post-norms, a window (Phi-3's) and
  ALiBi refused there with JAX's pointer;
- what JAX refuses, with its messages, and what waits for A10c by name;
  a checkpoint of gpt2-tiny saved and restored whole.

Tolerances (f32): logits atol 2e-5; gradients within 2e-3 of each leaf's
largest entry (other summation orders through the backward; 2e-10 for
the k bias without RoPE, whose gradient is zero but for rounding); the
5-step losses rtol 1e-4 (int8: 1e-3, the quantized matmuls' rounding
flips); the pipeline's loss rtol 1e-5 and gradients 1e-5 of the leaf's
largest (test_torch_pp.py's); tokens exactly.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from test_torch_gemma import _batch, _leaves
from test_torch_parallel_ranks import _batch as _pp_batch
from test_torch_pp import _jax_grads, _port_grads
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.generate import generate as jax_generate
from torchacc_tpu.models.transformer import alibi_slopes as jax_slopes
from torchacc_tpu.models.transformer import loss_sum_count as jax_loss
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu.train.trainer import shift_labels as jax_shift_labels
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.config import Config, ServeConfig
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.models.convert import params_to_jax
from torchacc_tpu_torch.models.generate import generate
from torchacc_tpu_torch.models.transformer import (
    TransformerLM,
    alibi_slopes,
    init_params,
    loss_fn,
)
from torchacc_tpu_torch.parallel.sharding import _check_plan, make_rules
from torchacc_tpu_torch.serve import Request, ServeEngine
from torchacc_tpu_torch.train import accelerate, adamw
from torchacc_tpu_torch.train import schedules as port_sched

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=4, intermediate_size=128, max_seq_len=128,
             rope_theta=10000.0)
BIASES = dict(qkv_bias=True, o_bias=True, mlp_bias=True)
# the families at SMALL, on llama-tiny's preset (the JAX package has
# presets for GPT-2 only; its Hugging Face conversion sets these fields)
PHI = dict(BIASES, norm="layernorm", activation="gelu",
           parallel_block=True, head_bias=True, partial_rotary=0.4,
           hidden_size=160, num_heads=2, num_kv_heads=2)
NEOX = dict(BIASES, norm="layernorm", activation="gelu_exact",
            parallel_block=True, parallel_block_shared_norm=False,
            partial_rotary=0.25)
NEMOTRON = dict(norm="layernorm1p", activation="relu2", partial_rotary=0.5,
                num_kv_heads=2)
STARCODER2 = dict(BIASES, norm="layernorm", activation="gelu",
                  num_kv_heads=2)
ALIBI = dict(BIASES, norm="layernorm", activation="gelu", pos_emb="alibi",
             num_heads=6, num_kv_heads=3, hidden_size=96)
COHERE = dict(parallel_block=True, norm="layernorm", norm_bias=False,
              logit_scale=0.0625, rope_interleaved=True, tie_embeddings=True)
OLMO2 = dict(qk_norm=True, qk_norm_proj=True, norm_placement="post",
             num_kv_heads=2)
YARN = dict(rope_yarn=(4.0, 16.0, 32.0, 1.0, None, True))
# another ramp: no truncation, other betas, an explicit attention factor
YARN2 = dict(rope_yarn=(2.0, 32.0, 16.0, 2.0, 1.3, False))
# longrope's factors for Phi-4-mini's partial rotary 0.75 at d 16 (12
# dims rotate: 6 pairs), drawn from a seed as a checkpoint's would be
_LR = np.random.default_rng(1234)
SHORT_F = tuple(float(x) for x in _LR.uniform(1.0, 1.5, 6))
LONG_F = tuple(float(x) for x in _LR.uniform(2.0, 8.0, 6))


def phi3(original, attention_factor=None):
    """Phi-3-style fields with longrope's switch at ``original``: the
    batches' largest position is 22, so 16 takes the long factors and 64
    the short ones; 4 puts every position of the serving cases past it."""
    return dict(partial_rotary=0.75, num_kv_heads=2, rope_longrope=(
        SHORT_F, LONG_F, float(original), attention_factor))

# name: (preset, fields, JAX attention).  Each feature rides at least
# one family: layernorm (gpt2, phi, neox, starcoder2), layernorm1p and
# relu2 (nemotron), norm_bias=False (layernorm_no_bias), gelu (gpt2,
# phi, starcoder2), gelu_exact and the parallel block with two norms
# (neox), partial rotary (phi 0.4, neox 0.25, nemotron 0.5), learned
# positions (gpt2), ALiBi (alibi, with GQA and 6 heads), the shared
# parallel block and the head bias (phi)
CASES = {
    "layernorm_no_bias": ("llama-tiny", dict(norm="layernorm",
                                             norm_bias=False), "xla"),
    "alibi": ("llama-tiny", dict(pos_emb="alibi"), "xla"),
    "gpt2_tiny": ("gpt2-tiny", dict(BIASES), "xla"),
    "phi": ("llama-tiny", PHI, "xla"),
    "phi_pallas": ("llama-tiny", PHI, "pallas"),
    "neox": ("llama-tiny", NEOX, "xla"),
    "nemotron": ("llama-tiny", NEMOTRON, "xla"),
    "starcoder2": ("llama-tiny", STARCODER2, "xla"),
    "alibi_gqa_pallas": ("llama-tiny", ALIBI, "pallas"),
    "cohere": ("llama-tiny", COHERE, "xla"),
    "olmo2": ("llama-tiny", OLMO2, "xla"),
    "olmo2_pallas": ("llama-tiny", OLMO2, "pallas"),
    "phi3_long": ("llama-tiny", phi3(16), "xla"),
    "phi3_short": ("llama-tiny", phi3(64, 1.19), "xla"),
    "yarn": ("llama-tiny", YARN, "xla"),
    "yarn_untruncated": ("llama-tiny", YARN2, "xla"),
}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _cfgs(preset, fields, impl="xla"):
    kw = dict(SMALL, **fields)
    return (jax_preset(preset, dtype=jnp.float32, attention_impl=impl, **kw),
            get_preset(preset, dtype=torch.float32, **kw))


def _params(preset, fields, seed=0):
    """Weights of ``preset`` at SMALL with ``fields`` in JAX's stacked
    layout, drawn from a numpy seed: matrices, biases and the position
    table normal(0.02) as the flax init draws its matrices, norm scales
    their init moved by normal(0.1)."""
    cfg = get_preset(preset, dtype=torch.float32, **dict(SMALL, **fields))
    model = TransformerLM(cfg, device="cpu")
    rng = np.random.default_rng(seed)

    def draw(path, a):
        x = rng.standard_normal(a.shape).astype(np.float32)
        return a + 0.1 * x if "scale" in jax.tree_util.keystr(path) \
            else 0.02 * x
    base = {n: (torch.zeros_like(p) if cfg.norm.endswith("1p")
                else torch.ones_like(p)) for n, p in model.named_parameters()}
    return jax.tree_util.tree_map_with_path(draw, params_to_jax(cfg, base))


def _port_logits(cfg, params, batch):
    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model, model(tb["input_ids"], tb["positions"], tb["segment_ids"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_gradients_match_jax(case):
    preset, fields, impl = CASES[case]
    jcfg, cfg = _cfgs(preset, fields, impl)
    params = _params(preset, fields)
    batch = _batch(1)
    labels = np.array(jax_shift_labels(jnp.asarray(batch["input_ids"]),
                                       jnp.asarray(batch["segment_ids"])))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits = JaxLM(jcfg).apply(
            {"params": p}, jb["input_ids"], positions=jb["positions"],
            segment_ids=jb["segment_ids"])
        s, c = jax_loss(logits, jnp.asarray(labels))
        return s / c, logits
    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))

    model, logits = _port_logits(cfg, params, batch)
    loss_fn(logits, torch.from_numpy(labels).long()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5)
    got = params_to_jax(cfg, {n: p.grad for n, p in model.named_parameters()})
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    have = _leaves(got)
    key = jax.tree_util.keystr
    assert sorted(key(p) for p, _ in have) == sorted(map(key, want))
    for path, g in have:
        # without RoPE the k bias shifts every score of a row alike: its
        # gradient is zero but for rounding (~1e-10 in both packages)
        scale = max(np.abs(want[path]).max(), 1e-7)
        np.testing.assert_allclose(g, want[path], atol=2e-3 * scale,
                                   err_msg=key(path))


def test_norm_bias_is_honoured_not_inert():
    """A LayerNorm model without norm biases has no bias parameters and
    other logits than one with them, and matches JAX's (its logits are
    held above, case layernorm_no_bias)."""
    fields = dict(norm="layernorm")
    params = _params("llama-tiny", fields)
    cfg = get_preset("llama-tiny", dtype=torch.float32,
                     **dict(SMALL, **fields))
    nb = dataclasses.replace(cfg, norm_bias=False)
    batch = _batch(2)
    with torch.no_grad():
        with_bias = _port_logits(cfg, params, batch)[1]
        stripped = jax.tree_util.tree_map_with_path(
            lambda p, a: a, params)
        for node in (stripped["final_norm"], stripped["layers"]["block"][
                "ln1"], stripped["layers"]["block"]["ln2"]):
            del node["bias"]
        model, without = _port_logits(nb, stripped, batch)
    assert not any(n.endswith("ln1.bias") or n == "final_norm.bias"
                   for n, _ in model.named_parameters())
    assert np.abs((with_bias - without).numpy()).max() > 1e-3
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, attention_impl="xla",
                      norm_bias=False, **dict(SMALL, **fields))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = JaxLM(jcfg).apply({"params": jax.tree.map(jnp.asarray, stripped)},
                             jb["input_ids"], positions=jb["positions"],
                             segment_ids=jb["segment_ids"])
    np.testing.assert_allclose(without.numpy(), np.asarray(want), atol=2e-5)


def test_alibi_slopes_and_num_params_match_jax():
    for n in range(1, 41):
        np.testing.assert_allclose(alibi_slopes(n), jax_slopes(n), rtol=0)
    for preset, fields in [("gpt2-tiny", {}), ("gpt2", {}),
                           ("llama-tiny", PHI), ("llama-tiny", NEOX),
                           ("llama-tiny", NEMOTRON),
                           ("llama-tiny", STARCODER2),
                           ("llama-tiny", dict(norm="layernorm",
                                               norm_bias=False)),
                           ("llama-tiny", OLMO2), ("llama-tiny", COHERE),
                           ("gemma2-2b", dict(qk_norm=True))]:
        kw = fields if preset.startswith("gpt2") else dict(SMALL, **fields)
        cfg = get_preset(preset, **kw)
        model = TransformerLM(cfg, device="meta")
        assert cfg.num_params() == sum(p.numel() for p in model.parameters())
        assert cfg.num_params() == jax_preset(preset, **kw).num_params()
    names = dict(init_params(get_preset("llama-tiny", **dict(
        SMALL, **NEMOTRON)), device="cpu").named_parameters())
    # layernorm1p stores w (zero) and scales by 1 + w; biases start at 0
    for n in ("layers.0.ln1.weight", "layers.1.ln2.bias", "final_norm.bias"):
        assert torch.equal(names[n], torch.zeros_like(names[n])), n
    assert "layers.0.mlp.gate_proj.weight" not in names


def _opt():
    return dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8,
                grad_clip_norm=1.0)


# trajectory: (case, int8)
TRAJECTORIES = {"phi": ("phi", False), "gpt2_int8": ("gpt2_tiny", True),
                "olmo2_int8": ("olmo2", True)}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_trainer_trajectory_matches_jax_trainer(name):
    """Five steps of accelerate() -> Trainer.step against the JAX
    Trainer from the same weights on the same packed batches: a
    Phi-style model under save_attn_mlp remat (the head bias takes the
    materialised logits, not the fused CE), and with int8 quantized
    matmuls gpt2-tiny (the non-gated MLP's up/down projections) and an
    OLMo2-style model (post-norms after the quantized o and down
    projections, the flat qk-norm after the quantized q and k)."""
    case, quant = TRAJECTORIES[name]
    preset, fields, _ = CASES[case]
    params = _params(preset, fields, seed=3)
    batches = [_batch(10 + i) for i in range(5)]
    kw = dict(SMALL, **fields)
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", attention_impl="xla",
                                 **(dict(quant="int8", quant_impl="xla")
                                    if quant else {})),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"))
    jtrainer, _ = jax_accelerate(
        jax_preset(preset, **kw), None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(3e-3, 10, 1),
                                  **_opt()),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    jlosses = [float(jtrainer.step({k: jnp.asarray(v) for k, v in
                                    b.items()})["loss"]) for b in batches]

    cfg = get_preset(preset, dtype=torch.float32, **kw)
    conf = tt.Config(
        compute=tt.ComputeConfig(dtype=torch.float32,
                                 **(dict(quant="int8") if quant else {})),
        memory=tt.MemoryConfig(gc=True, gc_policy="save_attn_mlp"))
    trainer, _ = accelerate(
        params_from_jax(cfg, params, device="cpu", trainable=True), None,
        conf, optimizer=adamw(port_sched.warmup_cosine(3e-3, 10, 1),
                              **_opt()))
    assert trainer._use_fused_ce == (not cfg.head_bias)
    losses = [trainer.step(b)["loss"].item() for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3 if quant else 1e-4)


# learned positions, the parallel block with two norms and the head bias
# on llama-tiny's preset (test_torch_pp.py's helpers take their fields);
# no q/k/v bias, whose k part has a zero gradient without RoPE
PP_FIELDS = dict(SMALL, **dict(NEOX, pos_emb="learned", head_bias=True,
                               num_layers=4, qkv_bias=False))


def test_pipeline_matches_jax():
    """GPipe (P 2, M 2) over virtual stages: the position table read by
    stage 0, the head bias by the last, the parallel block in each."""
    _pipeline_matches_jax(PP_FIELDS)


def test_pipeline_post_norms_matches_jax():
    """GPipe (P 2, M 2) over virtual stages with OLMo2's post-norms and
    flat qk-norm in every stage."""
    _pipeline_matches_jax(dict(SMALL, **OLMO2, num_layers=4))


def _pipeline_matches_jax(fields):
    params = _params("llama-tiny", fields)
    batch = _pp_batch(71)
    jl, jc, jg = _jax_grads(2, 2, "gpipe", 1, fields, params, batch, None)
    l_sum, count, grads = _port_grads(2, 2, "gpipe", 1, fields, params,
                                      batch, None)
    np.testing.assert_allclose(l_sum, jl, rtol=1e-5)
    assert count == jc
    want = dict(_leaves(jg))
    for path, g in _leaves(grads):
        np.testing.assert_allclose(
            g, want[path], rtol=0, atol=1e-5 * np.abs(want[path]).max(),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", ["phi", "alibi_gqa_pallas", "cohere",
                                  "olmo2", "phi3_long"])
def test_generate_token_identical_to_jax(case):
    """Greedy decode through the port's cached path (B1's ALiBi
    instantiation on the card) against JAX's cached ``generate``; the
    Phi-3 case's 12-token prompts cross longrope's original context of
    16 at the 5th new token, where both rebuild the cache."""
    preset, fields, _ = CASES[case]
    jcfg, cfg = _cfgs(preset, fields)
    params = _params(preset, fields, seed=5)
    p = 12 if case == "phi3_long" else 20
    prompts = np.random.default_rng(6).integers(
        0, SMALL["vocab_size"], (2, p)).astype(np.int32)
    want = np.asarray(jax_generate(JaxLM(jcfg),
                                   jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(prompts), max_new_tokens=10))
    got = generate(params_from_jax(cfg, params, device="cpu"), prompts,
                   max_new_tokens=10).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_longrope_rebuild_keeps_eos_rows_frozen():
    """Across the rebuild a row that reached eos before the crossing
    stays frozen in both packages (eos is the token row 0 emits second,
    before the crossing at the 5th), tokens identical to JAX's; and the
    rebuild is a re-run of the 17 tokens so far from position 0."""
    gen_mod = importlib.import_module("torchacc_tpu_torch.models.generate")
    preset, fields, _ = CASES["phi3_long"]
    jcfg, cfg = _cfgs(preset, fields)
    params = _params(preset, fields, seed=5)
    prompts = np.random.default_rng(9).integers(
        0, SMALL["vocab_size"], (2, 12)).astype(np.int32)
    jmodel, jparams = JaxLM(jcfg), jax.tree.map(jnp.asarray, params)
    free = np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompts),
                                   max_new_tokens=10))
    eos = int(free[0, 13])
    want = np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompts),
                                   max_new_tokens=10, eos_id=eos))
    model = params_from_jax(cfg, params, device="cpu")
    got = generate(model, prompts, max_new_tokens=10, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 13:] == eos).all()
    cross = []
    real = gen_mod._cached_forward
    spy = lambda m, ids, start, *a: cross.append((start, ids.shape[1])) \
        or real(m, ids, start, *a)
    gen_mod._cached_forward = spy
    try:
        generate(model, prompts, max_new_tokens=10)
    finally:
        gen_mod._cached_forward = real
    assert (0, 17) in cross                 # the re-run of 16 + 1 tokens


def _serve(model, prompts, max_new):
    conf = Config(serve=ServeConfig(block_size=8, num_blocks=64,
                                    max_slots=4, prefill_chunk=8,
                                    decode_depth=2))
    eng = ServeEngine(model, conf, device="cpu")
    return [r.tokens for r in eng.generate(
        [Request(prompt_ids=p, max_new_tokens=max_new) for p in prompts])]


SERVED = dict(CASES, phi3_all_long=("llama-tiny", phi3(4), "xla"),
              olmo2_flat_qk_norm=("llama-tiny", dict(OLMO2,
                                                    norm_placement="pre"),
                                  "xla"),
              cohere_rope_scale=("llama-tiny", dict(
                  COHERE, parallel_block=False), "xla"))


@pytest.mark.parametrize("case", ["gpt2_tiny", "nemotron", "starcoder2",
                                  "yarn", "phi3_short", "phi3_all_long",
                                  "olmo2_flat_qk_norm", "cohere_rope_scale"])
def test_serving_token_identical_to_generate(case):
    """GPT-2 (learned positions, biased LayerNorms, gelu), Nemotron
    (layernorm1p, relu2, partial rotary, GQA), StarCoder2, YaRN,
    longrope with every position below its switch (original 64) and
    every one past it (original 4), the flat qk-norm, and interleaved
    RoPE with ``logit_scale`` through ServeEngine's paged forward,
    prompts of three lengths in chunks of 8, against the port's
    generate() one prompt at a time."""
    preset, fields, _ = SERVED[case]
    cfg = get_preset(preset, dtype=torch.float32, **dict(SMALL, **fields))
    model = params_from_jax(cfg, _params(preset, fields, seed=7),
                            device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, SMALL["vocab_size"], size=n).tolist()
               for n in (5, 13, 21)]
    got = _serve(model, prompts, 6)
    for p, toks in zip(prompts, got):
        ref = generate(model, [p], max_new_tokens=6)[0, len(p):].tolist()
        assert toks == ref


@pytest.mark.parametrize("case", ["phi", "neox", "alibi", "cohere",
                                  "olmo2", "phi3_window"])
def test_serving_refuses_what_jax_serving_refuses(case):
    """Refused with JAX's pointer to generate(): the parallel block
    (Cohere's as converted), post-norms, ALiBi and a window (the
    published Phi-3-mini configs carry one)."""
    preset, fields, _ = (("llama-tiny", dict(phi3(16), window=(15, -1)),
                          "xla") if case == "phi3_window" else CASES[case])
    cfg = get_preset(preset, dtype=torch.float32, **dict(SMALL, **fields))
    conf = Config(serve=ServeConfig(block_size=8, num_blocks=16))
    with pytest.raises(NotImplementedError,
                       match="(parallel_block|alibi|norm_placement|window)"
                             ".*models.generate"):
        ServeEngine(init_params(cfg, device="cpu"), conf, device="cpu")


def test_what_jax_refuses_and_the_rest_raise_by_name():
    cfg = get_preset("llama-tiny", dtype=torch.float32, **SMALL)
    ids = torch.zeros((1, 8), dtype=torch.long)
    for fields, err, match in [
            (dict(head_bias=True, tie_embeddings=True), ValueError,
             "head_bias does not compose with tie_embeddings"),
            (dict(parallel_block=True, sandwich_norms=True), ValueError,
             "parallel_block \\(phi\\) does not compose"),
            (dict(norm_placement="post", sandwich_norms=True), ValueError,
             "norm_placement='post' \\(OLMo2\\) does not compose"),
            (dict(decode=True), NotImplementedError,
             "decode=True.*A8b"),
            (dict(overlap_fsdp=True), NotImplementedError,
             "overlap_fsdp=True.*A8b")]:
        c = dataclasses.replace(cfg, **fields)
        with pytest.raises(err, match=match):
            TransformerLM(c, device="cpu")(ids)
        if err is ValueError:
            with pytest.raises(err, match=match):
                generate(init_params(c, device="cpu"), [[1, 2]],
                         max_new_tokens=2)
    learned = init_params(dataclasses.replace(cfg, pos_emb="learned",
                                              max_seq_len=16), device="cpu")
    with pytest.raises(ValueError, match="exceeds the learned position "
                                         "table max_seq_len 16"):
        generate(learned, [[1] * 10], max_new_tokens=7)
    eng = ServeEngine(learned, Config(serve=ServeConfig(
        block_size=8, num_blocks=16)), device="cpu")
    with pytest.raises(ValueError, match="exceeds the learned position"):
        eng.submit(Request(prompt_ids=[1] * 10, max_new_tokens=7))
    # GPT-2's vocabulary does not split over tp=2: the replicated head
    # JAX falls back to is not ported (ROADMAP A8b)
    with pytest.raises(NotImplementedError,
                       match="vocab_size 50257 is not divisible by tp 2"):
        _check_plan(get_preset("gpt2"), make_rules(tt.Config()),
                    dict(dp=1, pp=1, fsdp=1, sp=1, spu=1, ep=1, tp=2))


def test_gpt2_checkpoint_round_trip(tmp_path):
    """gpt2-tiny's new leaves (the position table, the norm biases)
    go through a checkpoint whole: save after a step, restore into a
    fresh trainer, the state bitwise."""
    cfg = get_preset("gpt2-tiny", **dict(SMALL, **BIASES))
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32))
    trainer, _ = accelerate(cfg, None, conf, device="cpu")
    trainer.init()
    trainer.step(_batch(4))
    trainer.save(str(tmp_path / "ck"))
    other, _ = accelerate(cfg, None, conf, device="cpu")
    other.restore(str(tmp_path / "ck"))
    mine = dict(trainer.state.params)
    assert "pos_embed.weight" in mine and "layers.1.ln2.bias" in mine
    for n, p in other.state.params.items():
        assert torch.equal(p, mine[n]), n
