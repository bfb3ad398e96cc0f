"""The Gemma family (and Mistral's window, Qwen3's qk-norm) in the port
against the JAX package, on the CPU in f32, at a narrow width that keeps
the heads of 256: hidden 128, 2 q heads over 1 kv head of 256, 4 layers
(8 under interleaved 1F1B), vocab 128.

Held, each from numpy-seeded inputs with the JAX weights carried over
by ``params_from_jax`` (norm scales drawn about their init, so that
rmsnorm1p's zeros hide nothing):

- logits and every parameter's gradient against JAX ``TransformerLM``,
  for each feature alone (rmsnorm1p, GeGLU, embed_scale, sandwich
  norms, per-head qk-norm in both norms, a uniform window, a layer
  pattern, the local rope base with linear scaling on the global
  layers, the final logit softcap) and for the gemma, gemma2 and gemma3
  presets cut to size; JAX's attention is its plain reference
  (``attention_impl='xla'``), and for gemma2 also its Pallas kernels in
  interpret mode;
- a 5-step ``accelerate()`` -> ``Trainer`` trajectory of gemma2 against
  the JAX Trainer;
- GPipe and (interleaved) 1F1B over virtual stages with a layer
  pattern against the JAX Trainer's pipelines (``tests/test_torch_pp.py``
  helpers), and the period check JAX makes;
- ``generate()`` greedy, token for token, against JAX ``generate()`` on
  a gemma3 pattern model whose window bites;
- Gemma v1 and Qwen3 through ``ServeEngine`` against the port's
  ``generate()``, and gemma2/gemma3/Mistral refused there as JAX's
  engine refuses them.

Tolerances (f32): logits atol 2e-5; gradients within 2e-3 of each leaf's
largest entry (test_torch_train.py's: other summation orders through 4
layers of backward); the 5-step loss rtol 1e-4; the pipelines' loss
rtol 1e-5 and gradients 1e-5 of the leaf's largest (test_torch_pp.py's);
tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from test_torch_parallel_ranks import _batch as _pp_batch
from test_torch_pp import _jax_grads, _port_grads
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.generate import generate as jax_generate
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
    init_params,
    loss_fn,
)
from torchacc_tpu_torch.ops.flash_attention import segment_ids_from_positions
from torchacc_tpu_torch.serve import Request, ServeEngine
from torchacc_tpu_torch.train import accelerate, adamw
from torchacc_tpu_torch.train import schedules as port_sched

SMALL = dict(vocab_size=128, hidden_size=128, num_layers=4, num_heads=2,
             num_kv_heads=1, head_dim=256, intermediate_size=256,
             max_seq_len=128)
B, S = 2, 32
PATTERN = dict(layer_pattern=("sliding", "global"), window=(6, -1))

# name: (preset, fields, JAX attention); the features alone on 2 layers,
# the presets on 4
CASES = {
    "rmsnorm1p": ("llama-tiny", dict(norm="rmsnorm1p"), "xla"),
    "geglu": ("llama-tiny", dict(activation="geglu"), "xla"),
    "embed_scale": ("llama-tiny", dict(embed_scale=True), "xla"),
    "sandwich_norms": ("llama-tiny", dict(sandwich_norms=True), "xla"),
    "qk_norm_qwen3": ("llama-tiny", dict(qk_norm=True), "xla"),
    "qk_norm_1p": ("llama-tiny", dict(qk_norm=True, norm="rmsnorm1p"),
                   "xla"),
    "window_mistral": ("llama-tiny", dict(window=(6, -1)), "xla"),
    "layer_pattern": ("llama-tiny", PATTERN, "xla"),
    "local_rope_scaled": ("llama-tiny", dict(PATTERN, rope_scale=4.0,
                                             rope_local_theta=10000.0),
                          "xla"),
    "logit_softcap": ("llama-tiny", dict(logit_softcap=3.0,
                                         tie_embeddings=True), "xla"),
    "gemma": ("gemma-2b", {}, "xla"),
    "gemma2": ("gemma2-2b", dict(window=(6, -1), attn_logit_softcap=5.0,
                                 logit_softcap=3.0), "xla"),
    "gemma2_pallas": ("gemma2-2b", dict(window=(6, -1),
                                        attn_logit_softcap=5.0,
                                        logit_softcap=3.0), "pallas"),
    "gemma3": ("gemma3-1b", dict(layer_pattern=("sliding", "sliding",
                                                "global", "global"),
                                 window=(6, -1), rope_scale=8.0), "xla"),
}
for _name, (_preset, _fields, _impl) in CASES.items():
    _fields.setdefault("num_layers", 2 if _preset == "llama-tiny" else 4)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _params(preset, fields, seed=0):
    """Weights of ``preset`` at SMALL with ``fields`` in JAX's stacked
    layout, drawn from a numpy seed: matrices normal(0.02) as the flax
    init, norm scales their init moved by normal(0.1), so that
    rmsnorm1p's zeros hide nothing."""
    cfg = get_preset(preset, dtype=torch.float32, **dict(SMALL, **fields))
    model = TransformerLM(cfg, device="cpu")
    rng = np.random.default_rng(seed)

    def draw(path, a):
        x = rng.standard_normal(a.shape).astype(np.float32)
        return a + 0.1 * x if "scale" in jax.tree_util.keystr(path) \
            else 0.02 * x
    ones = {n: (torch.zeros_like(p) if cfg.norm == "rmsnorm1p"
                else torch.ones_like(p)) for n, p in model.named_parameters()}
    return jax.tree_util.tree_map_with_path(draw, params_to_jax(cfg, ones))


def _batch(seed):
    """input_ids, positions and segment ids of documents packed into
    [B, S]."""
    rng = np.random.default_rng(seed)
    pos = []
    for _ in range(B):
        p = []
        while len(p) < S:
            p += list(range(int(rng.integers(5, 30))))
        pos.append(p[:S])
    pos = np.asarray(pos, np.int32)
    seg = segment_ids_from_positions(torch.from_numpy(pos)).numpy()
    ids = rng.integers(0, SMALL["vocab_size"], size=(B, S)).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "segment_ids": seg}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_gradients_match_jax(case):
    preset, fields, impl = CASES[case]
    jcfg = jax_preset(preset, dtype=jnp.float32, attention_impl=impl,
                      **dict(SMALL, **fields))
    cfg = get_preset(preset, dtype=torch.float32, **dict(SMALL, **fields))
    assert cfg.head_size == 256
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

    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tb["input_ids"], tb["positions"], tb["segment_ids"])
    loss_fn(logits, torch.from_numpy(labels).long()).backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5)
    got = params_to_jax(cfg, {n: p.grad for n, p in model.named_parameters()})
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    have = _leaves(got)
    key = jax.tree_util.keystr
    assert sorted(key(p) for p, _ in have) == sorted(map(key, want))
    for path, g in have:
        scale = np.abs(want[path]).max()
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, want[path], atol=2e-3 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_init_gives_rmsnorm1p_zeros_and_the_new_norms():
    cfg = get_preset("gemma3-1b", dtype=torch.float32, **SMALL)
    model = init_params(cfg, seed=0, device="cpu")
    names = dict(model.named_parameters())
    for n in ("layers.0.ln1_post.weight", "layers.0.ln2_post.weight",
              "layers.0.attn.q_norm.weight", "layers.0.attn.k_norm.weight",
              "layers.3.ln2.weight", "final_norm.weight"):
        assert torch.equal(names[n], torch.zeros_like(names[n])), n
    assert names["layers.0.attn.q_norm.weight"].shape == (256,)
    assert "lm_head.weight" not in names            # tied
    qwen3 = init_params(get_preset("llama-tiny", qk_norm=True, **SMALL),
                        device="cpu")
    q = dict(qwen3.named_parameters())["layers.1.attn.k_norm.weight"]
    assert torch.equal(q, torch.ones_like(q))


def test_trainer_trajectory_matches_jax_trainer():
    """Five steps of accelerate() -> Trainer.step on gemma2 (sandwich
    norms, the sliding/global pattern, both softcaps, the fused CE) with
    save_attn_mlp remat against the JAX Trainer, from the same weights,
    on the same packed batches."""
    fields = CASES["gemma2"][1]
    params = _params("gemma2-2b", fields, seed=3)
    batches = [_batch(10 + i) for i in range(5)]
    opt = dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8,
               grad_clip_norm=1.0)
    jconf = ta.Config(compute=ta.ComputeConfig(dtype="float32",
                                               attention_impl="xla"),
                      memory=ta.MemoryConfig(gc=True,
                                             gc_policy="save_attn_mlp"))
    jtrainer, _ = jax_accelerate(
        jax_preset("gemma2-2b", **dict(SMALL, **fields)), None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(3e-3, 10, 1),
                                  **opt),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    jlosses = [float(jtrainer.step({k: jnp.asarray(v) for k, v in
                                    b.items()})["loss"]) for b in batches]

    cfg = get_preset("gemma2-2b", dtype=torch.float32, **dict(SMALL, **fields))
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32),
                     memory=tt.MemoryConfig(gc=True,
                                            gc_policy="save_attn_mlp"))
    trainer, _ = accelerate(
        params_from_jax(cfg, params, device="cpu", trainable=True), None,
        conf, optimizer=adamw(port_sched.warmup_cosine(3e-3, 10, 1), **opt))
    assert trainer._use_fused_ce
    losses = [trainer.step(b)["loss"].item() for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


# gemma2's block on llama-tiny's preset (test_torch_pp.py's helpers take
# their fields), at the pipelines' vocab of 128
PP_FIELDS = dict(SMALL, norm="rmsnorm1p", activation="geglu",
                 embed_scale=True, sandwich_norms=True, tie_embeddings=True,
                 attn_logit_softcap=5.0, logit_softcap=3.0,
                 query_scale=256 ** -0.5, rope_local_theta=10000.0,
                 rope_scale=2.0, **PATTERN)
PP_CASES = {  # name: (P, M, schedule, V, layers)
    "gpipe_p2": (2, 2, "gpipe", 1, 4),
    "1f1b_p2_v2": (2, 2, "1f1b", 2, 8),
}


@pytest.mark.parametrize("name", sorted(PP_CASES))
def test_pattern_pipelines_match_jax(name):
    P, M, schedule, V, layers = PP_CASES[name]
    fields = dict(PP_FIELDS, num_layers=layers)
    params = _params("llama-tiny", fields)
    batch = _pp_batch(71)
    jl, jc, jg = _jax_grads(P, M, schedule, V, fields, params, batch, None)
    l_sum, count, grads = _port_grads(P, M, schedule, V, fields, params,
                                      batch, None)
    np.testing.assert_allclose(l_sum, jl, rtol=1e-5)
    assert count == jc
    want = dict(_leaves(jg))
    for path, g in _leaves(grads):
        np.testing.assert_allclose(
            g, want[path], rtol=0, atol=1e-5 * np.abs(want[path]).max(),
            err_msg=jax.tree_util.keystr(path))


def test_pattern_period_must_divide_a_stage_chunk():
    cfg = get_preset("llama-tiny", dtype=torch.float32, pp_size=2,
                     pp_num_micro=2, **dict(PP_FIELDS, layer_pattern=(
                         "sliding", "sliding", "global")))
    with pytest.raises(ValueError, match="period 3 does not divide"):
        TransformerLM(cfg, device="cpu")(torch.zeros((2, 8),
                                                     dtype=torch.long))


@pytest.mark.parametrize("fields,match", [
    (dict(quant="int8"), "quant != 'none' does not compose"),
    (dict(overlap_fsdp=True), "overlap_fsdp does not compose"),
    # the ids these two had while they named OLMo2's fields, which the
    # training forward now implements (tests/test_torch_gpt.py); the
    # mixtures of experts train too (tests/test_torch_moe.py)
    pytest.param(dict(activation="relu"), "activation='relu'.*A8b",
                 id="fields2-qk_norm_proj=True.*A10b-2"),
    pytest.param(dict(decode=True), "decode=True.*A8b",
                 id="fields3-norm_placement='post'.*A10b-2")])
def test_what_jax_rejects_and_the_rest_raise_by_name(fields, match):
    cfg = get_preset("gemma2-2b", dtype=torch.float32,
                     **dict(SMALL, **fields))
    with pytest.raises(NotImplementedError, match=match):
        TransformerLM(cfg, device="cpu")(torch.zeros((1, 8),
                                                     dtype=torch.long))


def test_generate_pattern_model_token_identical_to_jax():
    """Greedy decode of a gemma3 pattern model (qk-norm, the local rope
    base, a 6-key window that the 20-token prompts outgrow) through the
    port's cached path against JAX's ``_generate_cached_pattern``."""
    fields = CASES["gemma3"][1]
    jcfg = jax_preset("gemma3-1b", dtype=jnp.float32, attention_impl="xla",
                      **dict(SMALL, **fields))
    params = _params("gemma3-1b", fields, seed=5)
    prompts = np.random.default_rng(6).integers(
        0, SMALL["vocab_size"], (2, 20)).astype(np.int32)
    want = np.asarray(jax_generate(JaxLM(jcfg),
                                   jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(prompts), max_new_tokens=10))
    cfg = get_preset("gemma3-1b", dtype=torch.float32, **dict(SMALL, **fields))
    model = params_from_jax(cfg, params, device="cpu")
    got = generate(model, prompts, max_new_tokens=10).numpy()
    np.testing.assert_array_equal(got, want)


def _serve(model, prompts, max_new):
    conf = Config(serve=ServeConfig(block_size=8, num_blocks=64,
                                    max_slots=4, prefill_chunk=8,
                                    decode_depth=2))
    eng = ServeEngine(model, conf, device="cpu")
    return [r.tokens for r in eng.generate(
        [Request(prompt_ids=p, max_new_tokens=max_new) for p in prompts])]


@pytest.mark.parametrize("preset,fields", [
    ("gemma-2b", {}), ("llama-tiny", dict(qk_norm=True))],
    ids=["gemma", "qwen3"])
def test_serving_token_identical_to_generate(preset, fields):
    """Gemma v1 (rmsnorm1p, GeGLU, embed_scale, MQA over heads of 256)
    and Qwen3's qk-norm through ServeEngine's paged forward, prompts of
    three lengths in chunks of 8, against the port's generate() one
    prompt at a time."""
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


@pytest.mark.parametrize("preset,fields", [
    ("gemma2-2b", {}), ("gemma3-1b", {}),
    ("llama-tiny", dict(window=(4095, -1)))],
    ids=["gemma2", "gemma3", "mistral"])
def test_serving_refuses_what_jax_serving_refuses(preset, fields):
    cfg = get_preset(preset, dtype=torch.float32, **dict(SMALL, **fields))
    model = init_params(cfg, device="cpu")
    conf = Config(serve=ServeConfig(block_size=8, num_blocks=16))
    with pytest.raises(NotImplementedError, match="models.generate"):
        ServeEngine(model, conf, device="cpu")
