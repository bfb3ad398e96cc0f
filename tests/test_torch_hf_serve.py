"""Serving a trained Hugging Face checkpoint with the port:
``ServeEngine.from_train_state`` and ``load_params``, and the port's
``models.generate.generate``, against the JAX package's ``generate()``
on the CPU, f32.

Serving is held at request level against JAX ``models/generate.py::
generate`` on the same converted weights, never against the JAX
``ServeEngine``'s streams (ROADMAP.md C3): greedy tokens must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models.generate import generate as jax_generate
from torchacc_tpu.models.hf import load_hf_model as jax_load_hf_model
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.models.generate import generate
from torchacc_tpu_torch.models.hf import load_hf_model
from test_torch_hf import hf_model, saved

CASE = "llama32_tied_d64"
NEW = 8
SERVE = tt.ServeConfig(block_size=16, num_blocks=64, max_slots=3,
                       prefill_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _jax_tokens(model, prompts, **kw):
    """JAX generate() of each prompt alone, greedy, on ``model``'s
    weights: the generated tokens."""
    jcfg, jparams = jax_load_hf_model(model, dtype=jnp.float32)
    out = []
    for p in prompts:
        toks = jax_generate(JaxLM(jcfg), jparams,
                            jnp.asarray([p], jnp.int32),
                            max_new_tokens=NEW, **kw)
        out.append(np.asarray(toks)[0, len(p):].tolist())
    return out


def _prompts(seed, lens=(5, 17, 40)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(the HF model, a port Trainer initialised from its checkpoint)."""
    model = hf_model(CASE, seed=4)
    path = saved(model, tmp_path_factory.mktemp("hf") / "ckpt")
    trainer, _ = tt.accelerate(
        path, None, tt.Config(compute=tt.ComputeConfig(dtype=torch.float32),
                              serve=SERVE), device="cpu")
    return model, trainer


def test_from_train_state_streams_are_jax_generate(trained):
    """Three greedy requests of 5, 17 and 40 prompt tokens (prefill
    chunks of 16, batched decode) served from the trainer's weights are
    token-identical to JAX generate() on the same weights; the trainer
    keeps its state."""
    model, trainer = trained
    prompts = _prompts(0)
    eng = tt.ServeEngine.from_train_state(trainer)
    assert eng.cfg.dtype == torch.float32 and eng.cfg.rope_llama3
    res = eng.generate([tt.Request(prompt_ids=p, max_new_tokens=NEW)
                        for p in prompts])
    assert [r.tokens for r in res] == _jax_tokens(model, prompts)
    assert trainer.state.step == 0
    assert all(p.dtype == torch.float32 for p in trainer.state.params.values())
    eng16 = tt.ServeEngine.from_train_state(trainer, dtype=torch.bfloat16)
    assert {p.dtype for p in eng16.scheduler.decoder.model.parameters()} \
        == {torch.bfloat16}


def test_port_generate_is_jax_generate(trained):
    """The port's dense-cache generate() against JAX's on a batch of two
    prompts, greedy, with and without an eos that stops a row."""
    model, _ = trained
    _, params = load_hf_model(model)
    cfg, _ = load_hf_model(model, dtype=torch.float32)
    pm = tt.TransformerLM(cfg, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for n, p in pm.named_parameters():
            p.copy_(params[n])
    prompts = np.random.default_rng(1).integers(0, 256, (2, 12))
    jcfg, jparams = jax_load_hf_model(model, dtype=jnp.float32)
    want = np.asarray(jax_generate(JaxLM(jcfg), jparams,
                                   jnp.asarray(prompts, jnp.int32),
                                   max_new_tokens=NEW))
    got = generate(pm, prompts, max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)
    eos = int(want[0, 14])
    want = np.asarray(jax_generate(JaxLM(jcfg), jparams,
                                   jnp.asarray(prompts, jnp.int32),
                                   max_new_tokens=NEW, eos_id=eos))
    got = generate(pm, prompts, max_new_tokens=NEW, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 14:] == eos).all()
    # sampling: a function of the seed and the prompt
    a = generate(pm, prompts, max_new_tokens=NEW, temperature=1.0, seed=3)
    b = generate(pm, prompts, max_new_tokens=NEW, temperature=1.0, seed=3)
    assert torch.equal(a, b)


def test_load_params_swaps_an_idle_engine_and_refuses_a_busy_one(trained):
    """load_params on an idle engine serves the new weights as a fresh
    engine over them does (and as JAX generate() does); while a request
    holds a decode slot it raises."""
    model, trainer = trained
    other = hf_model(CASE, seed=8)
    _, new = load_hf_model(other)
    prompts = _prompts(2, lens=(9, 30))
    eng = tt.ServeEngine.from_train_state(trainer)
    eng.generate([tt.Request(prompt_ids=prompts[0], max_new_tokens=NEW)])
    eng.load_params(new)
    res = eng.generate([tt.Request(prompt_ids=p, max_new_tokens=NEW)
                        for p in prompts])
    assert [r.tokens for r in res] == _jax_tokens(other, prompts)
    with pytest.raises(ValueError, match="names do not match"):
        eng.load_params({"embed_tokens.weight": new["embed_tokens.weight"]})
    eng.submit(tt.Request(prompt_ids=prompts[1], max_new_tokens=NEW))
    eng.step()
    with pytest.raises(RuntimeError, match="occupy decode slots"):
        eng.load_params(new)
    eng.run()
