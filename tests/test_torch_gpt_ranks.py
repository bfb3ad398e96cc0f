"""The LayerNorm families on 2 gloo ranks against the JAX Trainer on an
emulated mesh of the same shape, on the CPU: one launch of
``tests/torch_ranks_worker.py`` (``kind="cases"``) runs every case on
meshes of the same two processes, as ``tests/test_torch_cp_ranks.py``
shares its launches.

- tensor parallelism (tp=2): a Phi-style model (the parallel block, the
  q/k/v and MLP-up biases column-parallel, the o and down biases added
  once after the sum, partial rotary, the head bias on the materialised
  logits gathered over the vocab shards) and an ALiBi model (each rank
  its heads' slice of the slopes);
- pipeline parallelism (pp=2, GPipe, 2 micro-batches): learned
  positions read by stage 0, the parallel block with two norms in each
  stage, the head bias on the last stage;
- context parallelism (the ring over sp=2): learned positions at each
  chunk's global positions, and ALiBi at the global coordinates.

Weights are drawn by numpy (``tests/test_torch_gpt.py``'s ``_params``:
biases and the position table non-zero), 3 steps on the same global
batches.  Tolerances, as the f32 cases of the other rank files: the
losses rtol 1e-5 and every final parameter within 1e-5 of its leaf's
largest entry; AdamW's eps 1e-2, since without RoPE the k bias's
gradient is zero but for rounding and eps 1e-8 would move it by lr times
the sign of that noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cp_ranks import _close
from test_torch_gpt import SMALL as GPT_SMALL
from test_torch_gpt import _params as _gpt_params
from test_torch_parallel_ranks import OPT, SCHEDULE, SMALL, _batch, _launch
import torchacc_tpu as ta
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched

pytestmark = pytest.mark.distributed

STEPS = 3
OPT_LN = dict(OPT, eps=1e-2)
BASE = dict(GPT_SMALL, **SMALL)
BIASES = dict(qkv_bias=True, o_bias=True, mlp_bias=True)
LN = dict(BIASES, norm="layernorm", activation="gelu")
RING = dict(sp=dict(size=2, mode="ring"))
CASES = {  # name: (dist, model fields)
    "tp2_phi": (dict(tp=2), dict(LN, parallel_block=True, head_bias=True,
                                 partial_rotary=0.5, num_kv_heads=4)),
    "tp2_alibi": (dict(tp=2), dict(LN, pos_emb="alibi")),
    "pp2_gpipe_learned_neox": (
        dict(pp=dict(size=2, num_micro_batches=2, schedule="gpipe")),
        dict(LN, pos_emb="learned", activation="gelu_exact",
             parallel_block=True, parallel_block_shared_norm=False,
             head_bias=True, num_layers=4)),
    "sp2_ring_learned": (RING, dict(LN, pos_emb="learned")),
    "sp2_ring_alibi": (RING, dict(LN, pos_emb="alibi")),
}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


def _fields(name):
    return dict(BASE, **CASES[name][1])


def _batches():
    return [_batch(60 + i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {name: dict(kind="train", dist=d, model=_fields(name),
                        params=_gpt_params("llama-tiny", _fields(name)),
                        compute={}, grad_accum=1, dtype=torch.float32,
                        batches=_batches(), schedule=SCHEDULE, opt=OPT_LN)
             for name, (d, _) in CASES.items()}
    wait = _launch(tmp_path_factory.mktemp("gpt_ranks"), 2,
                   dict(kind="cases", cases=cases))
    got = []

    def result():
        if not got:
            got.append(wait())
        return got[0]
    return result


def _jax_trainer(d, fields, params):
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", attention_impl="xla"),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=ta.DistConfig(tp=ta.TPConfig(d.get("tp", 1)),
                           sp=ta.SPConfig(**d.get("sp", {})),
                           pp=ta.PPConfig(**d.get("pp", {}))))
    jtrainer, _ = jax_accelerate(
        jax_preset("llama-tiny", **fields), None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(*SCHEDULE),
                                  **OPT_LN),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:2]))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    return jtrainer


@pytest.mark.parametrize("name", sorted(CASES))
def test_ln_families_on_two_ranks_match_the_jax_trainer(ranks, name):
    d, _ = CASES[name]
    fields = _fields(name)
    jtrainer = _jax_trainer(d, fields, _gpt_params("llama-tiny", fields))
    jlosses = [float(jtrainer.step({k: jnp.asarray(v) for k, v in
                                    b.items()})["loss"])
               for b in _batches()]
    got = ranks()[name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    assert [p for p, _ in flat(got["params"])] == [p for p, _ in flat(want)]
    for (path, a), (_, w) in zip(flat(got["params"]), flat(want)):
        _close(a, w, jax.tree_util.keystr(path))
