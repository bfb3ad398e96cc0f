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
  chunk's global positions, and ALiBi at the global coordinates;
- tensor parallelism with OLMo2's flat qk-norm (tp=2: each rank holds
  half the heads of q and k, and the norm's statistics are summed over
  the ranks, forward and backward) and post-norms;
- longrope under the ring (sp=2), on rows whose first half holds a
  16-token document and whose second half two of 8: the batch's largest
  position (15) crosses the original context of 12, the second chunk's
  own (7) does not, so the switch must be taken over the sequence ranks
  as JAX's ``jnp.max`` takes it;
- a Phi-3 Hugging Face checkpoint (packed ``qkv_proj`` and
  ``gate_up_proj``, saved in bf16 across several files) streamed by
  ``accelerate(path)`` onto tp=2, each rank copying its box of each
  packed part, then 2 steps, against JAX's ``accelerate(path)`` on the
  same mesh.

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

from torch_module_env import port_module_env
from test_torch_checkpoint_ranks import HF_SCHEDULE, _hf_batch
from test_torch_cp_ranks import _close
from test_torch_hf import saved as hf_saved
from test_torch_hf_gpt import hf_model
from test_torch_gpt import OLMO2, phi3
from test_torch_gpt import SMALL as GPT_SMALL
from test_torch_gpt import _params as _gpt_params
from test_torch_parallel_ranks import (
    B,
    OPT,
    SCHEDULE,
    SMALL,
    _batch,
    _launch,
)
import torchacc_tpu as ta
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu_torch.ops.flash_attention import segment_ids_from_positions

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
    "tp2_olmo2": (dict(tp=2), OLMO2),
    "sp2_ring_longrope": (RING, phi3(12)),
}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _fields(name):
    return dict(BASE, **CASES[name][1])


def _split_batch(seed):
    """Rows of a 16-token document and two of 8 (positions 0..15,
    0..7, 0..7), random ids."""
    pos = np.tile(np.concatenate([np.arange(16), np.arange(8),
                                  np.arange(8)]), (B, 1)).astype(np.int32)
    ids = np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], size=pos.shape).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "segment_ids":
            segment_ids_from_positions(torch.from_numpy(pos)).numpy()}


def _batches(name):
    draw = _split_batch if name == "sp2_ring_longrope" else _batch
    return [draw(60 + i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def phi3_dir(tmp_path_factory):
    return hf_saved(hf_model("phi3", seed=11),
                    tmp_path_factory.mktemp("phi3_hf") / "hf",
                    torch.bfloat16, shard="100KB")


def _phi3_batches():
    return [_hf_batch(90 + i) for i in range(2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, phi3_dir):
    cases = {name: dict(kind="train", dist=d, model=_fields(name),
                        params=_gpt_params("llama-tiny", _fields(name)),
                        compute={}, grad_accum=1, dtype=torch.float32,
                        batches=_batches(name), schedule=SCHEDULE,
                        opt=OPT_LN)
             for name, (d, _) in CASES.items()}
    cases["tp2_phi3_hf"] = dict(kind="hf_train", path=phi3_dir,
                                dist=dict(tp=2), schedule=HF_SCHEDULE,
                                opt=OPT_LN, batches=_phi3_batches())
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
               for b in _batches(name)]
    got = ranks()[name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    assert [p for p, _ in flat(got["params"])] == [p for p, _ in flat(want)]
    for (path, a), (_, w) in zip(flat(got["params"]), flat(want)):
        _close(a, w, jax.tree_util.keystr(path))


def test_phi3_checkpoint_streams_onto_two_tp_ranks(ranks, phi3_dir):
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", param_dtype="float32",
                                 attention_impl="xla"),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=ta.DistConfig(tp=ta.TPConfig(2)))
    jtrainer, _ = jax_accelerate(
        phi3_dir, None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_linear(*HF_SCHEDULE),
                                  **OPT_LN),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:2]))
    jlosses = [float(jtrainer.step({k: jnp.asarray(v) for k, v in
                                    b.items()})["loss"])
               for b in _phi3_batches()]
    got = ranks()["tp2_phi3_hf"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    assert [p for p, _ in flat(got["params"])] == [p for p, _ in flat(want)]
    for (path, a), (_, w) in zip(flat(got["params"]), flat(want)):
        _close(a, w, jax.tree_util.keystr(path))
