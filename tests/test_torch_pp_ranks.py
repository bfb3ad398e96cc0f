"""The port's pipeline parallelism on 2 and 4 gloo ranks against the JAX
Trainer on an emulated mesh of the same shape, on the CPU.

Two launches of ``tests/torch_ranks_worker.py`` (``kind="cases"``), one
of 2 ranks and one of 4, started together, each running every case of
its world in turn on meshes of the same processes, as
``tests/test_torch_cp_ranks.py`` shares its launches; each subprocess
has a timeout of its own.

- ``accelerate()`` -> 3 ``Trainer.step`` s with ``dist.pp``: gpipe on 2
  stages; 1f1b on 2 with attention dropout and tied embeddings; 1f1b on
  2 with dropout under ``grad_accum`` 2; 1f1b on 4 with 8
  micro-batches; interleaved 1f1b on 2 stages of 2 chunks;
  and pp 2 beside dp 2, beside fsdp 2 (gpipe, and interleaved 1f1b of
  2 chunks a stage: FSDP2 gathers under the no-grad forwards, again
  under the B tick's re-run, and reduce-scatters each micro-batch),
  beside tp 2 (1f1b, the vocab-parallel head), beside a ring of 2
  (1f1b), and beside dp 2 with attention dropout and capacity dispatch
  (1f1b: each rank's rows of JAX's micro-batches), against the JAX
  Trainer on a mesh of the same shape from the same JAX weights.  The
  tolerances of ``tests/test_torch_parallel_ranks.py``, f32: the losses
  rtol 1e-5 and every final parameter within 1e-5 of its leaf's
  largest entry.  AdamW takes eps 1e-2, as that file's fp16, bf16 and
  int8 cases do: with 1e-8 its first updates are lr * sign(g), so an
  embedding element whose gradient is near zero moves by its rounding
  noise, which the micro-batch split reorders: JAX's own pp 2 x dp 2
  run parts from its dp 2 run by 73 times the limit there, and the
  port's from JAX's by up to 69 times.  The gradients themselves agree
  far inside the limit: one step's read <= 7.2e-7 of each leaf's largest
  entry (``tests/test_torch_pp.py`` holds them at 1e-5).
- ``eval_step`` after the steps (pp 2 beside dp 2) against the JAX
  Trainer's, rtol 1e-5.
- A Hugging Face directory (``tests/test_torch_hf.py``'s tied
  Llama-3.2-1B shape at a small width, bf16 shards) through
  ``accelerate(path)`` on pp 2 (1f1b), each stage streaming its blocks
  and the replicated tensors: 2 steps against JAX's ``accelerate(path)``
  on a 'pp' mesh of 2, at the tolerances above.
- Sharding a ``meta`` model on pp 2 x V 2 (``shard_model``): with
  seeded draws a stage makes every block in order, releasing each other
  stage's block before the next is made, so at most one such block
  holds storage at once and none after; its own blocks equal the
  one-device ``init_params``' bitwise.  Given storage only (a
  checkpoint's load) it makes only its own blocks.
- The pipelined decode (``generate(model, ..., pipeline=decode_pipeline(
  trainer.mesh, ...))``,
  before the steps) of a ragged batch of 3 left-padded prompts, in the
  launches above: pp 2, pp 2 beside dp 2, beside fsdp 2 (FSDP2's
  shards gathered around the decode) and over 2 virtual stages.  The
  greedy tokens of every rank equal JAX's ``generate(prompt_mask=)``
  on the same weights; the prefill's last-stage hidden, the same on
  every rank, lies within atol 2e-5 (f32) of JAX's
  ``pp_forward_with_cache`` on an emulated 'pp' mesh of 2; each rank
  holds the blocks of its own stage (under virtual stages its chunks d
  and d + 2) and keeps the cache of those blocks only.
- A checkpoint: pp 2 (1f1b) saves after step 2 through a
  ``CheckpointManager``; a trainer made from other weights restores it
  and its step 3 must equal the uninterrupted run's, loss and every
  leaf of the state, bitwise on every rank; the same processes laid out
  without 'pp' (dp 2) must refuse it with ``TopologyMismatchError`` on
  the 'pp' axis.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
from test_torch_checkpoint_ranks import HF_SCHEDULE, _hf_batch
from test_torch_cp_ranks import _close
from test_torch_cp_ranks import _params as _jax_params
from test_torch_hf import hf_model, saved as hf_saved
from test_torch_parallel_ranks import OPT, SCHEDULE, SMALL, _batch, _launch
import torchacc_tpu as ta
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched

pytestmark = pytest.mark.distributed

STEPS = 3
OPT_PP = dict(OPT, eps=1e-2)
FOUR = dict(SMALL, num_layers=4)
EIGHT = dict(SMALL, num_layers=8)
# the tp x pp case needs kv heads that split over tp
WIDE = dict(FOUR, num_heads=8, num_kv_heads=4)
# attention dropout and a mixture of experts with capacity dispatch on two
# data shards: each rank takes its rows of JAX's pipeline micro-batches
DROPOUT_MOE = dict(FOUR, attn_dropout=0.1, num_experts=4,
                   num_experts_per_tok=2, router_aux_weight=0.1,
                   moe_capacity_factor=1.0)


@functools.lru_cache(maxsize=None)
def _cached_params(items, seed):
    return _jax_params(dict(items), seed)


def _params(fields, seed=0):
    """The JAX weights of ``fields`` (made once a module run); a mixture
    of experts takes ``tests/test_torch_moe.py``'s widened weights."""
    if fields.get("num_experts"):
        from test_torch_moe import _params as moe_params
        return moe_params(fields, seed)
    return _cached_params(tuple(sorted(fields.items())), seed)


def _pp(size, micro, schedule="gpipe", virtual=1):
    return dict(size=size, num_micro_batches=micro, schedule=schedule,
                virtual_stages=virtual)


CASES = {  # name: (world, dist, model fields)
    "pp2_gpipe": (2, dict(pp=_pp(2, 2)), FOUR),
    "pp2_1f1b_dropout_tied": (2, dict(pp=_pp(2, 4, "1f1b")),
                              dict(FOUR, attn_dropout=0.1,
                                   tie_embeddings=True)),
    "pp2_v2_1f1b": (2, dict(pp=_pp(2, 2, "1f1b", 2)), FOUR),
    # grad_accum 2, an outer loop around the schedule as in JAX, each of
    # its micro-batches drawing its own dropout seed
    "pp2_1f1b_accum2_dropout": (2, dict(pp=_pp(2, 2, "1f1b")),
                                dict(FOUR, attn_dropout=0.1)),
    "pp4_1f1b_m8": (4, dict(pp=_pp(4, 8, "1f1b")), EIGHT),
    "pp2_dp2": (4, dict(dp=2, pp=_pp(2, 2, "1f1b")), FOUR),
    "pp2_fsdp2": (4, dict(fsdp=2, pp=_pp(2, 2)), FOUR),
    "pp2_fsdp2_v2_1f1b": (4, dict(fsdp=2, pp=_pp(2, 2, "1f1b", 2)), FOUR),
    "pp2_tp2_1f1b": (4, dict(tp=2, pp=_pp(2, 2, "1f1b")), WIDE),
    "pp2_sp2_ring_1f1b": (4, dict(sp=dict(size=2, mode="ring"),
                                  pp=_pp(2, 2, "1f1b")), FOUR),
    "pp2_dp2_1f1b_dropout_moe": (4, dict(dp=2, pp=_pp(2, 2, "1f1b")),
                                 DROPOUT_MOE),
}
# pp4_1f1b_m8's batches carry 8 rows, one a micro-batch
ROWS = {"pp4_1f1b_m8": 8}
# the cases that also run eval_step after their steps
EVAL = ("pp2_dp2",)
ACCUM = {"pp2_1f1b_accum2_dropout": 2}
# the cases that also decode, before their steps (same weights: FOUR)
DECODE = ("pp2_gpipe", "pp2_dp2", "pp2_fsdp2", "pp2_v2_1f1b")
DECODE_LENS, DECODE_NEW = (9, 5, 7), 6
HF_DIST = dict(pp=_pp(2, 2, "1f1b"))
INIT_DIST = dict(pp=_pp(2, 2, "1f1b", 2))


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _batches(name):
    rows = ROWS.get(name, 4)
    out = []
    for i in range(STEPS):
        b = _batch(60 + i)
        if rows > b["input_ids"].shape[0]:
            extra = _batch(160 + i)
            b = {k: np.concatenate([b[k], extra[k]]) for k in b}
        out.append(b)
    return out


def _specs(world):
    cases = {}
    for name, (w, d, fields) in CASES.items():
        if w == world:
            cases[name] = dict(
                kind="train", dist=d, model=fields, params=_params(fields),
                compute={}, grad_accum=ACCUM.get(name, 1),
                dtype=torch.float32, batches=_batches(name),
                schedule=SCHEDULE, opt=OPT_PP)
            if name in EVAL:
                cases[name]["eval_batch"] = _batch(90)
            if name in DECODE:
                ids, mask = _ragged_prompts()
                cases[name]["decode"] = dict(ids=ids, mask=mask,
                                             new=DECODE_NEW)
    if world == 2:
        cases["ckpt"] = dict(
            kind="train", dist=dict(pp=_pp(2, 2, "1f1b")),
            other_dist=dict(dp=2), model=FOUR, params=_params(FOUR),
            params_other=_params(FOUR, seed=1), compute={}, grad_accum=1,
            dtype=torch.float32, batches=_batches("ckpt"),
            schedule=SCHEDULE, opt=OPT_PP)
        cases["init"] = dict(kind="pp_init", dist=INIT_DIST, model=FOUR)
    return dict(kind="cases", cases=cases)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both launches, started together; ``ranks[world]()`` waits for one
    and returns its cases' outputs."""
    waits = {}
    for w in (2, 4):
        spec = _specs(w)
        if w == 2:
            spec["cases"]["ckpt"]["ckpt"] = str(
                tmp_path_factory.mktemp("pp_ckpt"))
            spec["cases"]["hf"] = _hf_spec(tmp_path_factory.mktemp("pp_hf"))
        waits[w] = _launch(tmp_path_factory.mktemp(f"pp{w}"), w, spec)
    got = {}

    def result(world):
        if world not in got:
            got[world] = waits[world]()
        return got[world]
    return {w: (lambda w=w: result(w)) for w in waits}


def _ragged_prompts():
    """Left-padded prompts of ``DECODE_LENS`` tokens and their mask."""
    rng = np.random.default_rng(41)
    p = max(DECODE_LENS)
    ids = np.zeros((len(DECODE_LENS), p), np.int64)
    mask = np.zeros((len(DECODE_LENS), p), np.int32)
    for r, n in enumerate(DECODE_LENS):
        ids[r, p - n:] = rng.integers(1, SMALL["vocab_size"], n)
        mask[r, p - n:] = 1
    return ids, mask


@functools.lru_cache(maxsize=None)
def _jax_decode():
    """JAX's greedy ``generate(prompt_mask=)`` of the ragged prompts on
    FOUR's weights (one device), and the prefill hidden of its
    ``pp_forward_with_cache`` on an emulated 'pp' mesh of 2."""
    import dataclasses
    from jax.sharding import Mesh
    from torchacc_tpu.models import TransformerLM as JaxLM
    from torchacc_tpu.models.generate import _prompt_geometry, _zoo_embed
    from torchacc_tpu.models.generate import generate as jax_generate
    from torchacc_tpu.parallel.pp import pp_forward_with_cache
    ids, mask = (jnp.asarray(a) for a in _ragged_prompts())
    params = jax.tree.map(jnp.asarray, _params(FOUR))
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, attention_impl="xla",
                      **FOUR)
    tokens = jax_generate(JaxLM(jcfg), params, ids.astype(jnp.int32),
                          prompt_mask=mask, max_new_tokens=DECODE_NEW)
    b, p = ids.shape
    blk = dataclasses.replace(jcfg, cache_len=p + DECODE_NEW)
    positions, _, seg = _prompt_geometry(ids, mask)
    x = _zoo_embed(jcfg, params, ids, positions)
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    hidden, _ = jax.jit(lambda lp, x: pp_forward_with_cache(
        blk, lp, None, x, positions, seg, 2, mesh=mesh))(
        params["layers"], x)
    return np.asarray(tokens), np.asarray(hidden)


@pytest.mark.parametrize("name", DECODE)
def test_pp_decode_matches_jax_generate(ranks, name):
    world, d, _ = CASES[name]
    want_tokens, want_hidden = _jax_decode()
    got = ranks[world]()[name]["decode"]
    virtual = d["pp"]["virtual_stages"]
    assert sorted(r["stage"] for r in got) == sorted(
        list(range(2)) * (world // 2))
    for r in got:
        np.testing.assert_array_equal(r["tokens"], want_tokens)
        np.testing.assert_allclose(r["hidden"], want_hidden, atol=2e-5)
        own = [c * 2 + r["stage"] for c in range(virtual)]
        own = sorted(i for c in own for i in range(
            c * 4 // (2 * virtual), (c + 1) * 4 // (2 * virtual)))
        assert r["blocks"] == own and r["cache"] == own


def _hf_spec(d):
    path = hf_saved(hf_model("llama32_tied_d64", seed=7), d / "hf",
                    torch.bfloat16, shard="300KB")
    return dict(kind="hf_train", path=path, dist=HF_DIST,
                schedule=HF_SCHEDULE, opt=OPT_PP,
                batches=[_hf_batch(80 + i) for i in range(2)])


def _jax_dist(d):
    return ta.DistConfig(dp=ta.DPConfig(d.get("dp", -1)),
                         fsdp=ta.FSDPConfig(d.get("fsdp", 1)),
                         tp=ta.TPConfig(d.get("tp", 1)),
                         sp=ta.SPConfig(**d.get("sp", {})),
                         pp=ta.PPConfig(**d["pp"]))


def _check_params(got, jtrainer):
    flat = jax.tree_util.tree_flatten_with_path
    want = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    assert [p for p, _ in flat(got)[0]] == [p for p, _ in flat(want)[0]]
    for (path, a), (_, w) in zip(flat(got)[0], flat(want)[0]):
        _close(a, w, jax.tree_util.keystr(path))


def _jax_trainer(world, d, fields, params, grad_accum=1):
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", attention_impl="xla"),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=_jax_dist(d), grad_accum=grad_accum)
    jtrainer, _ = jax_accelerate(
        jax_preset("llama-tiny", **fields), None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(*SCHEDULE),
                                  **OPT_PP),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:world]))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    return jtrainer


@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_training_matches_the_jax_trainer(ranks, name):
    world, d, fields = CASES[name]
    jtrainer = _jax_trainer(world, d, fields, _params(fields),
                            ACCUM.get(name, 1))
    jlosses = [float(jtrainer.step({k: jnp.asarray(v) for k, v in
                                    b.items()})["loss"])
               for b in _batches(name)]
    got = ranks[world]()[name]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    _check_params(got["params"], jtrainer)
    if name in EVAL:
        want = float(jtrainer.eval_step(
            {k: jnp.asarray(v) for k, v in _batch(90).items()}))
        np.testing.assert_allclose(got["eval"], want, rtol=1e-5)


def test_pp_hf_checkpoint_streams_into_the_stages(ranks, tmp_path):
    got = ranks[2]()["hf"]
    spec = _hf_spec(tmp_path)
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", param_dtype="float32",
                                 attention_impl="xla"),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=_jax_dist(HF_DIST))
    jt, _ = jax_accelerate(
        spec["path"], None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_linear(*HF_SCHEDULE),
                                  **OPT_PP),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:2]))
    jlosses = [float(jt.step({k: jnp.asarray(v) for k, v in b.items()})
                     ["loss"]) for b in spec["batches"]]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    _check_params(got["params"], jt)


def test_pp_checkpoint_resumes_bitwise_and_refuses_another_pp(ranks):
    got = ranks[2]()["ckpt"]
    assert got["resumed_equal"] == [True, True]
    assert got["other_layout"] == ("TopologyMismatchError", ["pp"])


def test_pp_init_holds_at_most_one_other_stage_block(ranks):
    got = ranks[2]()["init"]
    layers = [f"layers.{i}" for i in range(FOUR["num_layers"])]
    assert sorted(r["stage"] for r in got) == [0, 1]
    for r in got:
        seeded, empty = r[True], r[False]
        # the one-device order: every block drawn, the others released
        assert seeded["made"] == (["embed_tokens"] + layers
                                  + ["final_norm", "lm_head"])
        assert seeded["most_before"] == 0 and seeded["after"] == 0
        assert seeded["equal"]
        # storage only: this stage's blocks (V 2: d and d + 2) alone
        own = [f"layers.{r['stage']}", f"layers.{r['stage'] + 2}"]
        assert empty["made"] == ["embed_tokens"] + own + ["final_norm",
                                                          "lm_head"]
        assert empty["most_before"] == 0 and empty["after"] == 0
