"""The port's mixture of experts (``torchacc_tpu_torch/models/moe.py``)
against the JAX package's (``torchacc_tpu/models/moe.py``), on the CPU
in f32.

- ``MoEMlp`` alone: its output, router loss and every gradient against
  JAX's module, under dense dispatch and capacity dispatch with a tight
  factor (claims are dropped) and a loose one (none are), under both
  ``moe_dispatch`` mechanisms of JAX and both top-k conventions.  The
  inputs are drawn so that each token's k-th and (k+1)-th router logits
  are at least 1e-2 apart, and the routing choices are held equal
  first: a near-tie flips an expert discretely, which no tolerance
  covers.  Tolerances: the output and the gradients within 1e-5 of
  each one's largest entry, the router loss rtol 1e-6 (read <= 4.8e-6
  and 0 on the scratch runs: the packages sum the same products in
  other orders).
- A 2-layer MoE llama-tiny through ``accelerate()`` -> ``Trainer.step``
  against the JAX Trainer, 3 steps from the same weights, under
  capacity dispatch: with ``gc_cls=['MoEMlp']`` and ``gc_cnt``, and
  with ``grad_accum`` 2 on one shard and the router loss at weight 0.5
  (dense dispatch trains in ``tests/test_torch_pp.py`` and
  ``tests/test_torch_parallel_ranks.py``).  The router weights are drawn 25 times wider than the init so
  that no routing sits near a tie, the experts 4 times wider so that
  they weigh in the loss.  The losses rtol 1e-5 and the final
  parameters within 1e-5 of each leaf's largest entry (the tolerances
  of ``tests/test_torch_parallel_ranks.py``).
- Each knob that was inert while the experts were refused
  (``num_experts_per_tok``, ``router_aux_weight``, ``moe_renorm_topk``,
  ``moe_capacity_factor``) changes the loss by more than 1e-5 of it
  (read >= 7.6e-5, ``moe_renorm_topk``: the sharp router's top-2
  probabilities nearly sum to one), and the changed loss is JAX's
  (rtol 1e-6, read <= 1.8e-7).
- ``generate()``: greedy tokens identical to JAX's under capacity
  dispatch, whose cap each call takes from its own tokens.
- The configuration: ``EPConfig`` validation message for message with
  JAX's, the ``mixtral-8x7b`` preset field for field, the fold of
  ``ep.capacity_factor`` into the model, and what raises by name (a
  bad ``moe_dispatch``, an expert count 'ep' does not divide, a mixture
  of experts with ``grad_accum`` on more than one data shard, serving).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.generate import generate as jax_generate
from torchacc_tpu.models.moe import MoEMlp as JaxMoE
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu.train.accelerate import (
    apply_config_to_model as jax_apply_config,
)
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.models import generate, get_preset, init_params
from torchacc_tpu_torch.models import params_from_jax
from torchacc_tpu_torch.models.convert import params_to_jax
from torchacc_tpu_torch.models.moe import MoEMlp, route, slot_positions
from torchacc_tpu_torch.ops.flash_attention import segment_ids_from_positions
from torchacc_tpu_torch.parallel.sharding import _check_plan, make_rules
from torchacc_tpu_torch.train import accelerate, adamw
from torchacc_tpu_torch.train import schedules as port_sched
from torchacc_tpu_torch.train.accelerate import apply_config_to_model

E, H, F = 4, 32, 48
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=96, num_experts=4,
             num_experts_per_tok=2)
B, S = 4, 16
OPT = dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-2, grad_clip_norm=1.0)
SCHEDULE = (3e-3, 10, 1)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _close(a, want, what, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(a), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


# -- MoEMlp ------------------------------------------------------------------

MLP_CASES = {  # name: (moe_capacity_factor, moe_renorm_topk, moe_dispatch)
    "dense_renorm": (None, True, "auto"),
    "dense_softmax": (None, False, "auto"),
    "tight_einsum": (0.5, True, "einsum"),
    "tight_sort_softmax": (0.5, False, "sort"),
    "loose_sort": (2.0, True, "sort"),
}


def _mlp_inputs(seed, k=2, margin=1e-2):
    """The router kernel, the experts and x ``[2, 12, H]``, redrawn token
    by token until every k-th and (k+1)-th logit are ``margin`` apart."""
    rng = np.random.default_rng(seed)
    router = (0.5 * rng.standard_normal((H, E))).astype(np.float32)
    experts = {n: (0.2 * rng.standard_normal(shape)).astype(np.float32)
               for n, shape in (("gate", (E, H, F)), ("up", (E, H, F)),
                                ("down", (E, F, H)))}
    x = rng.standard_normal((2, 12, H)).astype(np.float32)
    for _ in range(100):
        top = -np.sort(-(x.astype(np.float64) @ router), axis=-1)
        near = (top[..., k - 1] - top[..., k]) < margin
        if not near.any():
            break
        x[near] = rng.standard_normal((int(near.sum()), H))
    assert not near.any()
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return router, experts, x, cot


@pytest.mark.parametrize("name", sorted(MLP_CASES))
def test_moe_mlp_output_and_gradients_match_jax(name):
    cf, renorm, dispatch = MLP_CASES[name]
    fields = dict(SMALL, hidden_size=H, intermediate_size=F,
                  moe_capacity_factor=cf, moe_renorm_topk=renorm,
                  moe_dispatch=dispatch)
    router, experts, x, cot = _mlp_inputs(sorted(MLP_CASES).index(name))
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, **fields)
    cfg = get_preset("llama-tiny", dtype=torch.float32, **fields)
    jparams = {"router": {"kernel": router},
               **{f"experts/{n}": w for n, w in experts.items()}}

    # the routing first: the same experts for every token
    logits = torch.from_numpy(x.reshape(-1, H)) @ torch.from_numpy(router)
    _, sel = route(cfg, logits)
    jlogits = jnp.asarray(x.reshape(-1, H)) @ jnp.asarray(router)
    jsel = jax.lax.top_k(jlogits if renorm else jax.nn.softmax(jlogits),
                         2)[1]
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    if cf is not None:
        cap = max(int(np.ceil(cf * 2 * x.shape[0] * x.shape[1] / E)), 1)
        dropped = int((slot_positions(sel, E) >= cap).sum())
        assert (dropped > 0) == (cf < 1.0), dropped

    def jloss(p, xx):
        y, st = JaxMoE(jcfg).apply({"params": p}, xx,
                                   mutable=["intermediates"])
        aux = st["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(y * jnp.asarray(cot)) + 3.0 * aux, (y, aux)
    (_, (jy, jaux)), (jg, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))

    mod = MoEMlp(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        mod.router.weight.copy_(torch.from_numpy(router.T))
        for n, w in experts.items():
            getattr(mod.experts, n).copy_(
                torch.from_numpy(np.swapaxes(w, 1, 2)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = mod(xt)
    (torch.sum(y * torch.from_numpy(cot)) + 3.0 * aux).backward()
    _close(y.detach(), jy, "y")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    _close(xt.grad, jdx, "dx")
    _close(mod.router.weight.grad.T, jg["router"]["kernel"], "d router")
    for n in experts:
        _close(np.swapaxes(getattr(mod.experts, n).grad.numpy(), 1, 2),
               jg[f"experts/{n}"], f"d experts/{n}")


# -- a tiny MoE model through accelerate() ------------------------------------

def _batch(seed):
    rng = np.random.default_rng(seed)
    pos = []
    for _ in range(B):
        p = []
        while len(p) < S:
            p += list(range(int(rng.integers(3, 12))))
        pos.append(p[:S])
    pos = np.asarray(pos, np.int32)
    seg = segment_ids_from_positions(torch.from_numpy(pos)).numpy()
    ids = rng.integers(0, SMALL["vocab_size"], size=(B, S)).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "segment_ids": seg}


def _params(fields, seed=0):
    """Seeded weights in JAX's layout (the port's init carried over),
    the router 25 times and the experts 4 times wider than the init, so
    that the experts weigh in the loss."""
    cfg = get_preset("llama-tiny", dtype=torch.float32, **fields)
    tree = params_to_jax(cfg, dict(init_params(cfg, seed=seed,
                                               device="cpu")
                                   .named_parameters()))
    moe = tree["layers"]["block"]["moe"]
    moe["router"]["kernel"] = moe["router"]["kernel"] * 25.0
    for n in ("gate", "up", "down"):
        moe[f"experts/{n}"] = moe[f"experts/{n}"] * 4.0
    return tree


TRAIN_CASES = {  # name: (model fields, memory fields, grad_accum)
    "capacity_remat_moemlp_gc_cnt": (
        dict(moe_capacity_factor=1.0), dict(gc=True, gc_cls=["MoEMlp"],
                                            gc_cnt=1), 1),
    # the router loss at a weight that moves the loss, each micro-batch
    # with its own cap
    "grad_accum2_aux": (dict(moe_capacity_factor=1.25,
                             router_aux_weight=0.5), {}, 2),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_tiny_moe_trainer_matches_jax_trainer(name):
    fields, mem, accum = TRAIN_CASES[name]
    fields = dict(SMALL, **fields)
    params = _params(fields)
    batches = [_batch(40 + i) for i in range(3)]
    jconf = ta.Config(compute=ta.ComputeConfig(dtype="float32",
                                               attention_impl="xla"),
                      memory=ta.MemoryConfig(**mem), grad_accum=accum)
    jt, _ = jax_accelerate(
        jax_preset("llama-tiny", **fields), None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(*SCHEDULE), **OPT),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]))
    jt.init_from_params(jax.tree.map(jnp.asarray, params))
    jlosses = [float(jt.step({k: jnp.asarray(v) for k, v in b.items()})
                     ["loss"]) for b in batches]

    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32),
                     memory=tt.MemoryConfig(**mem), grad_accum=accum)
    cfg = get_preset("llama-tiny", dtype=torch.float32, **fields)
    trainer, _ = accelerate(
        params_from_jax(cfg, params, device="cpu", trainable=True), None,
        conf, optimizer=adamw(port_sched.warmup_cosine(*SCHEDULE), **OPT))
    if mem:
        assert trainer.model.cfg.remat_cls == ("MoEMlp",)
    losses = [trainer.step(b)["loss"].item() for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = params_to_jax(trainer.model.cfg, trainer.state.params)
    want = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    flat = jax.tree_util.tree_flatten_with_path
    assert [p for p, _ in flat(got)[0]] == [p for p, _ in flat(want)[0]]
    for (path, a), (_, w) in zip(flat(got)[0], flat(want)[0]):
        _close(a, w, jax.tree_util.keystr(path))


KNOBS = {
    "num_experts_per_tok": 3,
    "router_aux_weight": 2.0,
    "moe_renorm_topk": False,
    "moe_capacity_factor": 0.5,
}


def _jax_loss(fields, params, batch):
    jconf = ta.Config(compute=ta.ComputeConfig(dtype="float32",
                                               attention_impl="xla"))
    jt, _ = jax_accelerate(jax_preset("llama-tiny", **fields), None, jconf,
                           mesh=build_mesh(jconf.dist,
                                           devices=jax.devices()[:1]))
    l_sum, count, _ = jt._forward_sum_count(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(l_sum / count)


def _port_loss(fields, params, batch):
    cfg = get_preset("llama-tiny", dtype=torch.float32, **fields)
    trainer, _ = accelerate(
        params_from_jax(cfg, params, device="cpu", trainable=True), None,
        tt.Config(compute=tt.ComputeConfig(dtype=torch.float32)))
    trainer.init()
    return trainer.eval_step(batch)["loss"].item()


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_formerly_inert_knob_changes_the_loss_and_matches_jax(knob):
    base = dict(SMALL, num_layers=1, router_aux_weight=0.5)
    params = _params(base, seed=3)
    batch = _batch(50)
    changed = dict(base, **{knob: KNOBS[knob]})
    before = _port_loss(base, params, batch)
    after = _port_loss(changed, params, batch)
    assert abs(after - before) > 1e-5 * abs(before), (before, after)
    np.testing.assert_allclose(after, _jax_loss(changed, params, batch),
                               rtol=1e-6)


def test_generate_token_identical_to_jax():
    """Greedy decode under capacity dispatch: the prefill routes 2 x 12
    tokens, each decode step 2, each with its own cap."""
    fields = dict(SMALL, moe_capacity_factor=1.0)
    params = _params(fields, seed=7)
    prompts = np.random.default_rng(8).integers(
        0, SMALL["vocab_size"], (2, 12)).astype(np.int32)
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, attention_impl="xla",
                      **fields)
    want = np.asarray(jax_generate(JaxLM(jcfg),
                                   jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(prompts), max_new_tokens=6))
    cfg = get_preset("llama-tiny", dtype=torch.float32, **fields)
    got = generate(params_from_jax(cfg, params, device="cpu"), prompts,
                   max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, want)


# -- configuration ----------------------------------------------------------------

def _outcome(fn):
    try:
        fn()
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("fields", [dict(size=2), dict(capacity_factor=1.25),
                                    dict(capacity_factor=0.0),
                                    dict(size=0)])
def test_ep_config_validates_as_jax(fields):
    assert _outcome(tt.EPConfig(**fields).validate) == \
        _outcome(ta.EPConfig(**fields).validate)


def test_mixtral_preset_and_capacity_fold_match_jax():
    port, jax_cfg = get_preset("mixtral-8x7b"), jax_preset("mixtral-8x7b")
    for f in dataclasses.fields(port):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    assert port.num_params() == jax_cfg.num_params()
    for model_cf in (None, 2.0):
        conf = tt.Config(dist=tt.DistConfig(ep=tt.EPConfig(
            capacity_factor=1.25)))
        jconf = ta.Config(dist=ta.DistConfig(ep=ta.EPConfig(
            capacity_factor=1.25)))
        got = apply_config_to_model(dataclasses.replace(
            port, moe_capacity_factor=model_cf), conf)
        want = jax_apply_config(dataclasses.replace(
            jax_cfg, moe_capacity_factor=model_cf), jconf)
        assert got.moe_capacity_factor == want.moe_capacity_factor
    dense = apply_config_to_model(get_preset("llama-tiny"), conf)
    assert dense.moe_capacity_factor is None


def test_what_raises_by_name():
    cfg = get_preset("llama-tiny", dtype=torch.float32,
                     **dict(SMALL, moe_dispatch="scatter"))
    with pytest.raises(ValueError, match="moe_dispatch must be"):
        tt.TransformerLM(cfg, device="cpu")(torch.zeros((1, 8),
                                                        dtype=torch.long))
    sizes = dict(dp=1, pp=1, fsdp=1, sp=1, spu=1, ep=3, tp=1)
    moe = get_preset("llama-tiny", **SMALL)
    with pytest.raises(NotImplementedError,
                       match="num_experts 4 is not divisible by ep 3.*A8b"):
        _check_plan(moe, make_rules(), sizes)
    # grad_accum and 'pp' on more than one data shard take JAX's rows
    # (tests/test_torch_parallel_ranks.py, tests/test_torch_pp_ranks.py)
    _check_plan(moe, make_rules(), dict(sizes, ep=1, dp=2))
    _check_plan(dataclasses.replace(moe, num_layers=2, pp_size=2),
                make_rules(), dict(sizes, ep=1, dp=2, pp=2))
    with pytest.raises(NotImplementedError, match="num_experts=4.*generate"):
        tt.ServeEngine(init_params(moe, device="cpu"), tt.Config(),
                       device="cpu")
