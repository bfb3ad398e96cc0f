"""The port's fp16 step (the dynamic loss scaler of ``train/amp.py``)
and float16 attention against the JAX package, on the CPU.

``scaler_update`` is held bitwise over a grid of (finite, count) cases;
a short fp16 trajectory (with and without gradient accumulation) and
its ``loss_scale`` against the JAX Trainer; an overflow step (the port
of tests/test_amp.py:57-104) must leave the masters, both moments and the
optimizer's count as they were, bitwise, and halve the scale
(``compute.quant`` under float16 raises, so no history is at stake).  Plain attention in float16 against JAX's XLA path:
the forward at two f16 ulps (atol 2e-4 + rtol 2e-3; both compute in f32
and round o to f16 once), the gradients at two ulps of each leaf's
largest entry (JAX rounds its backward's intermediates to f16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.ops.attn import attention as jax_attention
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu.train.amp import scaler_update as jax_scaler_update
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.models.transformer import loss_sum_count
from torchacc_tpu_torch.ops.flash_attention import flash_attention
from torchacc_tpu_torch.train import accelerate, adamw, shift_labels
from torchacc_tpu_torch.train.amp import (
    all_finite,
    scaler_init,
    scaler_update,
)

F16_TOL = dict(atol=2e-4, rtol=2e-3)
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=128)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("scale,count,interval", [
    (1024.0, 0, 2000), (1024.0, 1, 2), (2.0 ** 24, 5, 6), (1.0, 3, 2000),
    (3.0, 1999, 2000), (65536.0, 0, 1)])
def test_scaler_update_matches_jax(finite, scale, count, interval):
    s = {"scale": torch.tensor(scale, dtype=torch.float32),
         "growth_count": torch.tensor(count, dtype=torch.int32)}
    js = {"scale": jnp.asarray(scale, jnp.float32),
          "growth_count": jnp.asarray(count, jnp.int32)}
    for _ in range(3):
        s = scaler_update(s, torch.tensor(finite), growth_interval=interval)
        js = jax_scaler_update(js, jnp.asarray(finite),
                               growth_interval=interval)
        for k in s:
            assert s[k].dtype == {"scale": torch.float32,
                                  "growth_count": torch.int32}[k]
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))


def test_scaler_init_all_finite_and_select():
    s = scaler_init(1024.0, device="cpu")
    assert s["scale"].item() == 1024.0 and s["growth_count"].item() == 0
    good = {"a": torch.ones(3), "b": torch.zeros(2)}
    bad = {"a": torch.tensor([1.0, float("inf"), 0.0]), "b": torch.zeros(2)}
    assert bool(all_finite(good.values()))
    assert not bool(all_finite(bad.values()))
    assert not bool(all_finite([torch.tensor([float("nan")])]))
    # the skip's select: AdamW.update_(keep=False) writes nothing and
    # keep=True is the plain update, bitwise
    opt = adamw(1e-2)
    runs = {}
    for keep in (None, torch.tensor(True), torch.tensor(False)):
        params = {k: v.clone() for k, v in good.items()}
        state = opt.init(params)
        opt.update_(bad if keep is not None and not keep else good, state,
                    params, keep=keep)
        runs[None if keep is None else bool(keep)] = (params, state)
    for k in good:
        assert torch.equal(runs[False][0][k], good[k])
        assert not runs[False][1].mu[k].any() and not runs[False][1].nu[k].any()
        assert torch.equal(runs[True][0][k], runs[None][0][k])
        assert torch.equal(runs[True][1].nu[k], runs[None][1].nu[k])
    assert (runs[False][1].count, runs[True][1].count,
            runs[None][1].count) == (0, 1, 1)


def _params(seed=0):
    from test_torch_model import seeded_jax_params
    return seeded_jax_params(seed, **SMALL)


def _batches(n, seed=0, rows=8):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 128, size=(4, 32))
    return [{"input_ids": data[rng.integers(0, 4, size=rows)].astype(
        np.int32)} for _ in range(n)]


def _fp16_trainers(params, grad_accum=1, **kw):
    opt = dict(weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
               grad_clip_norm=None)
    jconf = ta.Config(compute=ta.ComputeConfig(dtype="float16",
                                               attention_impl="xla"),
                      grad_accum=grad_accum)
    jtrainer, _ = jax_accelerate(
        jax_preset("llama-tiny", **SMALL), None, jconf,
        optimizer=jax_sched.adamw(1e-3, **opt),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]), **kw)
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float16),
                     grad_accum=grad_accum)
    model = params_from_jax(get_preset("llama-tiny", **SMALL), params,
                            device="cpu", trainable=True)
    trainer, _ = accelerate(model, None, conf, optimizer=adamw(1e-3, **opt),
                            **kw)
    trainer.init()
    return jtrainer, trainer


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_fp16_trajectory_and_loss_scale_match_jax(grad_accum):
    """Six fp16 steps from the same weights: the loss within rtol 2e-3
    (f16 activations rounded in another order), the loss scale bitwise
    (with grad_accum 2 the summed loss overflows at the first scales, so
    both packages halve it and skip those steps), the optimizer's count
    the steps that applied; the loss falls."""
    jtrainer, trainer = _fp16_trainers(_params(), grad_accum)
    assert trainer.state.scaler["scale"].item() == 2.0 ** 15
    losses, applied, scale = [], 0, 2.0 ** 15
    for i, b in enumerate(_batches(6)):
        jm = jtrainer.step({k: jnp.asarray(v) for k, v in b.items()})
        m = trainer.step(b)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=2e-3, err_msg=f"step {i}")
        assert m["loss_scale"].item() == float(jm["loss_scale"])
        assert m["loss_scale"] is trainer.state.scaler["scale"]
        if m["loss_scale"].item() == scale:
            applied += 1
            losses.append(m["loss"].item())
        scale = m["loss_scale"].item()
    assert trainer.state.opt_state.count == applied >= 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _exploding_loss(logits, batch):
    """tests/test_amp.py's: the loss times 3e38 squared (inf in f32)
    where the batch's ``bomb`` is set."""
    labels = batch.get("labels", shift_labels(batch["input_ids"]))
    l_sum, count = loss_sum_count(logits, labels)
    bomb = torch.where(batch["bomb"][0, 0] > 0, 3e38, 1.0)
    return l_sum * bomb * bomb, count


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_fp16_overflow_skips_the_step_bitwise(grad_accum):
    """An overflowing step leaves the masters, both moments and the
    optimizer's count bitwise as they were and halves the scale, as in
    JAX; the next step trains again."""
    _, trainer = _fp16_trainers(_params(), grad_accum, loss=_exploding_loss)
    b0, b1 = _batches(2)
    calm = dict(b0, bomb=np.zeros((8, 32), np.int32))
    st = trainer.state
    while st.opt_state.count == 0:        # until a step applies
        trainer.step(calm)
        assert st.step <= 6
    before = {n: p.clone() for n, p in st.params.items()}
    mu = {n: t.clone() for n, t in st.opt_state.mu.items()}
    nu = {n: t.clone() for n, t in st.opt_state.nu.items()}
    count, scale = st.opt_state.count, st.scaler["scale"].item()
    m = trainer.step(dict(b1, bomb=np.ones((8, 32), np.int32)))
    assert not np.isfinite(m["grad_norm"].item())
    for n in before:
        assert torch.equal(st.params[n], before[n]), n
        assert torch.equal(st.opt_state.mu[n], mu[n]), n
        assert torch.equal(st.opt_state.nu[n], nu[n]), n
    assert st.opt_state.count == count == 1
    assert st.scaler["scale"].item() == scale / 2
    trainer.step(calm)                       # recovers
    assert st.opt_state.count == 2
    assert any(not torch.equal(st.params[n], before[n]) for n in before)
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, st.params[n])


@pytest.mark.parametrize("case", ["causal_gqa", "segments", "softcap"])
def test_f16_plain_attention_matches_jax_xla(case):
    """float16 q/k/v through the port's plain path and JAX's XLA path:
    o and the gradients of q, k, v at two f16 ulps."""
    rng = np.random.default_rng({"causal_gqa": 1, "segments": 2,
                                 "softcap": 3}[case])
    b, s, hq, hk, d = 2, 96, 8, 2, 32
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float16)
    q, k, v, do = arr(b, s, hq, d), arr(b, s, hk, d), arr(b, s, hk, d), \
        arr(b, s, hq, d)
    kw = {}
    if case == "softcap":
        kw["logit_softcap"] = 5.0
    seg = None
    if case == "segments":
        seg = np.repeat(np.arange(6, dtype=np.int32), s // 6)[None].repeat(
            b, 0)
    jseg = {} if seg is None else dict(q_segment_ids=jnp.asarray(seg),
                                       kv_segment_ids=jnp.asarray(seg))
    tseg = {} if seg is None else dict(
        q_segment_ids=torch.from_numpy(seg),
        kv_segment_ids=torch.from_numpy(seg))

    def jfn(q_, k_, v_):
        return jax_attention(q_, k_, v_, impl="xla", **jseg, **kw)
    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = flash_attention(tq, tk, tv, **tseg, **kw)
    assert to.dtype == torch.float16
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    for name, a, r in zip(("o", "dq", "dk", "dv"), (to,) + tgrads,
                          (jo,) + tuple(jgrads)):
        assert a.dtype == torch.float16, name
        r = np.asarray(r, np.float32)
        # the gradients: JAX's XLA backward rounds its intermediates to
        # f16 on the way, so an entry may sit one ulp of the leaf's
        # largest entry away (read: 0.00195 at a largest |dq| of 3.47)
        tol = F16_TOL if name == "o" else dict(
            atol=2e-3 * float(np.abs(r).max()), rtol=2e-3)
        np.testing.assert_allclose(a.detach().float().numpy(), r, **tol,
                                   err_msg=name)
