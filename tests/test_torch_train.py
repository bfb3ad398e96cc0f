"""The port's training slice against the JAX package, on the CPU in f32,
on ``llama_tiny`` (torchacc_tpu/models/presets.py:30; vocab 32000,
hidden 256, 4 layers, 8/4 heads of 32).  The JAX side runs
``attention_impl='pallas'``, so its attention is kernels B1-B3 in
interpret mode.  Weights go from JAX to the port with
``params_from_jax``; gradients come back with ``params_to_jax``; every
input is made from a numpy seed.

Tolerances, f32 throughout: logits atol 2e-5; parameter gradients rtol
2e-3 against each leaf's largest entry (JAX's flash kernels and XLA's
fused dots sum in other orders than the port's dense einsums and
matmuls, and the differences grow through 4 layers of backward); the
fused CE loss rtol 1e-6, its gradients rtol 1e-5 + atol 1e-6 (chunked
f32 matmuls summed in another order); the optimizer chain
rtol 1e-5 over 4 updates; the 5-step loss trajectory rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.transformer import loss_sum_count as jax_loss
from torchacc_tpu.ops.fused import (
    fused_linear_cross_entropy as jax_fused_ce,
)
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu.train.trainer import shift_labels as jax_shift_labels
import torchacc_tpu_torch as tt
import torchacc_tpu_torch.ops.flash_attention as fa
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.models.convert import params_to_jax
from torchacc_tpu_torch.models.transformer import (
    TransformerLM,
    loss_fn,
    loss_sum_count,
)
from torchacc_tpu_torch.ops.flash_attention import segment_ids_from_positions
from torchacc_tpu_torch.ops.fused import fused_linear_cross_entropy
from torchacc_tpu_torch.train import accelerate, adamw, shift_labels
from torchacc_tpu_torch.train import schedules as port_sched

B, S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _batch(seed, vocab=32000):
    """input_ids, positions and segment ids of documents of random
    lengths packed into [B, S]."""
    rng = np.random.default_rng(seed)
    pos = []
    for _ in range(B):
        p = []
        while len(p) < S:
            p += list(range(int(rng.integers(5, 40))))
        pos.append(p[:S])
    pos = np.asarray(pos, np.int32)
    seg = segment_ids_from_positions(torch.from_numpy(pos)).numpy()
    ids = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "segment_ids": seg}


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params as numpy, port cfg) for llama_tiny in f32."""
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32,
                      attention_impl="pallas")
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = get_preset("llama-tiny", dtype=torch.float32)
    return jcfg, jax.tree.map(np.asarray, params), cfg


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_transformer_default_device_is_the_card():
    cfg = get_preset("llama-tiny", num_layers=1)
    if torch.cuda.is_available():
        assert TransformerLM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TransformerLM(cfg)
    assert TransformerLM(cfg, device="meta").device.type == "meta"
    assert TransformerLM(cfg, device="cpu").device.type == "cpu"


def test_logits_and_every_gradient_match_jax(tiny):
    jcfg, params, cfg = tiny
    batch = _batch(0)
    labels = np.array(jax_shift_labels(jnp.asarray(batch["input_ids"]),
                                       jnp.asarray(batch["segment_ids"])))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits = JaxLM(jcfg).apply(
            {"params": p}, jb["input_ids"], positions=jb["positions"],
            segment_ids=jb["segment_ids"])
        s, c = jax_loss(logits, jnp.asarray(labels))
        return s / c, logits
    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tb["input_ids"], tb["positions"], tb["segment_ids"])
    loss = loss_fn(logits, torch.from_numpy(labels).long())
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    got = params_to_jax(cfg, {n: p.grad for n, p in model.named_parameters()})
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    have = _leaves(got)
    assert len(have) == len(want) == 12
    for path, g in have:
        ref = want[path]
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(g, ref, atol=2e-3 * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("seed", [0, 41])
def test_attn_dropout_matches_jax_for_the_same_seed(tiny, seed):
    """llama-tiny with attn_dropout = 0.1: for the same dropout_seed the
    port's per-layer seeds and keep masks are the JAX model's, so logits
    and gradients agree as they do without dropout; with no seed
    (evaluation) dropout is off."""
    jcfg, params, cfg = tiny
    jcfg = dataclasses.replace(jcfg, attn_dropout=0.1)
    cfg = dataclasses.replace(cfg, attn_dropout=0.1)
    batch = _batch(6)
    labels = np.array(jax_shift_labels(jnp.asarray(batch["input_ids"]),
                                       jnp.asarray(batch["segment_ids"])))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p, dropout_seed):
        logits = JaxLM(jcfg).apply(
            {"params": p}, jb["input_ids"], positions=jb["positions"],
            segment_ids=jb["segment_ids"], dropout_seed=dropout_seed)
        s, c = jax_loss(logits, jnp.asarray(labels))
        return s / c, logits
    jp = jax.tree.map(jnp.asarray, params)
    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jp, jnp.asarray(seed, jnp.int32))
    _, jplain = jloss(jp, None)

    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tb["input_ids"], tb["positions"], tb["segment_ids"],
                   dropout_seed=seed)
    loss_fn(logits, torch.from_numpy(labels).long()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5)
    assert np.abs(np.asarray(jlogits) - np.asarray(jplain)).max() > 1e-3
    with torch.no_grad():
        plain = model(tb["input_ids"], tb["positions"], tb["segment_ids"])
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), atol=2e-5)
    got = params_to_jax(cfg, {n: p.grad for n, p in model.named_parameters()})
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    for path, g in _leaves(got):
        ref = want[path]
        np.testing.assert_allclose(g, ref, atol=2e-3 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_trainer_seeds_dropout_with_the_step_on_train_steps_only():
    mc = get_preset("llama-tiny", num_layers=2, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128,
                    attn_dropout=0.2)
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32))
    trainer, _ = accelerate(mc, None, conf, device="cpu")
    trainer.init()
    seen = []
    fwd = trainer.model.forward

    def spy(*a, **k):
        seen.append(k.get("dropout_seed"))
        return fwd(*a, **k)
    trainer.model.forward = spy
    batch = _batch(7, vocab=128)
    for _ in range(3):
        trainer.step(batch)
    e1 = trainer.eval_step(batch)["loss"].item()
    e2 = trainer.eval_step(batch)["loss"].item()
    assert seen == [0, 1, 2, None, None] and e1 == e2


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_fused_ce_matches_jax(cap):
    rng = np.random.default_rng(1)
    n_rows, h, v = 300, 64, 1000
    hidden = rng.standard_normal((3, 100, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, size=(3, 100)).astype(np.int32)
    labels[rng.random((3, 100)) < 0.2] = -100

    def jf(x, w_):
        return jax_fused_ce(x, w_, jnp.asarray(labels), chunk_rows=64,
                            logit_softcap=cap)
    (jl, jc), jvjp = jax.vjp(jf, jnp.asarray(hidden), jnp.asarray(w))
    jdh, jdw = jvjp((jnp.ones(()), jnp.zeros(())))

    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, tc = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                        chunk_rows=64, logit_softcap=cap)
    tl.backward()
    assert tc.item() == float(jc) == (labels != -100).sum()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-6)
    assert n_rows % 64  # the last chunk is ragged
    # the materialised loss agrees too
    logits = th.detach() @ tw.detach()
    if cap:
        logits = torch.tanh(logits / cap) * cap
    ls, lc = loss_sum_count(logits, torch.from_numpy(labels).long())
    np.testing.assert_allclose(ls.item(), tl.item(), rtol=1e-6)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_fused_ce_bf16_matches_jax(cap):
    """bf16 hidden and head: each chunk's logits are f32 from the bf16
    operands on both sides, so the loss agrees to f32 summation order
    (rtol 1e-6; logits rounded to bf16 first part from JAX by ~3e-5).
    JAX's VJP returns the gradients in bf16 and sums dw over the chunks
    in bf16; the port rounds dz to bf16 before its bf16 matmuls and sums
    dw in f32: within two bf16 steps of the largest entry (atol 2e-2 of
    max |ref|) plus one of the entry (rtol 1e-2)."""
    rng = np.random.default_rng(1)
    h, v = 64, 1000
    hidden = rng.standard_normal((3, 100, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, size=(3, 100)).astype(np.int32)
    labels[rng.random((3, 100)) < 0.2] = -100
    jh = jnp.asarray(hidden).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)

    def jf(x, w_):
        return jax_fused_ce(x, w_, jnp.asarray(labels), chunk_rows=64,
                            logit_softcap=cap)
    (jl, jc), jvjp = jax.vjp(jf, jh, jw)
    jdh, jdw = jvjp((jnp.ones(()), jnp.zeros(())))

    th = torch.from_numpy(hidden).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    tl, tc = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                        chunk_rows=64, logit_softcap=cap)
    tl.backward()
    assert tl.dtype == torch.float32 and tc.item() == float(jc)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for got, want in ((th.grad, jdh), (tw.grad, jdw)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                                   atol=2e-2 * np.abs(want).max())


def test_shift_labels_with_segments_matches_jax():
    batch = _batch(2)
    seg = batch["segment_ids"].copy()
    seg[1, -7:] = -1                          # padding at the end
    want = np.asarray(jax_shift_labels(jnp.asarray(batch["input_ids"]),
                                       jnp.asarray(seg)))
    got = shift_labels(torch.from_numpy(batch["input_ids"]),
                       torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        shift_labels(torch.from_numpy(batch["input_ids"])).numpy(),
        np.asarray(jax_shift_labels(jnp.asarray(batch["input_ids"]))))


@pytest.mark.parametrize("warmup,clip", [(0, 1.0), (2, 0.05), (1, None)])
def test_adamw_chain_matches_optax(warmup, clip):
    """schedules.adamw against the JAX package's optax chain over four
    updates, clipping active in the second case."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(4)]
    kw = dict(weight_decay=0.1, b1=0.9, b2=0.95, eps=1e-8,
              grad_clip_norm=clip)
    jtx = jax_sched.adamw(jax_sched.warmup_cosine(1e-2, 10, warmup), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    ttx = adamw(port_sched.warmup_cosine(1e-2, 10, warmup), **kw)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ts = ttx.init(tp)
    for g in grads:
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        norm = ttx.update_({n: torch.from_numpy(a) for n, a in g.items()},
                           ts, tp)
        np.testing.assert_allclose(
            norm.item(), np.sqrt(sum((a ** 2).sum() for a in g.values())),
            rtol=1e-6)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=1e-5, atol=1e-7)
    for step in range(12):
        np.testing.assert_allclose(
            port_sched.warmup_cosine(1e-2, 10, warmup)(step),
            float(jax_sched.warmup_cosine(1e-2, 10, warmup)(step)),
            rtol=1e-6, atol=1e-9)


# (policy, gc_cls, gc_cnt) -> flash forward runs in one step of 2 layers
REMAT_CASES = {
    ("nothing", None, None): 4,
    ("save_attn", None, None): 2,
    ("save_attn_mlp", None, None): 2,
    ("dots", None, None): 4,
    ("dots_with_no_batch_dims", None, None): 4,
    ("offload_dots", None, None): 4,
    ("nothing", ("Attention",), None): 4,
    ("nothing", ("Mlp",), None): 2,
    ("offload_dots", ("Attention", "Mlp"), None): 4,
    ("save_attn", ("Block",), None): 2,
    ("nothing", None, 1): 3,
    ("offload_dots", ("Mlp",), 1): 2,
}


@pytest.mark.parametrize("policy,gc_cls,gc_cnt", sorted(
    REMAT_CASES, key=str), ids=lambda x: str(x))
def test_remat_policies_match_no_remat_and_save_the_forward(
        tiny, monkeypatch, policy, gc_cls, gc_cnt):
    """Every policy, with remat over the whole block or only its
    attention and/or MLP (gc_cls) and over the first gc_cnt layers,
    gives the gradients of no remat; 'save_attn*' run the attention
    forward once per layer, 'nothing', 'dots*' and 'offload_dots' twice
    where they cover the attention (it re-runs in the backward's
    recompute, as JAX's Pallas kernel does)."""
    import torchacc_tpu_torch.utils.remat as remat
    _, params, cfg = tiny
    cfg = dataclasses.replace(cfg, num_layers=2)
    params = jax.tree.map(lambda a: a, params)
    blk = params["layers"]["block"]
    params = dict(params, layers={"block": jax.tree.map(lambda a: a[:2],
                                                        blk)})
    tb = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    labels = shift_labels(tb["input_ids"], tb["segment_ids"])
    calls = {"n": 0}
    ref_fwd = fa.attention_reference

    def counting(*a, **k):
        calls["n"] += 1
        return ref_fwd(*a, **k)
    monkeypatch.setattr(fa, "attention_reference", counting)

    grads, counts = {}, {}
    remat.offload_counts.update(to_host_bytes=0, to_device_bytes=0)
    for key in (None, (policy, gc_cls, gc_cnt)):
        c = cfg if key is None else dataclasses.replace(
            cfg, remat=True, remat_policy=policy, remat_cls=gc_cls,
            remat_cnt=gc_cnt)
        model = params_from_jax(c, params, device="cpu", trainable=True)
        calls["n"] = 0
        loss_fn(model(tb["input_ids"], tb["positions"], tb["segment_ids"]),
                labels).backward()
        counts[key] = calls["n"]
        grads[key] = [p.grad for p in model.parameters()]
    assert counts[None] == 2
    assert counts[(policy, gc_cls, gc_cnt)] == REMAT_CASES[
        (policy, gc_cls, gc_cnt)]
    for a, b in zip(grads[(policy, gc_cls, gc_cnt)], grads[None]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    # offload: attn_out and/or mlp_out of each covered layer, to host and
    # back (B x S x hidden f32 each)
    sites = 0
    if policy == "offload_dots":
        layers = 2 if gc_cnt is None else gc_cnt
        sites = layers * (2 if not gc_cls or "Block" in gc_cls
                          else len(gc_cls))
    want = sites * B * S * cfg.hidden_size * 4
    assert remat.offload_counts == {"to_host_bytes": want,
                                    "to_device_bytes": want}


def test_trainer_trajectory_matches_jax_trainer(tiny):
    """Five steps of accelerate() -> Trainer.step against the JAX
    Trainer (B1-B3 in interpret mode, fused CE, save_attn_mlp remat),
    from the same weights, on the same packed batches."""
    jcfg_model, params, cfg = tiny
    batches = [_batch(10 + i) for i in range(5)]
    opt = dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8,
               grad_clip_norm=1.0)

    jconf = ta.Config(compute=ta.ComputeConfig(dtype="float32",
                                               attention_impl="pallas"),
                      memory=ta.MemoryConfig(gc=True,
                                             gc_policy="save_attn_mlp"))
    jtrainer, _ = jax_accelerate(
        jax_preset("llama-tiny"), None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(3e-3, 10, 1),
                                  **opt),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]))
    assert jtrainer.model.cfg.attention_impl == "pallas"
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    jlosses = [float(jtrainer.step({k: jnp.asarray(v) for k, v in
                                    b.items()})["loss"]) for b in batches]

    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32),
                     memory=tt.MemoryConfig(gc=True,
                                            gc_policy="save_attn_mlp"))
    model = params_from_jax(cfg, params, device="cpu", trainable=True)
    trainer, loader = accelerate(
        model, None, conf,
        optimizer=adamw(port_sched.warmup_cosine(3e-3, 10, 1), **opt))
    assert loader is None and trainer._use_fused_ce
    metrics = [trainer.step(b) for b in batches]
    losses = [m["loss"].item() for m in metrics]
    assert trainer.state.step == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_bf16_shadow_invariant_and_fit():
    """The bf16-shadow path (held by its invariant, not by JAX's
    trajectory): after every step the model's bf16 parameters equal the
    bf16 cast of the f32 masters, the masters move, and fit() logs."""
    mc = get_preset("llama-tiny", num_layers=2, hidden_size=64, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, vocab_size=128)
    conf = tt.Config(compute=tt.ComputeConfig(bf16_compute_params=True),
                     memory=tt.MemoryConfig(gc=True,
                                            gc_policy="save_attn_mlp"))
    trainer, _ = accelerate(mc, None, conf,
                            optimizer=adamw(port_sched.warmup_cosine(
                                3e-3, 20, 2)), device="cpu")
    state = trainer.init()
    first = {n: p.clone() for n, p in state.params.items()}
    assert all(p.dtype == torch.float32 for p in state.params.values())
    batch = _batch(5, vocab=128)
    records = trainer.fit(iter([batch] * 8), max_steps=6, log_every=2)
    assert [r["step"] for r in records] == [0, 2, 4]
    assert "tokens_per_sec" in records[1]
    for n, p in trainer.model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, state.params[n].to(torch.bfloat16)), n
    moved = sum(not torch.equal(first[n], state.params[n])
                for n in first)
    assert moved == len(first)
    assert records[-1]["loss"] < records[0]["loss"]


def test_unported_settings_raise():
    from torchacc_tpu_torch.errors import TrainerStateError
    mc = get_preset("llama-tiny", num_layers=1)
    # the 'head' site needs the materialised head, as in JAX; quant runs
    # under float16
    with pytest.raises(TrainerStateError, match="fused linear.CE"):
        accelerate(mc, None, tt.Config(compute=tt.ComputeConfig(
            quant="int8", quant_sites=("attn", "mlp", "head"))),
            device="cpu")
    accelerate(mc, None, tt.Config(compute=tt.ComputeConfig(
        dtype=torch.float16, quant="int8")), device="cpu")
    # a model field still outside the training forward raises by name
    with pytest.raises(NotImplementedError, match="decode=True.*A8b"):
        accelerate(dataclasses.replace(mc, decode=True), None,
                   tt.Config(), device="cpu")
    # a Hugging Face checkpoint is read from a local directory only
    with pytest.raises(FileNotFoundError, match="local directories"):
        accelerate("meta-llama/Llama-3-8B", None, tt.Config(), device="cpu")
    model = TransformerLM(dataclasses.replace(mc, overlap_fsdp=True),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="overlap_fsdp=True"):
        model(torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------------------
# the data feed and gradient accumulation, against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mem", [
    dict(offload_activations=True),
    dict(gc=True, gc_policy="offload_dots"),
    dict(gc=True, gc_policy="dots", gc_cls=["Mlp"], gc_cnt=2),
    dict(gc=True, gc_policy="save_attn", gc_cls=["Attention", "Mlp"]),
    dict(gc_policy="dots_with_no_batch_dims"),
])
def test_memory_config_folds_into_the_model_like_jax(mem):
    """gc, gc_cls, gc_cnt and offload_activations reach the model config
    as JAX's apply_config_to_model puts them there."""
    from torchacc_tpu.train.accelerate import (
        apply_config_to_model as jax_apply,
    )
    from torchacc_tpu_torch.train.accelerate import apply_config_to_model
    got = apply_config_to_model(get_preset("llama-tiny"),
                                tt.Config(memory=tt.MemoryConfig(**mem)))
    want = jax_apply(jax_preset("llama-tiny"),
                     ta.Config(memory=ta.MemoryConfig(**mem)))
    for f in ("remat", "remat_policy", "remat_cls", "remat_cnt"):
        assert getattr(got, f) == getattr(want, f), f
