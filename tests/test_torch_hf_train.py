"""Training a Hugging Face checkpoint with the port: ``accelerate(path)``
and ``accelerate(hf_model)`` -> ``Trainer`` (``init_from_params``,
``swap_params``, ``fit`` with evaluation), ``warmup_linear`` and
``HFTrainerAdapter``, against the JAX package on the CPU.

Both packages train the same small HF checkpoint (head dim 64, llama3
rope, o and mlp biases) from the same seeded batches, f32, JAX on its
XLA attention (the Pallas kernels' plain reference) and the port on its
plain attention.  Losses agree within rtol 1e-4, as the port's other
trajectories against the JAX Trainer (tests/test_torch_train.py).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.data as tud
import transformers

from torch_module_env import port_module_env
import torchacc_tpu as ta
from torchacc_tpu.models.hf import load_hf_model as jax_load_hf_model
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import HFTrainerAdapter as JaxAdapter
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.errors import TrainerStateError
from torchacc_tpu_torch.models.hf import load_hf_model
from torchacc_tpu_torch.ops.flash_attention import segment_ids_from_positions
from torchacc_tpu_torch.train import accelerate, adamw
from torchacc_tpu_torch.train import schedules as port_sched
from torchacc_tpu_torch.train.amp import shadow_params
from torchacc_tpu_torch.utils.logger import logger as port_logger
from test_torch_hf import hf_model, saved

CASE = "llama_o_mlp_bias_d64"
B, S, VOCAB = 2, 48, 256
OPT = dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8, grad_clip_norm=1.0)
SCHEDULE = (3e-3, 10, 2)        # warmup_linear(peak, total, warmup)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


def _batch(seed):
    """Documents of random lengths packed into [B, S]."""
    rng = np.random.default_rng(seed)
    pos = []
    for _ in range(B):
        p = []
        while len(p) < S:
            p += list(range(int(rng.integers(5, 30))))
        pos.append(p[:S])
    pos = np.asarray(pos, np.int32)
    seg = segment_ids_from_positions(torch.from_numpy(pos)).numpy()
    return {"input_ids": rng.integers(0, VOCAB, (B, S)).astype(np.int32),
            "positions": pos, "segment_ids": seg}


def _jax_trainer(model_or_path):
    # dispatch depth 1: the port's fit reads each step as it ends (it has
    # no dispatch ring, ROADMAP A13), so its evaluation runs on the state
    # of the step it is recorded at, as JAX's does at depth 1
    jconf = ta.Config(compute=ta.ComputeConfig(
        dtype="float32", param_dtype="float32", attention_impl="xla"),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        perf=ta.PerfConfig(dispatch_depth=1))
    trainer, _ = jax_accelerate(
        model_or_path, None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_linear(*SCHEDULE), **OPT),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]))
    return trainer


def _port_trainer(model_or_path, **compute):
    conf = tt.Config(compute=tt.ComputeConfig(**{"dtype": torch.float32,
                                                 **compute}),
                     memory=tt.MemoryConfig(gc=True,
                                            gc_policy="save_attn_mlp"))
    trainer, _ = accelerate(
        model_or_path, None, conf, device="cpu",
        optimizer=adamw(port_sched.warmup_linear(*SCHEDULE), **OPT))
    return trainer


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(the HF model, its sharded bf16 checkpoint directory)."""
    model = hf_model(CASE, seed=0)
    path = saved(model, tmp_path_factory.mktemp("hf") / "ckpt",
                 torch.bfloat16, shard="300KB")
    return model, path


def test_accelerate_a_checkpoint_and_a_model_follow_jax(ckpt):
    """accelerate(path) (streamed from bf16 safetensors) and
    accelerate(hf_model) start from the same masters, bitwise, with a
    fresh optimizer state at step 0, and both follow JAX's
    accelerate(path) over 4 steps."""
    model, path = ckpt
    batches = [_batch(10 + i) for i in range(4)]
    jt = _jax_trainer(path)
    jlosses = [float(jt.step(_jb(b))["loss"]) for b in batches]
    from_path = _port_trainer(path)
    model_bf16 = hf_model(CASE, seed=0).to(torch.bfloat16)
    from_model = _port_trainer(model_bf16)
    st = from_path.state
    assert st.step == 0 and st.opt_state.count == 0
    assert all(not m.any() for m in st.opt_state.mu.values())
    for n, p in st.params.items():
        assert p.dtype == torch.float32
        assert torch.equal(p, from_model.state.params[n]), n
    assert from_path.model.cfg.o_bias and from_path.model.cfg.mlp_bias
    assert from_path.model.cfg.rope_llama3 is None
    for t in (from_path, from_model):
        losses = [t.step(b)["loss"].item() for b in batches]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert jlosses[-1] < jlosses[0]


def test_fit_eval_records_match_jax(ckpt):
    """fit(eval_loader, eval_every=2, log_every=3) over 5 steps: the
    same records as JAX's _fit_inner (logging steps 0 and 3, evaluation
    steps 2 and 4), their losses and eval losses within rtol 1e-4; the
    log lines name the records' steps, metrics_step_offset aside, as
    JAX's do."""
    model, path = ckpt
    batches = [_batch(30 + i) for i in range(5)]
    evals = [_batch(90 + i) for i in range(2)]
    jt = _jax_trainer(path)
    jhist = jt.fit(iter([_jb(b) for b in batches]), max_steps=5,
                   eval_loader=[_jb(b) for b in evals], eval_every=2,
                   log_every=3)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    level = port_logger.level
    port_logger.addHandler(handler)
    port_logger.setLevel(logging.INFO)
    try:
        hist = _port_trainer(path).fit(iter(batches), max_steps=5,
                                       eval_loader=evals, eval_every=2,
                                       log_every=3, metrics_step_offset=7)
    finally:
        port_logger.removeHandler(handler)
        port_logger.setLevel(level)
    assert [int(m.split(":")[0][5:]) for m in lines
            if m.startswith("step ")] == [0, 2, 3, 4]
    assert [r["step"] for r in hist] == [r["step"] for r in jhist] \
        == [0, 2, 3, 4]
    for r, j in zip(hist, jhist):
        evaluated = r["step"] in (2, 4)
        assert ("eval_loss" in r) == ("eval_loss" in j) == evaluated
        for k in ("loss", "eval_loss"):
            if k in j:
                np.testing.assert_allclose(r[k], j[k], rtol=1e-4)


def test_swap_params_matches_jax(ckpt):
    """init_from_params(A), a step, swap_params(B, reinit_opt=False), a
    step, swap_params(A, reinit_opt=True), a step: the losses follow
    the JAX Trainer's through the same calls."""
    model_a, path = ckpt
    model_b = hf_model(CASE, seed=9)
    batches = [_batch(50 + i) for i in range(3)]
    jt = _jax_trainer(path)
    pt = _port_trainer(path)
    _, pa = load_hf_model(model_a.to(torch.bfloat16))
    model_a.float()
    _, pb = load_hf_model(model_b)
    _, jpa = jax_load_hf_model(model_a.to(torch.bfloat16),
                               dtype=jnp.float32, param_dtype=jnp.float32)
    model_a.float()
    _, jpb = jax_load_hf_model(model_b, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jlosses, losses = [], []
    for step, (new, jnew, reinit) in enumerate(((None, None, None),
                                                 (pb, jpb, False),
                                                 (pa, jpa, True))):
        if new is not None:
            jt.swap_params(jnew, reinit_opt=reinit)
            pt.swap_params(new, reinit_opt=reinit, verify_shadow=True)
        jlosses.append(float(jt.step(_jb(batches[step]))["loss"]))
        losses.append(pt.step(batches[step])["loss"].item())
        if reinit:
            assert pt.state.opt_state.count == 1
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    with pytest.raises(TrainerStateError, match="embed_tokens.weight"):
        pt.swap_params(dict(pa, **{"embed_tokens.weight": torch.zeros(3)}))


def test_swap_params_remakes_the_bf16_shadow_and_a_bare_write_does_not(
        ckpt):
    """Under the bf16 shadow: swap_params(reinit_opt=False) keeps the
    moments bitwise and makes the shadow the cast of the new masters;
    reinit_opt=True zeroes them.  The control: the same new weights
    written into state.params by hand leave the shadow, which the
    forward reads, holding the old weights, so its loss is the old
    weights' loss."""
    model_a, path = ckpt
    _, pb = load_hf_model(hf_model(CASE, seed=9))
    batch, probe = _batch(60), _batch(61)
    bf16 = dict(dtype=torch.bfloat16, bf16_compute_params=True)
    swapped = _port_trainer(path, **bf16)
    bare = _port_trainer(path, **bf16)
    for t in (swapped, bare):
        t.step(batch)
    old_loss = bare.eval_step(probe)["loss"].item()
    mu = {n: m.clone() for n, m in swapped.state.opt_state[0].mu.items()}
    swapped.swap_params(pb, reinit_opt=False, verify_shadow=True)
    assert all(torch.equal(mu[n], m)
               for n, m in swapped.state.opt_state[0].mu.items())
    shadow = shadow_params(swapped.state.opt_state)
    for n, p in swapped.model.named_parameters():
        assert p is shadow[n] and torch.equal(p, pb[n].to(torch.bfloat16))
    with torch.no_grad():
        for n, p in bare.state.params.items():
            p.copy_(pb[n])
    assert swapped._shadow_consistent() and not bare._shadow_consistent()
    new_loss = swapped.eval_step(probe)["loss"].item()
    stale_loss = bare.eval_step(probe)["loss"].item()
    assert stale_loss == old_loss and abs(new_loss - stale_loss) > 1e-2
    swapped.swap_params(pb, reinit_opt=True)
    inner = swapped.state.opt_state[0]
    assert inner.count == 0 and not any(m.any() for m in inner.mu.values())
    assert swapped.state.step == 1


@pytest.mark.parametrize("peak,total,warmup", [(3e-3, 10, 2), (1e-3, 7, 0),
                                               (5e-4, 3, 5)])
def test_warmup_linear_matches_optax(peak, total, warmup):
    want = jax_sched.warmup_linear(peak, total, warmup)
    got = port_sched.warmup_linear(peak, total, warmup)
    for c in range(total + 3):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))


class _Ds(tud.Dataset):
    def __len__(self):
        return 16

    def __getitem__(self, i):
        ids = np.random.default_rng(i).integers(0, 64, 24).astype(np.int64)
        return {"input_ids": ids, "labels": ids,
                "attention_mask": np.ones(24, np.int64)}


def _collate(feats):
    return {k: torch.tensor(np.stack([f[k] for f in feats]))
            for k in feats[0]}


def test_hf_trainer_adapter_matches_jax(tmp_path):
    """HFTrainerAdapter over the same HF model, TrainingArguments,
    dataset and collator as the JAX adapter (on one JAX device): the
    same logged steps and losses, and the same evaluation."""
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=1, num_key_value_heads=1,
        max_position_embeddings=64)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).float()
    args = transformers.TrainingArguments(
        output_dir=str(tmp_path / "out"), max_steps=3,
        per_device_train_batch_size=2, per_device_eval_batch_size=4,
        learning_rate=1e-3, warmup_steps=1, logging_steps=1, save_steps=0,
        report_to=[])
    jconf = ta.Config(compute=ta.ComputeConfig(
        dtype="float32", attention_impl="xla"))
    jconf.get_mesh(devices=jax.devices()[:1])
    jad = JaxAdapter(model=model, args=args, train_dataset=_Ds(),
                     eval_dataset=_Ds(), data_collator=_collate,
                     config=jconf)
    ad = tt.HFTrainerAdapter(
        model=model, args=args, train_dataset=_Ds(), eval_dataset=_Ds(),
        data_collator=_collate, device="cpu",
        config=tt.Config(compute=tt.ComputeConfig(dtype=torch.float32)))
    assert ad.model_config.head_size == 64
    jh, h = jad.train(), ad.train()
    assert [r["step"] for r in h] == [r["step"] for r in jh] == [0, 1, 2]
    np.testing.assert_allclose([r["loss"] for r in h],
                               [r["loss"] for r in jh], rtol=1e-4)
    np.testing.assert_allclose(ad.evaluate()["eval_loss"],
                               jad.evaluate()["eval_loss"], rtol=1e-4)
    ad.save_model(str(tmp_path / "saved"))
    assert ad.state.step == 3


def test_accelerate_refuses_what_it_does_not_convert(tmp_path):
    moe = transformers.OlmoeConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=2)
    moe.save_pretrained(str(tmp_path))
    with pytest.raises(NotImplementedError,
                       match="'olmoe'.*mixtral and qwen3_moe"):
        accelerate(str(tmp_path), None, tt.Config(), device="cpu")
    with pytest.raises(FileNotFoundError, match="local directories"):
        accelerate(str(tmp_path / "nowhere"), None, tt.Config(),
                   device="cpu")
    with pytest.raises(TypeError, match="ModelConfig"):
        accelerate(3, None, tt.Config(), device="cpu")
