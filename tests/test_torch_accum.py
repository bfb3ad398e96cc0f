"""Gradient accumulation and ``fit`` over a ``PackedDataset`` against
the JAX Trainer, on the CPU in f32, on ``llama_tiny`` (the model, the
weights, the optimizer and JAX's attention of
``tests/test_torch_train.py``, whose helpers this file shares; kept
apart from it so that the test workers spread the two).

Tolerances: the loss trajectories rtol 1e-4, as the unsplit trajectory
of ``tests/test_torch_train.py`` (1e-3 with bf16 accumulators and the
histories 5e-2: each test's docstring says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from test_torch_train import B, S, _batch, _leaves, tiny
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.train import accelerate, adamw
from torchacc_tpu_torch.train import schedules as port_sched


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


_OPT = dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8, grad_clip_norm=1.0)


def _trainers(params, jcompute=None, compute=None, data=None, jmodel=None,
              model_kw=None, **conf_kw):
    """(JAX Trainer, port Trainer) for llama-tiny in f32 from the same
    weights and optimizer (save_attn_mlp remat; JAX's attention is B1-B3
    in interpret mode).  ``data``: a (JAX, port) pair of dataloaders,
    whose AsyncLoaders come back third and fourth."""
    jconf = ta.Config(compute=ta.ComputeConfig(
        dtype="float32", attention_impl="pallas", **(jcompute or {})),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        **conf_kw)
    jtrainer, jloader = jax_accelerate(
        jax_preset("llama-tiny", **(jmodel or {})),
        None if data is None else data[0], jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(3e-3, 10, 1),
                                  **_OPT),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    conf = tt.Config(compute=tt.ComputeConfig(dtype=torch.float32,
                                              **(compute or {})),
                     memory=tt.MemoryConfig(gc=True,
                                            gc_policy="save_attn_mlp"),
                     **conf_kw)
    model = params_from_jax(get_preset("llama-tiny", dtype=torch.float32,
                                       **(model_kw or {})),
                            params, device="cpu", trainable=True)
    trainer, loader = accelerate(
        model, None if data is None else data[1], conf,
        optimizer=adamw(port_sched.warmup_cosine(3e-3, 10, 1), **_OPT))
    return jtrainer, trainer, jloader, loader


def _docs(seed, n, lo=5, hi=60, vocab=32000):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def test_accelerate_fit_over_a_packed_dataset_matches_jax(tiny):
    """accelerate(model, PackedDataset(...), config) returns (Trainer,
    AsyncLoader) in both packages; fit over it follows JAX's loss
    trajectory (rtol 1e-4, as the hand-fed trajectory), with
    grad_accum 2 over global batches of 4 rows."""
    from torchacc_tpu.data import PackedDataset as JaxDataset
    from torchacc_tpu_torch.data import AsyncLoader, PackedDataset
    _, params, _ = tiny
    docs = _docs(31, 60)
    kw = dict(batch_rows=4, buffer_docs=16, shuffle_seed=3)
    jtrainer, trainer, jloader, loader = _trainers(
        params, data=(JaxDataset(docs, S, **kw),
                      PackedDataset(docs, S, **kw)), grad_accum=2)
    assert isinstance(loader, AsyncLoader) and loader.device.type == "cpu"
    jlosses = [r["loss"] for r in jtrainer.fit(jloader, max_steps=4,
                                               log_every=1)]
    hist = trainer.fit(loader, max_steps=4, log_every=1)
    assert [r["step"] for r in hist] == [0, 1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in hist], jlosses,
                               rtol=1e-4)
    assert loader.state_dict()["batches_consumed"] == 4


def _accum_batch(seed, rows=4, uneven=False):
    """A global batch of ``rows`` packed rows; ``uneven``: the second
    micro-batch's rows are mostly padding (segment -1), so the two
    micro-batches count different tokens."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("input_ids", "positions", "segment_ids")}
    for r in range(rows):
        one = _batch(int(rng.integers(1 << 30)))
        for k in out:
            out[k].append(one[k][r % B])
    out = {k: np.stack(v) for k, v in out.items()}
    if uneven:
        out["segment_ids"][rows // 2:, S // 4:] = -1
        out["positions"][rows // 2:, S // 4:] = 0
    return out


ACCUM_CASES = {   # name: (port compute, JAX compute, model fields, uneven)
    "f32_accumulators": ({}, {}, {}, False),
    "bf16_accumulators": (dict(accum_dtype=torch.bfloat16),
                          dict(accum_dtype="bfloat16"), {}, False),
    "uneven_token_counts": ({}, {}, {}, True),
    "attention_dropout": ({}, {}, dict(attn_dropout=0.1), False),
    "int8_histories": (dict(quant="int8", quant_amax_history_len=4),
                       dict(quant="int8", quant_amax_history_len=4,
                            quant_impl="xla"), {}, False),
}


@pytest.mark.parametrize("case", sorted(ACCUM_CASES))
def test_grad_accumulation_trajectory_matches_jax(tiny, case):
    """Three steps of grad_accum 2 against the JAX Trainer: the loss is
    Σ loss_sum / Σ count over both micro-batches, micro-batch i draws
    dropout with step * 2 + i, and the quantized sites' histories chain
    micro by micro (each history after each step equals JAX's).
    Tolerance: the loss rtol 1e-4 (f32 accumulators, as the unsplit
    trajectory), 1e-3 with bf16 accumulators (one bf16 rounding of each
    summed gradient, taken by both packages of f32 sums that differ in
    their last bits); the histories rtol 5e-2: an int8 rounding flipped
    by f32 noise moves a later amax by a few percent, and the unsplit
    trainer (grad_accum 1) drifts as far on these batches (read 0.028
    after its second step, against 0.023 here)."""
    from torchacc_tpu_torch.models.convert import quant_to_jax
    compute, jcompute, fields, uneven = ACCUM_CASES[case]
    _, params, _ = tiny
    jtrainer, trainer, _, _ = _trainers(
        params, jcompute=jcompute, compute=compute, jmodel=fields,
        model_kw=fields, grad_accum=2)
    rtol = 1e-3 if "bf16" in case else 1e-4
    for i in range(3):
        b = _accum_batch(40 + i, uneven=uneven)
        jl = float(jtrainer.step({k: jnp.asarray(v)
                                  for k, v in b.items()})["loss"])
        tl = trainer.step(b)["loss"].item()
        np.testing.assert_allclose(tl, jl, rtol=rtol, err_msg=f"step {i}")
        if trainer.state.quant is not None:
            got = quant_to_jax(trainer.model.cfg, trainer.state.quant)
            want = jax.tree.map(np.asarray,
                                jax.device_get(jtrainer.state.quant))
            for (path, a), (_, w_) in zip(_leaves(got), _leaves(want)):
                np.testing.assert_allclose(
                    a, w_, rtol=5e-2,
                    err_msg=f"step {i} {jax.tree_util.keystr(path)}")
                # two micro-batches a step: each layer's history
                # records two entries a step
                assert ((a > 0).sum(axis=-1) == min(2 * (i + 1), 4)).all()
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        trainer.step(_accum_batch(50, rows=3))
