"""The port's parallel training path on 2 and 4 gloo ranks against the
JAX Trainer on an emulated mesh of the same shape, on the CPU.

Each case carries the same seeded JAX weights into the JAX Trainer
(``build_mesh(dist, devices=jax.devices()[:n])``) and into ``n`` port
ranks, subprocesses of ``tests/torch_ranks_worker.py`` that join a gloo
group through a file in the test's own ``tmp_path`` (so that parallel
test workers never share a rendezvous) and step their rows of the same
global batches through ``accelerate()`` -> ``Trainer.step``.  The
losses of 3 steps and the whole final parameters must agree.  JAX runs
its XLA attention (the Pallas kernels' plain reference), the port its
plain attention.  Each subprocess has a timeout of its own, so that a
hang fails one test.

Tolerances, set from readings.  f32: the losses rtol 1e-5 (read
<= 9.8e-8) and every final parameter within 1e-5 of its leaf's largest
entry (read <= 1.9e-6): the packages sum in other orders over other
splits.  fp16: the losses rtol 2e-3 and the parameters 2e-3 of the
leaf's largest entry (read 1.8e-6 and 5.5e-5; f16 activations rounded in
another order, as ``tests/test_torch_amp.py`` holds the one-device
fp16 step), the loss scales bitwise.  bf16 compute over f32 masters:
the losses rtol 5e-5 and the parameters 3e-3 of the leaf's largest
entry (read 8.5e-6 and 9.9e-4: bf16 activations rounded in other
orders).  int8: the losses rtol 1e-4, the
parameters 1e-3 of the leaf's largest entry and every amax history
rtol 2e-4 (read 2.4e-5, 3.1e-4 and 4.7e-5: an int8 rounding that f32
noise flips moves the next step a little).  The fp16, bf16 and int8
cases take AdamW's eps 1e-2: with 1e-8 its first update is lr * sign(g), so
an element whose gradient is near zero moves by 2 lr between the
packages on its gradient's last bits (read 6e-2 and 7e-3 of the leaf's
largest entry), which hides what the comparison is for; so does the
bf16 case (read 1.1e-1 with 1e-8).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchacc_tpu as ta
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.models.transformer import loss_sum_count as jax_loss_sum
from torchacc_tpu.ops.fused import (
    fused_linear_cross_entropy_tp as jax_fused_ce_tp,
)
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu.train.trainer import shift_labels as jax_shift_labels
from torchacc_tpu_torch.ops.flash_attention import segment_ids_from_positions

pytestmark = pytest.mark.distributed

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_ranks_worker.py")
TIMEOUT_S = 120
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=128)
B, S = 4, 32
OPT = dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8, grad_clip_norm=1.0)
SCHEDULE = (3e-3, 10, 1)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


def _params(seed=0):
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, **SMALL)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _batch(seed, uneven=False, bomb_rows=None):
    """B x S tokens of documents of random lengths, packed.  ``uneven``:
    row r keeps (r + 1) / B of its tokens and pads the rest (segment
    -1), so that each data rank counts other tokens.  ``bomb_rows``:
    the rows whose ``bomb`` is set (``torch_ranks_worker.bomb_loss``)."""
    rng = np.random.default_rng(seed)
    pos = []
    for _ in range(B):
        p = []
        while len(p) < S:
            p += list(range(int(rng.integers(3, 20))))
        pos.append(p[:S])
    pos = np.asarray(pos, np.int32)
    seg = segment_ids_from_positions(torch.from_numpy(pos)).numpy()
    if uneven:
        for r in range(B):
            seg[r, S * (r + 1) // B:] = -1
            pos[r, S * (r + 1) // B:] = 0
    out = {"input_ids": rng.integers(0, SMALL["vocab_size"],
                                     size=(B, S)).astype(np.int32),
           "positions": pos, "segment_ids": seg}
    if bomb_rows is not None:
        bomb = np.zeros((B, S), np.int32)
        bomb[list(bomb_rows)] = 1
        out["bomb"] = bomb
    return out


def _launch(tmp_path, world, spec):
    """Start ``world`` port ranks on ``spec``; returns a function that
    waits for them (each within TIMEOUT_S) and reads rank 0's result."""
    spec_path, out_path = tmp_path / "spec.pkl", tmp_path / "out.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(spec_path), str(out_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        with open(out_path, "rb") as f:
            return pickle.load(f)
    return wait


def _jax_bomb_loss(logits, batch):
    labels = jax_shift_labels(batch["input_ids"], batch.get("segment_ids"))
    l_sum, count = jax_loss_sum(logits, labels)
    bomb = jnp.where((batch["bomb"] > 0).any(), 3e38, 1.0)
    return l_sum * bomb * bomb, count


CASES = {
    # name: (ranks, dist sizes, grad_accum, dtype, compute, extra)
    "dp2_fsdp2_uneven_tokens": (4, dict(dp=2, fsdp=2), 1, "float32", {},
                                dict(uneven=True)),
    "fsdp2_tp2_vocab_head": (4, dict(fsdp=2, tp=2), 1, "float32", {}, {}),
    "dp2_tp2_grad_accum2": (4, dict(dp=2, tp=2), 2, "float32", {}, {}),
    "fsdp2_fp16_one_rank_overflows": (2, dict(fsdp=2), 1, "float16", {},
                                      dict(bomb_step=2, eps=1e-2)),
    "dp2_fsdp2_bf16_compute_params": (4, dict(dp=2, fsdp=2), 1, "bfloat16",
                                      dict(bf16_compute_params=True),
                                      dict(eps=1e-2)),
    "dp2_fsdp2_int8": (4, dict(dp=2, fsdp=2), 1, "float32",
                       dict(quant="int8", quant_amax_history_len=4),
                       dict(eps=1e-2)),
    # accelerate(model, PackedDataset(..., *data_shard(mesh)), config) ->
    # fit: each rank packs the same global stream and loads its rows
    "fsdp2_fit_over_a_sharded_packed_dataset": (2, dict(fsdp=2), 1,
                                                "float32", {},
                                                dict(fit=True)),
}

DATASET = dict(seq_len=S, batch_rows=B, buffer_docs=16, shuffle_seed=3)


def _docs(seed, n=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], size=int(rng.integers(
        3, 40))).astype(np.int32) for _ in range(n)]


def _jax_trainer(world, sizes, grad_accum, dtype, compute, params, bomb,
                 opt, data=None):
    jcompute = dict(compute)
    if "quant" in jcompute:
        jcompute["quant_impl"] = "xla"
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype=dtype, attention_impl="xla",
                                 **jcompute),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=ta.DistConfig(dp=ta.DPConfig(sizes.get("dp", -1)),
                           fsdp=ta.FSDPConfig(sizes.get("fsdp", 1)),
                           tp=ta.TPConfig(sizes.get("tp", 1))),
        grad_accum=grad_accum)
    jtrainer, jloader = jax_accelerate(
        jax_preset("llama-tiny", **SMALL), data, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(*SCHEDULE), **opt),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:world]),
        **(dict(loss=_jax_bomb_loss) if bomb else {}))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    return jtrainer, jloader


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_ranks_match_the_jax_trainer_on_a_mesh(tmp_path, case):
    world, sizes, grad_accum, dtype, compute, extra = CASES[case]
    params = _params()
    bomb_step = extra.get("bomb_step")
    opt = dict(OPT, eps=extra.get("eps", OPT["eps"]))
    # the bomb sits in the last data rank's rows only
    batches = [_batch(20 + i, uneven=extra.get("uneven", False),
                      bomb_rows=None if bomb_step is None else
                      ((B - 1,) if i == bomb_step else ()))
               for i in range(3)]
    spec = dict(kind="train", params=params, model=SMALL,
                dtype=getattr(torch, dtype), dist=sizes, compute=compute,
                grad_accum=grad_accum, batches=batches, schedule=SCHEDULE,
                opt=opt, bomb=bomb_step is not None)
    data = None
    if extra.get("fit"):
        from torchacc_tpu.data import PackedDataset as JaxDataset
        spec.update(docs=_docs(31), dataset=DATASET, steps=len(batches))
        data = JaxDataset(_docs(31), **DATASET)
    wait = _launch(tmp_path, world, spec)
    jtrainer, jloader = _jax_trainer(world, sizes, grad_accum, dtype,
                                     compute, params, bomb_step is not None,
                                     opt, data)
    if data is None:
        jm = [jtrainer.step({k: jnp.asarray(v) for k, v in b.items()})
              for b in batches]
    else:
        jm = jtrainer.fit(jloader, max_steps=len(batches), log_every=1)
    got = wait()
    assert len(got["losses"]) == len(jm) == len(batches)
    assert got["data_shard"] == (world // sizes.get("tp", 1), 0)
    loss_tol, param_tol = ((2e-3, 2e-3) if dtype == "float16" else
                           (5e-5, 3e-3) if dtype == "bfloat16" else
                           (1e-4, 1e-3) if "quant" in compute else
                           (1e-5, 1e-5))
    jlosses = [float(m["loss"]) for m in jm]
    finite = [i for i, x in enumerate(jlosses) if np.isfinite(x)]
    assert [np.isfinite(x) for x in got["losses"]] == \
        [np.isfinite(x) for x in jlosses]
    np.testing.assert_allclose([got["losses"][i] for i in finite],
                               [jlosses[i] for i in finite], rtol=loss_tol)
    want = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
    for (path, a), (_, w) in zip(_leaves(got["params"]), _leaves(want)):
        np.testing.assert_allclose(
            a, w, rtol=0, atol=param_tol * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))
    if bomb_step is not None:
        assert got["scales"] == [float(m["loss_scale"]) for m in jm]
        assert got["scales"][bomb_step] == got["scales"][bomb_step - 1] / 2
        # every rank skipped the update, though only the last one's rows
        # overflowed; the other steps applied
        assert got["skipped"][bomb_step] == [True] * world
        assert got["skipped"][bomb_step - 1] == [False] * world
        assert got["count"] == len(batches) - 1
    if "quant" in compute:
        jq = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.quant))
        for (path, a), (_, w) in zip(_leaves(got["quant"]), _leaves(jq)):
            np.testing.assert_allclose(a, w, rtol=2e-4,
                                       err_msg=jax.tree_util.keystr(path))
            assert (a > 0).sum() == a.size // 4 * min(len(batches), 4)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_fused_ce_tp_matches_jax_under_shard_map(tmp_path, cap):
    """The vocab-parallel fused CE on 2 gloo ranks against JAX's
    ``fused_linear_cross_entropy_tp`` (a shard_map over 'tp' on 2
    devices): the loss sum rtol 1e-5 (read <= 6.2e-8), d(hidden) and
    d(w) within 1e-5 of each one's largest entry (read <= 3.1e-7), f32,
    the count exactly.  Labels hit
    both ranks' vocab halves, with -100 rows."""
    rng = np.random.default_rng(7 + int(cap))
    b, s, h, v = 2, 24, 32, 96
    hidden = rng.standard_normal((b, s, h)).astype(np.float32)
    w = (0.3 * rng.standard_normal((h, v))).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    labels[0, :5] = -100
    wait = _launch(tmp_path, 2, dict(kind="fused_ce", hidden=hidden, w=w,
                                     labels=labels, chunk_rows=16, cap=cap))
    mesh = build_mesh(ta.DistConfig(tp=ta.TPConfig(2)),
                      devices=jax.devices()[:2])

    def loss(x, w_):
        return jax_fused_ce_tp(x, w_, jnp.asarray(labels), chunk_rows=16,
                               logit_softcap=cap)

    with jax.sharding.set_mesh(mesh):
        jl, jc = jax.jit(loss)(jnp.asarray(hidden), jnp.asarray(w))
        jdx, jdw = jax.jit(jax.grad(lambda x, w_: loss(x, w_)[0],
                                    argnums=(0, 1)))(jnp.asarray(hidden),
                                                     jnp.asarray(w))
    got = wait()
    assert got["count"] == float(jc) == (labels != -100).sum()
    np.testing.assert_allclose(got["loss"], float(jl), rtol=1e-5)
    for name, a, r in (("dx", got["dx"], jdx), ("dw", got["dw"], jdw)):
        r = np.asarray(r)
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=name)
