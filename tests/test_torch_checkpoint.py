"""The port's checkpoints (torchacc_tpu_torch/checkpoint/, Trainer.save/
restore/fit(checkpoint_dir, resume='auto')) against the JAX package's
(torchacc_tpu/checkpoint/, the JAX Trainer), on the CPU.

The two packages write different payloads (DCP against orbax), so they
are held to the same decisions: the same schema dicts through both
``check_compatibility`` functions; the same manager scenarios (retention,
markers, corruption, drift) through both ``CheckpointManager``s, with
the outcome tuples compared; the same ``fit`` with ``checkpoint_dir``
and ``resume='auto'`` through both Trainers.  Every input is made from a
numpy seed.

Tolerances.  The resumed losses against the JAX Trainer: rtol 1e-4, the
Trainer-vs-JAX tolerance of ``tests/test_torch_train.py`` (f32; JAX's
XLA attention, the Pallas kernels' plain reference).  The port's resumed
run against its uninterrupted run: bitwise.  A JAX state carried over
by ``state_from_jax``: every leaf bitwise; the next step's loss against
JAX's next step rtol 1e-4 in int8 (as ``tests/test_torch_parallel_
ranks.py``'s int8 losses) and 2e-3 in fp16 (two f16 ulps, as
``tests/test_torch_amp.py``).  ``loader_state.json`` is compared whole
but for the source's producer-side fields (its ``batches_consumed``,
``epoch`` and ``group_cum_rows``), which depend on how far the producer
thread ran (ROADMAP C2) in either package.
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu as ta
from torchacc_tpu.checkpoint import CheckpointManager as JaxManager
from torchacc_tpu.checkpoint import consolidate_checkpoint as jax_consolidate
from torchacc_tpu.checkpoint import restore_checkpoint as jax_restore
from torchacc_tpu.checkpoint import save_checkpoint as jax_save
from torchacc_tpu.checkpoint.schema import (
    check_compatibility as jax_check_compatibility,
)
from torchacc_tpu.data import PackedDataset as JaxDataset
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
from torchacc_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
import torchacc_tpu_torch as tt
import torchacc_tpu_torch.checkpoint.io as cio
from torchacc_tpu_torch.checkpoint import (
    CheckpointManager,
    check_compatibility,
    cli,
    restore_checkpoint,
    save_checkpoint,
)
from torchacc_tpu_torch.data import PackedDataset
from torchacc_tpu_torch.errors import (
    CheckpointError,
    CheckpointNotFoundError,
    TrainerStateError,
)
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.models.convert import (
    _find_adam,
    state_from_jax,
    state_to_jax,
)
from torchacc_tpu_torch.train import accelerate, adamw, warmup_cosine
from torchacc_tpu_torch.train.state import flat_state
from torchacc_tpu_torch.utils.metrics import counters
from torchacc_tpu_torch.utils.retry import RetryPolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=128)
OPT = dict(weight_decay=0.01, b1=0.9, b2=0.95, eps=1e-8, grad_clip_norm=1.0)
SCHEDULE = (3e-3, 10, 1)
DATASET = dict(seq_len=32, batch_rows=4, buffer_docs=16, shuffle_seed=3)
FAST = dict(max_retries=1, base_delay_s=0.001, max_delay_s=0.002)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    """Seeded llama-tiny weights in JAX's layout as numpy (shared:
    callers only read them)."""
    from test_torch_model import seeded_jax_params
    return seeded_jax_params(seed, **SMALL)


def _docs(seed=31, n=80):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], size=int(rng.integers(
        3, 40))).astype(np.int32) for _ in range(n)]


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, SMALL["vocab_size"], size=(4, 32))
            .astype(np.int32)}


def _jax_trainer(params, data=None, **compute):
    jconf = ta.Config(compute=ta.ComputeConfig(
        dtype=compute.pop("dtype", "float32"), attention_impl="xla",
        **compute))
    jtrainer, jloader = jax_accelerate(
        jax_preset("llama-tiny", **SMALL), data, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_cosine(*SCHEDULE), **OPT),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:1]))
    jtrainer.init_from_params(jax.tree.map(jnp.asarray, params))
    return jtrainer, jloader


def _port_trainer(params=None, data=None, seed=0, **compute):
    """The port's Trainer on the CPU: from ``params`` (JAX weights), or
    made from ``seed`` when None."""
    dtype = getattr(torch, compute.pop("dtype", "float32"))
    conf = tt.Config(compute=tt.ComputeConfig(dtype=dtype, **compute),
                     seed=seed)
    cfg = get_preset("llama-tiny", dtype=dtype, **SMALL)
    model = (cfg if params is None else
             params_from_jax(cfg, params, device="cpu", trainable=True))
    trainer, loader = accelerate(
        model, data, conf, device="cpu",
        optimizer=adamw(warmup_cosine(*SCHEDULE), **OPT))
    trainer.init()
    return trainer, loader


def _flat_np(flat):
    return {k: v.detach().cpu().numpy() for k, v in flat.items()}


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


# -- 1. schema verdicts --------------------------------------------------------

def _schema(mesh, processes=1, leaves=None):
    import hashlib
    leaves = leaves or {"params/w": ([8, 4], "float32"),
                        "opt_state/mu/w": ([8, 4], "float32")}
    specs = {p: {"shape": list(s), "dtype": d} for p, (s, d) in leaves.items()}
    lines = sorted(f"{p}:{tuple(s['shape'])}:{s['dtype']}"
                   for p, s in specs.items())
    return {"format": 1, "mesh": mesh, "process_count": processes,
            "tree": {"leaves": len(lines), "digest": hashlib.sha256(
                "\n".join(lines).encode()).hexdigest()},
            "leaf_specs": specs}


BASE = {"dp": 1, "fsdp": 2, "tp": 1, "sp": 1}
VERDICTS = {   # name: (current schema, elastic)
    "nothing_changed": (_schema(BASE), False),
    "dp_elastic_off": (_schema(dict(BASE, dp=2)), False),
    "dp_elastic_on": (_schema(dict(BASE, dp=2)), True),
    "fsdp_elastic_off": (_schema(dict(BASE, fsdp=4)), False),
    "fsdp_elastic_on": (_schema(dict(BASE, fsdp=4)), True),
    "process_count_elastic_off": (_schema(BASE, processes=2), False),
    "process_count_elastic_on": (_schema(BASE, processes=2), True),
    "tp_elastic_on": (_schema(dict(BASE, tp=2)), True),
    "sp": (_schema(dict(BASE, sp=2)), True),
    "leaf_shape": (_schema(BASE, leaves={
        "params/w": ([8, 8], "float32"),
        "opt_state/mu/w": ([8, 4], "float32")}), True),
    "leaf_dtype": (_schema(BASE, leaves={
        "params/w": ([8, 4], "bfloat16"),
        "opt_state/mu/w": ([8, 4], "float32")}), False),
    "leaf_missing": (_schema(BASE, leaves={
        "params/w": ([8, 4], "float32")}), False),
    "no_mesh_recorded": (_schema(None, processes=2), False),
}


def _verdict(fn, saved, current, elastic):
    try:
        return ("ok", fn(saved, current, elastic=elastic, where="w"))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, getattr(e, "axes", None),
                getattr(e, "diff", None), str(e))


@pytest.mark.parametrize("case", sorted(VERDICTS))
def test_schema_verdicts_match_jax(case):
    """The same saved/current schema dicts give JAX's verdict: the
    result, or the error's type, axes, diff and message."""
    current, elastic = VERDICTS[case]
    saved = _schema(BASE)
    got = _verdict(check_compatibility, saved, current, elastic)
    want = _verdict(jax_check_compatibility, saved, current, elastic)
    assert got == want


# -- 2. manager scenarios --------------------------------------------------------

SCENARIOS = ("retention_2_every_2", "newest_marker_removed",
             "newest_payload_removed", "every_step_corrupt", "empty_dir",
             "every_step_drifted", "write_dies_then_resumed")


class _DeadWrite:
    """While entered, the write of step ``step`` dies as a killed writer
    would: in the port after part of its payload is on disk, in orbax
    after the payload and before the rename that finishes it (the
    latest point a write can die at in either)."""

    def __init__(self, jax_side, step):
        self.jax_side, self.step = jax_side, step

    def __enter__(self):
        from orbax.checkpoint._src.path import atomicity
        self.cls = atomicity.AtomicRenameTemporaryPath
        self.finalize, self.write = self.cls.finalize, cio._write
        tail = os.sep + str(self.step)
        tmp = str(self.step) + cio.TMP_SUFFIX
        finalize, write = self.finalize, self.write

        async def dying_finalize(path, *a, **k):
            if str(path._final_path).endswith(tail):
                raise OSError("injected: the writer died before the rename")
            return await finalize(path, *a, **k)

        def dying_write(host, path, group):
            if os.path.basename(os.path.dirname(path)) != tmp:
                return write(host, path, group)
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "__0_0.distcp"), "wb") as f:
                f.write(b"part of a payload")
            raise OSError("injected: the writer died mid-payload")
        if self.jax_side:
            self.cls.finalize = dying_finalize
        else:
            cio._write = dying_write
        return self

    def __exit__(self, *exc):
        self.cls.finalize, cio._write = self.finalize, self.write


def _run_scenario(kind, name, d):
    """The scenario ``name`` on ``kind``'s manager in ``d``: (retained
    step dirs, latest step, the step restore_latest_valid chose or the
    error type's name, the values restored, quarantined dirs, and for a
    dead write: the error the close raised, whether the resumed run's
    manager saves that step again, and the marked steps after it saved
    it and the step after)."""
    jax_side = kind == "jax"
    arr = ((lambda a: jnp.asarray(a)) if jax_side
           else (lambda a: torch.from_numpy(np.array(a))))
    state = lambda s, b=(2, 3): {"a": arr(np.arange(8.0, dtype=np.float32)
                                         + s),
                                 "b": arr(np.full(b, s, np.float32))}
    Mgr = JaxManager if jax_side else CheckpointManager
    policy = (JaxRetryPolicy if jax_side else RetryPolicy)(**FAST)
    retention = name == "retention_2_every_2"
    mgr = Mgr(d, max_to_keep=2 if retention else 3,
              save_interval_steps=2 if retention else 1,
              retry_policy=policy)
    if name != "empty_dir":
        for s in range(7) if retention else (1, 2, 3):
            mgr.save(s, state(s, (2, 3)))
    dead = None
    if name == "write_dies_then_resumed":
        with _DeadWrite(jax_side, 4):
            mgr.save(4, state(4))
            try:
                mgr.close()
            except Exception as e:  # noqa: BLE001 - the outcome is compared
                dead = type(e).__name__
    mgr.close()
    if name == "newest_marker_removed":
        os.remove(os.path.join(d, "3", "_MANIFEST"))
    elif name == "newest_payload_removed":
        shutil.rmtree(os.path.join(d, "3", "default"))
    elif name == "every_step_corrupt":
        for s in (1, 2, 3):
            for root, _, files in os.walk(os.path.join(d, str(s), "default")):
                for f in files:
                    open(os.path.join(root, f), "w").close()
    mgr = Mgr(d, retry_policy=policy)
    latest = mgr.latest_step()
    if jax_side:
        target = {"a": jax.ShapeDtypeStruct((8,), jnp.float32),
                  "b": jax.ShapeDtypeStruct(
                      (3, 3) if name == "every_step_drifted" else (2, 3),
                      jnp.float32)}
    else:
        target = state(-1, (3, 3) if name == "every_step_drifted" else (2, 3))
    try:
        restored, chosen = mgr.restore_latest_valid(target)
        values = [float(np.asarray(restored[k]).sum()) for k in ("a", "b")]
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        chosen, values = type(e).__name__, None
    if dead is not None:
        # the resumed run reaches the dead step and the one after it
        dead = (dead, mgr.should_save(4), mgr.save(4, state(4)),
                mgr.save(5, state(5)))
        mgr.close()
        dead += (Mgr(d, retry_policy=policy).valid_steps(),)
    mgr.close()
    names = sorted(os.listdir(d))
    return ([n for n in names if n.isdigit()], latest, chosen, values,
            [n for n in names if ".corrupt" in n], dead)


@pytest.mark.parametrize("name", SCENARIOS)
def test_manager_scenarios_match_jax(tmp_path, name):
    """Both packages' managers through one scenario: retention of
    ``max_to_keep`` at ``save_interval_steps`` (orbax's first save of
    an empty directory included), a crash before the newest marker, a
    newest payload gone under its marker, every payload corrupt, an
    empty directory, a model whose every step drifted, and a write that
    dies, then resumed through the step after it (which saves it
    again)."""
    got = _run_scenario("port", name, str(tmp_path / "port"))
    want = _run_scenario("jax", name, str(tmp_path / "jax"))
    assert got == want


# -- 3. resume against the JAX Trainer --------------------------------------------

def _loader_state(d, step, producer=("batches_consumed", "epoch",
                                     "group_cum_rows")):
    with open(os.path.join(d, str(step), "loader_state.json")) as f:
        state = json.load(f)
    state["source"] = {k: v for k, v in state["source"].items()
                       if k not in producer}
    return state


def test_fit_resume_matches_the_jax_trainer(tmp_path):
    """fit(checkpoint_dir, checkpoint_every=2, max_steps=4) then a fresh
    trainer's fit(resume='auto', max_steps=6), in both packages over the
    same PackedDataset from the same weights: the losses agree (rtol
    1e-4), the marked steps and loader states are the same, and the
    port's resumed run is its uninterrupted run bitwise, though its
    fresh trainer was made from other weights."""
    params = _params()
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(checkpoint_every=2, log_every=1)
    jt, jl = _jax_trainer(params, JaxDataset(_docs(), **DATASET))
    ja = jt.fit(jl, max_steps=4, checkpoint_dir=jd, **kw)
    jt, jl = _jax_trainer(params, JaxDataset(_docs(), **DATASET))
    jb = jt.fit(jl, max_steps=6, checkpoint_dir=jd, resume="auto", **kw)
    pt, pl = _port_trainer(params, PackedDataset(_docs(), **DATASET))
    pa = pt.fit(pl, max_steps=4, checkpoint_dir=pd, **kw)
    pt, pl = _port_trainer(None, PackedDataset(_docs(), **DATASET), seed=7)
    resumes = counters.get("resumes")
    pb = pt.fit(pl, max_steps=6, checkpoint_dir=pd, resume="auto", **kw)
    assert counters.get("resumes") == resumes + 1
    ut, ul = _port_trainer(params, PackedDataset(_docs(), **DATASET))
    uninterrupted = ut.fit(ul, max_steps=6, log_every=1)

    assert [r["step"] for r in pb] == [r["step"] for r in jb] == [4, 5]
    np.testing.assert_allclose([r["loss"] for r in pa + pb],
                               [r["loss"] for r in ja + jb], rtol=1e-4)
    assert [r["loss"] for r in pa + pb] == \
        [r["loss"] for r in uninterrupted]
    for n, p in ut.state.params.items():
        assert torch.equal(p, pt.state.params[n]), n
    marked = lambda d: sorted(int(s) for s in os.listdir(d) if s.isdigit()
                              and os.path.exists(os.path.join(d, s,
                                                              "_MANIFEST")))
    assert marked(pd) == marked(jd) == [2, 4, 6]
    for step in (2, 4, 6):
        assert _loader_state(pd, step) == _loader_state(jd, step)


# -- 4. a JAX state carried over -----------------------------------------------------

@pytest.mark.parametrize("case", ["int8_histories", "fp16_scaler"])
def test_state_from_jax_resumes_a_jax_checkpoint(tmp_path, case):
    """A JAX trainer's state after 2 steps, saved by JAX's
    save_checkpoint and restored host-side by JAX, converted by
    state_from_jax: the port saves and restores it bitwise (and
    state_to_jax gives JAX's leaves back bitwise), and the port's next
    step from it matches JAX's next step."""
    compute, rtol = (({"quant": "int8", "quant_amax_history_len": 4}, 1e-4)
                     if case == "int8_histories" else
                     ({"dtype": "float16"}, 2e-3))
    params = _params()
    batches = [_batch(40 + i) for i in range(3)]
    jt, _ = _jax_trainer(params, **dict(
        compute, **({"quant_impl": "xla"} if "quant" in compute else {})))
    for b in batches[:2]:
        jt.step({k: jnp.asarray(v) for k, v in b.items()})
    jax_save(str(tmp_path / "jax"), jt.state)
    jloss = float(jt.step({k: jnp.asarray(v)
                           for k, v in batches[2].items()})["loss"])
    tree = jax.tree.map(np.asarray, jax_restore(str(tmp_path / "jax")))
    cfg = get_preset("llama-tiny", dtype=getattr(
        torch, compute.get("dtype", "float32")), **SMALL)
    if "quant" in compute:
        import dataclasses
        cfg = dataclasses.replace(cfg, quant="int8", quant_amax_history_len=4)
    state = state_from_jax(cfg, tree, device="cpu")
    assert state.step == 2 and (state.scaler is None) == ("quant" in compute)
    back = state_to_jax(cfg, state)
    adam = _find_adam(tree["opt_state"])
    assert int(back["opt_state"]["count"]) == int(adam["count"]) == 2
    for got, want in ((back["params"], tree["params"]),
                      (back["opt_state"]["mu"], adam["mu"]),
                      (back["opt_state"]["nu"], adam["nu"]),
                      (back["quant"], tree["quant"]),
                      (back["scaler"], tree["scaler"])):
        assert (got is None) == (want is None)
        for (path, a), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            np.testing.assert_array_equal(a, w, err_msg=str(path))
    save_checkpoint(str(tmp_path / "port"), state)
    _assert_bitwise(_flat_np(restore_checkpoint(str(tmp_path / "port"))),
                    _flat_np(flat_state(state)))
    pt, _ = _port_trainer(None, seed=5, **compute)
    pt.restore(str(tmp_path / "port"))
    _assert_bitwise(_flat_np(flat_state(pt.state)),
                    _flat_np(flat_state(state)))
    ploss = pt.step(batches[2])["loss"].item()
    np.testing.assert_allclose(ploss, jloss, rtol=rtol)


# -- 5. snapshot semantics ----------------------------------------------------------

def test_async_save_holds_its_steps_values(tmp_path):
    """save(blocking=False) at step k, a step that updates the masters
    and moments in place, then wait(): the checkpoint is step k's state
    bitwise; the same through the manager's background write."""
    trainer, _ = _port_trainer(_params())
    batches = [_batch(50 + i) for i in range(4)]
    for b in batches[:2]:
        trainer.step(b)
    want = _flat_np({k: v.clone() for k, v in
                     flat_state(trainer.state).items()})
    handle = trainer.save(str(tmp_path / "async"), blocking=False)
    mgr = CheckpointManager(str(tmp_path / "mgr"))
    assert mgr.save(2, trainer.state)
    trainer.step(batches[2])
    handle.wait()
    mgr.wait_until_finished()
    moved = _flat_np(flat_state(trainer.state))
    assert not np.array_equal(moved["params/embed_tokens.weight"],
                              want["params/embed_tokens.weight"])
    _assert_bitwise(_flat_np(restore_checkpoint(str(tmp_path / "async"))),
                    want)
    _assert_bitwise(_flat_np(restore_checkpoint(
        str(tmp_path / "mgr" / "2" / "default"))), want)
    mgr.close()


# -- 6. retries and typed errors --------------------------------------------------

def test_checkpoint_io_errors_retried_then_typed(tmp_path, monkeypatch):
    """An OSError on the first write is retried and counted in
    ckpt_retries; exhausted retries raise CheckpointError; a failed read
    is retried the same way (as tests/test_resilience.py::
    test_checkpoint_io_errors_retried_then_typed holds the JAX
    manager)."""
    state = {"a": torch.arange(4.0)}
    write, read = cio._write, cio._read
    fails = {"write": 0, "read": 0}

    def flaky(kind, fn):
        def call(*a, **k):
            if fails[kind] > 0:
                fails[kind] -= 1
                raise OSError(f"injected {kind} failure")
            return fn(*a, **k)
        return call
    monkeypatch.setattr(cio, "_write", flaky("write", write))
    monkeypatch.setattr(cio, "_read", flaky("read", read))
    mgr = CheckpointManager(str(tmp_path / "c"),
                            retry_policy=RetryPolicy(max_retries=2, **{
                                k: v for k, v in FAST.items()
                                if k != "max_retries"}))
    before = counters.get("ckpt_retries")
    fails["write"] = 2
    assert mgr.save(1, state)
    mgr.wait_until_finished()
    assert counters.get("ckpt_retries") == before + 2
    assert mgr.valid_steps() == [1]
    fails["write"] = 5
    assert mgr.save(2, {"a": torch.arange(4.0) + 1}, force=True)
    with pytest.raises(CheckpointError, match="stay unmarked"):
        mgr.wait_until_finished()
    fails["write"] = 0
    assert mgr.valid_steps() == [1]
    fails["read"] = 2
    target = {"a": torch.zeros(4)}
    mgr.restore(target, step=1)
    assert torch.equal(target["a"], torch.arange(4.0))
    assert counters.get("ckpt_retries") == before + 2 + 2 + 2
    fails["read"] = 5
    with pytest.raises(CheckpointError, match="failed after 3"):
        mgr.restore({"a": torch.zeros(4)}, step=1)
    mgr.close()


def test_typed_errors_and_unported_settings(tmp_path):
    """JAX's typed errors where the port is driven wrong, and the
    settings of ROADMAP A13 raising by name."""
    trainer, _ = _port_trainer(seed=0)
    trainer.state = None
    with pytest.raises(TrainerStateError):
        trainer.save(str(tmp_path / "nope"))
    trainer.init()
    with pytest.raises(TrainerStateError, match="requires checkpoint_dir"):
        trainer.fit([_batch(1)], resume="auto")
    with pytest.raises(ValueError, match="resume must be"):
        trainer.fit([_batch(1)], checkpoint_dir=str(tmp_path), resume="yes")
    with pytest.raises(CheckpointNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(
            {"a": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="A13"):
        CheckpointManager(str(tmp_path / "fs"), barrier="fs")
    with pytest.raises(NotImplementedError, match="A13"):
        tt.Config(resilience=tt.ResilienceConfig(
            tiered_checkpointing=True)).validate()
    for field, value in (("ckpt_retries", -1), ("coord_timeout_s", 0),
                         ("retry_max_delay_s", 0.1),
                         ("retry_deadline_s", 0)):
        with pytest.raises(tt.ConfigError) as got:
            tt.ResilienceConfig(**{field: value}).validate()
        with pytest.raises(ta.ConfigError) as want:
            ta.config.ResilienceConfig(**{field: value}).validate()
        assert str(got.value) == str(want.value)
    a, b = tt.ResilienceConfig(), ta.config.ResilienceConfig()
    assert a.retry_policy(a.ckpt_retries) == RetryPolicy(**{
        k: getattr(b.retry_policy(b.ckpt_retries), k) for k in (
            "max_retries", "base_delay_s", "max_delay_s", "deadline_s")})
    assert (a.ckpt_retries, a.coord_timeout_s, a.elastic_resume) == \
        (b.ckpt_retries, b.coord_timeout_s, b.elastic_resume)
    with pytest.raises(CheckpointError):
        save_checkpoint(str(tmp_path), {"a": torch.zeros(1)})


# -- 7. the CLI ----------------------------------------------------------------------

def _seeded_state(seed=9):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 4)).astype(np.float32),
            "v": rng.standard_normal((5,)).astype(np.float32),
            "n": rng.integers(0, 100, size=(4, 3)).astype(np.int32)}


def test_cli_inspect_consolidate_and_reshard(tmp_path, capsys):
    """inspect prints the schema of every marked step; consolidation
    holds its source bitwise and equals JAX's consolidate_checkpoint of
    the same seeded state; --reshard_num 2 (two gloo processes) holds
    its source bitwise with the divisible leaves in 2 chunks; the
    operations-plane commands exit 2 naming ROADMAP A13."""
    state = _seeded_state()
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(5, {k: torch.from_numpy(v) for k, v in state.items()})
    mgr.close()
    assert cli.main(["inspect", str(tmp_path / "run"), "--leaves"]) == 0
    out = capsys.readouterr().out
    assert "step 5:" in out and "mesh: <not recorded>" in out
    assert "processes: 1" in out and "w: (6, 4) float32" in out
    assert "leaves: 3" in out

    src = str(tmp_path / "run" / "5")
    assert cli.main(["--ckpt_dir", src, "--save_dir",
                     str(tmp_path / "one"), "--dry-run"]) == 0
    assert "would consolidate" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "one")
    assert cli.main(["--ckpt_dir", src, "--save_dir",
                     str(tmp_path / "one")]) == 0
    one = _flat_np(restore_checkpoint(str(tmp_path / "one")))
    _assert_bitwise(one, state)
    jax_save(str(tmp_path / "jsrc"), jax.tree.map(jnp.asarray, state))
    jax_consolidate(str(tmp_path / "jsrc"), str(tmp_path / "jone"))
    jone = jax.tree.map(np.asarray, jax_restore(str(tmp_path / "jone")))
    _assert_bitwise(one, dict(jone))

    assert cli.main(["--ckpt_dir", src, "--save_dir", str(tmp_path / "two"),
                     "--reshard_num", "2", "--dry-run"]) == 0
    plan = capsys.readouterr().out
    assert "w: (6, 4) -> Shard(0) over fsdp=2" in plan
    assert "v: (5,) -> replicated" in plan and "mesh axis 'fsdp'" in plan
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torchacc_tpu_torch.checkpoint.cli",
         "--ckpt_dir", src, "--save_dir", str(tmp_path / "two"),
         "--reshard_num", "2"], env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    _assert_bitwise(_flat_np(restore_checkpoint(str(tmp_path / "two"))),
                    state)
    from torch.distributed.checkpoint import FileSystemReader
    md = FileSystemReader(str(tmp_path / "two")).read_metadata()
    chunks = {k: len(m.chunks) for k, m in md.state_dict_metadata.items()}
    assert chunks == {"w": 2, "v": 1, "n": 2}
    with open(tmp_path / "two.schema.json") as f:
        assert json.load(f)["mesh"] == {"fsdp": 2}

    for argv in (["replay", src], ["supervise", "--", "x"],
                 ["fleet-history", str(tmp_path)],
                 ["inspect", str(tmp_path / "run"), "--mirror", "m"]):
        assert cli.main(argv) == 2
        assert "ROADMAP.md A13" in capsys.readouterr().err
    assert cli.main(["inspect", str(tmp_path / "nowhere")]) == 2
