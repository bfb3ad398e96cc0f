"""The port's checkpoints on 2 and 4 gloo ranks (subprocesses of
``tests/torch_ranks_worker.py``, launched as ``tests/test_torch_parallel_
ranks.py`` launches them), on the CPU.

A run under ``fsdp=2`` saves two steps through a ``CheckpointManager``
(rank 0 alone writes the markers), then resumes by consensus while rank
1 alone finds the newest step unreadable: both ranks resume the older
step, and the newest is quarantined once.  Its step 1 then restores
into one process without a group, into ``dp=2, fsdp=2`` (4 ranks) and
into ``tp=2`` (the saving ranks, after their resume): the port's
verdict on each is the JAX package's ``check_compatibility`` on the
same schema dicts (a dp and process-count change loads only with
``elastic_resume``; a tp change always raises
``TopologyMismatchError``), and every state that loads is the saved one
bitwise (f32, gathered whole).

The same launch then trains a Hugging Face checkpoint directory (head
dim 64, o and mlp biases, bf16 safetensors) through ``accelerate(path)``
on ``tp=2``, each tensor streamed into the rank's shard, against JAX's
``accelerate(path)`` on 2 devices: the losses rtol 1e-5 and the final
parameters within 1e-5 of each leaf's largest entry, as the f32 cases
of ``tests/test_torch_parallel_ranks.py`` (with AdamW's eps 1e-2, see ``HF_OPT``).  Under tensor
parallelism the
o_proj and down_proj biases are added once, after the sum over the
ranks.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
from test_torch_hf import hf_model, saved as hf_saved
from test_torch_parallel_ranks import OPT, SCHEDULE, SMALL, _batch, _launch, \
    _params
import torchacc_tpu as ta
from torchacc_tpu.checkpoint.schema import (
    check_compatibility as jax_check_compatibility,
)
from torchacc_tpu.parallel.mesh import build_mesh
from torchacc_tpu.train import accelerate as jax_accelerate
from torchacc_tpu.train import schedules as jax_sched
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.checkpoint import CheckpointManager
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.train import accelerate, adamw, warmup_cosine
from torchacc_tpu_torch.train.state import flat_state

pytestmark = pytest.mark.distributed


@pytest.fixture(scope="module", autouse=True)
def _module_env():
    # JAX's compile cache stays as tests/conftest.py sets it here
    with port_module_env(compile_cache_off=False):
        yield


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got[k].dtype == w.dtype, k


HF_CASE = "llama_o_mlp_bias_d64"
HF_SCHEDULE = (3e-3, 10, 1)
# AdamW's eps 1e-2: the k_proj bias adds one constant to each query's
# scores, so its gradient is zero but for rounding, and with eps 1e-8 the
# update is lr * sign(that noise), which differs between the packages
# (read 1.0e-5 against a leaf whose largest entry is 0.14)
HF_OPT = dict(OPT, eps=1e-2)


def _hf_batch(seed):
    return dict(_batch(seed), input_ids=np.random.default_rng(seed).integers(
        0, 256, (4, 32)).astype(np.int32))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The fsdp=2 run's directory and its worker's output."""
    d = tmp_path_factory.mktemp("fsdp2_run")
    hf_path = hf_saved(hf_model(HF_CASE, seed=5), d / "hf", torch.bfloat16,
                       shard="300KB")
    spec = dict(kind="ckpt_save", params=_params(0), params_other=_params(1),
                model=SMALL, dist=dict(fsdp=2), schedule=SCHEDULE, opt=OPT,
                batches=[_batch(20 + i) for i in range(2)],
                dir=str(d / "run"), restore_dist=dict(tp=2),
                hf=dict(path=hf_path, dist=dict(tp=2), schedule=HF_SCHEDULE,
                        opt=HF_OPT, batches=[_hf_batch(40 + i)
                                          for i in range(2)]))
    out = _launch(d, 2, spec)()
    out["hf_spec"] = spec["hf"]
    return d / "run", out


def test_fsdp2_markers_on_rank_0_and_the_consensus_falls_back_together(
        saved):
    run, out = saved
    assert out["markers"] == [2, 0]
    # rank 1 alone probed step 2 unreadable: both ranks resume step 1,
    # and step 2 is quarantined once
    assert out["chosen"] == [1, 1]
    assert out["dirs"] == ["1", "2.corrupt"]
    _assert_bitwise(out["restored"], out["full"][1])
    assert not np.array_equal(out["full"][1]["params/embed_tokens.weight"],
                              out["full"][2]["params/embed_tokens.weight"])


def test_fsdp2_checkpoint_restores_into_one_process(saved):
    run, out = saved
    cfg = get_preset("llama-tiny", dtype=torch.float32, **SMALL)
    trainer, _ = accelerate(
        params_from_jax(cfg, _params(1), device="cpu", trainable=True),
        None, tt.Config(compute=tt.ComputeConfig(dtype=torch.float32)),
        device="cpu", optimizer=adamw(warmup_cosine(*SCHEDULE), **OPT))
    trainer.init()
    mgr = CheckpointManager(str(run))
    mgr.restore(trainer.state, step=1)
    mgr.close()
    _assert_bitwise({k: v.detach().numpy() for k, v in
                     flat_state(trainer.state).items()}, out["full"][1])


def _jax_verdict(saved_schema, current, elastic):
    try:
        return ("ok", jax_check_compatibility(saved_schema, current,
                                              elastic=elastic))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, getattr(e, "axes", None))


@pytest.mark.parametrize("case", ["dp2_fsdp2", "tp2"])
def test_fsdp2_checkpoint_into_another_layout(saved, tmp_path, case):
    run, out = saved
    if case == "tp2":
        # the saving processes, after their resume, on a tp=2 mesh
        got = out["restore"]
    else:
        got = _launch(tmp_path, 4, dict(
            kind="ckpt_restore", params_other=_params(1), model=SMALL,
            dist=dict(dp=2, fsdp=2), schedule=SCHEDULE, opt=OPT,
            dir=str(run)))()
    with open(os.path.join(run, "1", "_MANIFEST")) as f:
        saved_schema = json.load(f)["schema"]
    assert saved_schema["mesh"] == {"fsdp": 2}
    for elastic in (False, True):
        want = _jax_verdict(saved_schema, got["schema"], elastic)
        if want[0] == "ok":
            assert want[1] == "elastic" and got[elastic][0] == "ok"
            _assert_bitwise(got[elastic][1], out["full"][1])
        else:
            assert got[elastic] == want
    if case == "tp2":
        assert got[False] == got[True] == ("TopologyMismatchError", ["tp"])
    else:
        assert got[False] == ("TopologyMismatchError", ["dp", "hosts"])
        assert got[True][0] == "ok"


def test_hf_checkpoint_on_tp2_follows_jax(saved):
    _, out = saved
    spec, got = out["hf_spec"], out["hf"]
    jconf = ta.Config(
        compute=ta.ComputeConfig(dtype="float32", param_dtype="float32",
                                 attention_impl="xla"),
        memory=ta.MemoryConfig(gc=True, gc_policy="save_attn_mlp"),
        dist=ta.DistConfig(tp=ta.TPConfig(2)))
    jt, _ = jax_accelerate(
        spec["path"], None, jconf,
        optimizer=jax_sched.adamw(jax_sched.warmup_linear(*spec["schedule"]),
                                  **spec["opt"]),
        mesh=build_mesh(jconf.dist, devices=jax.devices()[:2]))
    jlosses = [float(jt.step({k: jnp.asarray(v) for k, v in b.items()})
                     ["loss"]) for b in spec["batches"]]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    want = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in flat(got["params"])] == [p for p, _ in flat(want)]
    for (path, a), (_, w) in zip(flat(got["params"]), flat(want)):
        np.testing.assert_allclose(
            a, w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))
