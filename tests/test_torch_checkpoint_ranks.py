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
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_parallel_ranks import OPT, SCHEDULE, SMALL, _batch, _launch, \
    _params
from torchacc_tpu.checkpoint.schema import (
    check_compatibility as jax_check_compatibility,
)
import torchacc_tpu_torch as tt
from torchacc_tpu_torch.checkpoint import CheckpointManager
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.train import accelerate, adamw, warmup_cosine
from torchacc_tpu_torch.train.state import flat_state

pytestmark = pytest.mark.distributed


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got[k].dtype == w.dtype, k


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The fsdp=2 run's directory and its worker's output."""
    d = tmp_path_factory.mktemp("fsdp2_run")
    spec = dict(kind="ckpt_save", params=_params(0), params_other=_params(1),
                model=SMALL, dist=dict(fsdp=2), schedule=SCHEDULE, opt=OPT,
                batches=[_batch(20 + i) for i in range(2)],
                dir=str(d / "run"), restore_dist=dict(tp=2))
    return d / "run", _launch(d, 2, spec)()


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
