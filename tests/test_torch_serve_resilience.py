"""The port's request journal, recovery, deadline shedding and
preemption, drain and admission snapshot (``serve/journal.py``,
``ServeEngine``), on the CPU against the JAX package's
``serve/journal.py`` (which imports no JAX) and its ``ServeEngine`` on
the same weights.

- The journal's file format is the JAX package's: a journal either
  package wrote reads back in the other to the same records and the same
  ``replay_state``; a torn tail is skipped and sealed before the next
  append; rotation by bytes and by age archives the terminal records and
  carries the pending admissions forward, with the same fold as an
  unrotated journal; the off-host archive raises by name.
- ``recover()`` on a tiny f32 engine (llama-tiny, 2 layers, hidden 64)
  after another engine over the same ``journal_dir`` closed with half of
  its 6 requests done: the pending ones replay under their ids and
  their greedy streams equal the port's ``generate()``, token for token;
  completed ids are not served again, a second ``recover()`` is a
  no-op and the next id follows the journaled ones.
- A request whose deadline passed in the queue comes back ``'shed'``
  (no tokens, ``deadline_met`` False, counted, journaled with JAX's
  reason) in both packages; one whose deadline passed while the engine
  was down is shed on recovery; an admitted request whose deadline
  passes under ``preempt_deadlines`` comes back ``'preempted'`` with
  its partial tokens and a ``shed`` journal record; ``begin_drain``
  stops admission and reports the unserved ids;
  ``admission_snapshot()`` has JAX's keys.

Tolerances: none (tokens, records and ids exactly).
"""

import itertools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_module_env import port_module_env
import torchacc_tpu.serve.journal as jax_journal
from test_torch_model import TINY, VOCAB, seeded_jax_params
from torchacc_tpu.config import Config as JaxConfig
from torchacc_tpu.config import ServeConfig as JaxServeConfig
from torchacc_tpu.models import TransformerLM as JaxLM
from torchacc_tpu.models import get_preset as jax_preset
from torchacc_tpu.serve.engine import Request as JaxRequest
from torchacc_tpu.serve.engine import ServeEngine as JaxEngine
import torchacc_tpu_torch.serve.engine as engine_mod
import torchacc_tpu_torch.serve.journal as journal
from torchacc_tpu_torch.config import Config, ServeConfig
from torchacc_tpu_torch.models import get_preset, params_from_jax
from torchacc_tpu_torch.models.generate import generate
from torchacc_tpu_torch.serve import Request, ServeEngine
from torchacc_tpu_torch.utils.metrics import counters


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    with port_module_env():
        yield


@pytest.fixture(scope="module")
def model():
    cfg = get_preset("llama-tiny", dtype=torch.float32, **TINY)
    return params_from_jax(cfg, seeded_jax_params(3, **TINY), device="cpu")


def _conf(**kw):
    base = dict(block_size=8, num_blocks=64, max_slots=2, prefill_chunk=8,
                decode_depth=2)
    base.update(kw)
    return Config(serve=ServeConfig(**base))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(k)).tolist()
            for k in rng.integers(3, 12, size=n)]


def _write(mod, d, **rotate):
    """Accepted, completed and shed records through ``mod``'s journal."""
    j = mod.RequestJournal(str(d), fsync=False, **rotate)
    for rid, p in enumerate(_prompts(6)):
        j.accepted(rid=rid, trace_id=f"t{rid}", prompt_ids=p,
                   max_new_tokens=4, temperature=0.0, top_k=0, top_p=1.0,
                   eos_id=None, seed=rid, priority=rid % 2,
                   deadline_unix=None if rid % 2 else 1e9)
    j.completed(rid=1, tokens=[5, 6, 7], finish_reason="length")
    j.shed(rid=4, reason="deadline-unmeetable")
    j.completed(rid=2, tokens=[8], finish_reason="eos")
    j.close()
    return j


def _fold(records):
    """``replay_state`` without the wall-clock stamps."""
    strip = lambda part: {rid: {k: v for k, v in rec.items()
                                if not k.startswith("t_")}
                          for rid, rec in part.items()}
    pending, completed, shed = journal.replay_state(records)
    return list(pending), strip(completed), strip(shed)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_journal(tmp_path, writer):
    _write(journal if writer == "port" else jax_journal, tmp_path)
    path = os.path.join(tmp_path, journal.JOURNAL_NAME)
    ours, theirs = journal.read_journal(path), jax_journal.read_journal(path)
    assert ours == theirs and len(ours) == 9
    assert journal.replay_state(ours) == jax_journal.replay_state(theirs)
    pending, completed, shed = _fold(ours)
    assert pending == [0, 3, 5] and sorted(completed) == [1, 2]
    assert list(shed) == [4]
    assert ours[0]["prompt_sha"] == jax_journal.prompt_digest(
        ours[0]["prompt_ids"])
    # the same bytes, but for the wall-clock stamps
    other = tmp_path / "other"
    _write(jax_journal if writer == "port" else journal, other)
    strip = lambda p: [{k: v for k, v in json.loads(x).items()
                        if not k.startswith("t_")}
                       for x in open(p, "rb").read().splitlines()]
    assert strip(path) == strip(other / journal.JOURNAL_NAME)


def test_torn_tail_is_skipped_and_sealed(tmp_path):
    _write(journal, tmp_path)
    path = os.path.join(tmp_path, journal.JOURNAL_NAME)
    with open(path, "ab") as f:
        f.write(b'{"kind":"completed","rid":0,"tok')     # a killed append
    assert len(journal.read_journal(path)) == 9
    j = journal.RequestJournal(str(tmp_path), fsync=False)
    j.completed(rid=0, tokens=[1], finish_reason="length")
    j.close()
    ours, theirs = journal.read_journal(path), jax_journal.read_journal(path)
    assert ours == theirs and len(ours) == 10
    assert 0 in journal.replay_state(ours)[1]
    with pytest.raises(ValueError, match="kind"):
        journal.RequestJournal(str(tmp_path)).append({"kind": "bogus"})


@pytest.mark.parametrize("bound", ["bytes", "age"])
def test_rotation_compacts_and_keeps_the_fold(tmp_path, bound, monkeypatch):
    plain = tmp_path / "plain"
    _write(journal, plain)
    want = _fold(journal.read_journal(str(plain)))
    rotated = tmp_path / "rotated"
    if bound == "bytes":
        j = _write(journal, rotated, rotate_bytes=600)
    else:
        # a wall clock 30 s on at every reading
        clock = itertools.count(time.time(), 30.0)
        monkeypatch.setattr(journal.time, "time", lambda: next(clock))
        j = _write(journal, rotated, rotate_age_s=60.0)
    assert j.rotations >= 1
    names = sorted(os.listdir(rotated))
    assert journal.ARCHIVE_NAME in names and journal.JOURNAL_NAME in names
    assert not [n for n in names if n[len("journal-"):-6].isdigit()]
    files = [os.path.basename(p) for p in journal.journal_files(str(rotated))]
    assert files == [os.path.basename(p) for p in
                     jax_journal.journal_files(str(rotated))]
    got = _fold(journal.read_journal(str(rotated)))
    assert got == want == _fold(jax_journal.read_journal(str(rotated)))


def test_the_off_host_archive_raises_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="A13d"):
        journal.RequestJournal(str(tmp_path), archive_store=object())
    with pytest.raises(NotImplementedError, match="A13d"):
        journal.read_archived_terminals(object())


def _run_until(eng, done):
    """Step ``eng`` until ``done`` requests have completed."""
    for _ in range(10_000):
        if eng._completed >= done or not eng.step():
            return
    raise AssertionError("the engine made no progress")


def test_recover_replays_token_identical_to_generate(model, tmp_path):
    prompts = _prompts(6, seed=1)
    conf = _conf(journal_dir=str(tmp_path / "j"), journal_fsync=False)
    first = ServeEngine(model, conf, device="cpu")
    ids = [first.submit(Request(prompt_ids=p, max_new_tokens=6))
           for p in prompts]
    _run_until(first, 3)
    done_before = {s.sid for s in first._all.values() if s.finished}
    first.close()
    assert len(done_before) >= 3
    second = ServeEngine(model, conf, device="cpu")
    rec = second.recover()
    assert rec["completed"] == sorted(done_before)
    assert sorted(rec["replayed"]) == sorted(set(ids) - done_before)
    assert rec["shed"] == [] and rec["shed_on_recovery"] == []
    assert second.recover() is rec
    second.run()
    for rid in rec["replayed"]:
        r = second.result(rid)
        want = generate(model, [prompts[rid]], max_new_tokens=6)
        assert r.tokens == want[0, len(prompts[rid]):].tolist()
        assert r.trace_id and r.finish_reason == "length"
    for rid in done_before:
        with pytest.raises(KeyError):
            second.result(rid)
    assert second.submit(Request(prompt_ids=[1, 2, 3],
                                 max_new_tokens=2)) == len(prompts)
    second.run()
    second.close()
    # a third life finds every request finished: nothing replays
    third = ServeEngine(model, conf, device="cpu")
    again = third.recover()
    assert again["replayed"] == []
    assert again["completed"] == list(range(len(prompts) + 1))
    third.close()


def _jax_engine(tmp_path):
    jcfg = jax_preset("llama-tiny", dtype=jnp.float32, **TINY)
    params = jax.tree.map(jnp.asarray, seeded_jax_params(3, **TINY))
    conf = JaxConfig(serve=JaxServeConfig(
        block_size=8, num_blocks=64, max_slots=2, prefill_chunk=8,
        decode_depth=2, shed_deadlines=True, drain_on_preempt=False,
        journal_dir=str(tmp_path), journal_fsync=False))
    return JaxEngine(JaxLM(jcfg), params, conf)


def test_shed_results_match_jax_and_snapshot_keys(model, tmp_path):
    """Two queued requests past their deadline: 'shed' in both
    packages, with the same result fields, counts and journal records;
    the admission snapshot has JAX's keys."""
    engines = {"port": ServeEngine(model, _conf(
        shed_deadlines=True, journal_dir=str(tmp_path / "port"),
        journal_fsync=False), device="cpu"),
        "jax": _jax_engine(tmp_path / "jax")}
    got = {}
    for name, eng in engines.items():
        req = Request if name == "port" else JaxRequest
        rids = [eng.submit(req(prompt_ids=p, max_new_tokens=4,
                               deadline_s=0.005)) for p in _prompts(2)]
        time.sleep(0.02)
        eng.step()
        res = [eng.result(r) for r in rids]
        recs = journal.read_journal(str(tmp_path / name))
        got[name] = dict(
            results=[(r.finish_reason, r.tokens, r.deadline_met)
                     for r in res],
            stats={k: eng.stats()[k] for k in ("requests", "shed",
                                               "preempted")},
            records=[(r["kind"], r["rid"], r.get("reason"))
                     for r in recs],
            report={k: v for k, v in eng.drain_report().items()
                    if k != "journal"},
            snapshot=sorted(eng.admission_snapshot()))
        eng.close()
    assert got["port"] == got["jax"]
    assert got["port"]["results"] == [("shed", [], False)] * 2
    assert got["port"]["stats"] == {"requests": 0, "shed": 2, "preempted": 0}
    snap = engines["port"].admission_snapshot()
    json.dumps(snap, allow_nan=False)
    assert snap["shed"] == 2 and snap["queue_depth"] == 0


def test_shed_on_recovery_when_the_deadline_passed_while_down(model,
                                                              tmp_path):
    conf = _conf(shed_deadlines=True, journal_dir=str(tmp_path),
                 journal_fsync=False)
    first = ServeEngine(model, conf, device="cpu")
    late = first.submit(Request(prompt_ids=[1, 2, 3], max_new_tokens=4,
                                deadline_s=0.01))
    kept = first.submit(Request(prompt_ids=[4, 5, 6], max_new_tokens=4))
    first._journal.close()                  # the process dies here
    time.sleep(0.03)
    second = ServeEngine(model, conf, device="cpu")
    rec = second.recover()
    assert rec["shed_on_recovery"] == [late] and rec["replayed"] == [kept]
    second.run()
    assert second.result(late).finish_reason == "shed"
    assert second.result(kept).finish_reason == "length"
    second.close()
    _, completed, shed = journal.replay_state(
        jax_journal.read_journal(str(tmp_path)))
    assert list(completed) == [kept] and list(shed) == [late]


class _Later:
    """``time`` with a monotonic clock ``ahead`` seconds on."""

    def __init__(self, ahead):
        self.ahead = ahead

    def monotonic(self):
        return time.monotonic() + self.ahead

    def time(self):
        return time.time()


def test_preempted_and_drained(model, tmp_path, monkeypatch):
    """An admitted request whose deadline passes comes back 'preempted'
    with its partial tokens, journaled as a shed; then a drain stops
    admission and reports the queued request unserved."""
    eng = ServeEngine(model, _conf(preempt_deadlines=True, max_slots=1,
                                   journal_dir=str(tmp_path),
                                   journal_fsync=False), device="cpu")
    before = counters.get("serve_requests_preempted")
    rid = eng.submit(Request(prompt_ids=[7, 8, 9], max_new_tokens=40,
                             deadline_s=60.0))
    for _ in range(100):
        eng.step()
        if len(eng._all[rid].out_tokens) >= 2:
            break
    monkeypatch.setattr(engine_mod, "time", _Later(120.0))
    eng.step()
    monkeypatch.undo()
    r = eng.result(rid)
    want = generate(model, [[7, 8, 9]], max_new_tokens=40)[0, 3:].tolist()
    assert r.finish_reason == "preempted" and r.deadline_met is False
    assert 2 <= len(r.tokens) < 40 and r.tokens == want[:len(r.tokens)]
    assert counters.get("serve_requests_preempted") == before + 1
    assert eng.stats()["preempted"] == 1
    assert eng.drain_report()["preempted"] == [rid]
    busy = eng.submit(Request(prompt_ids=[1, 2], max_new_tokens=3))
    eng.step()
    queued = eng.submit(Request(prompt_ids=[3, 4], max_new_tokens=3))
    eng.begin_drain("test")
    eng.run()
    assert eng.draining and eng.unserved_ids() == [queued]
    assert eng.result(busy).finish_reason == "length"
    report = eng.drain_report()
    assert report["unserved"] == [queued] and report["in_flight"] == []
    assert eng.admission_snapshot()["draining"] is True
    eng.close()
    _, completed, shed = journal.replay_state(
        journal.read_journal(str(tmp_path)))
    assert shed[rid]["reason"] == "preempted" and busy in completed
