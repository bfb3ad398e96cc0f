"""Request-level serving front-end: queue, admission control, SLO
metrics (the port of torchacc_tpu/serve/engine.py)::

    model = init_params(get_preset("llama3-8b"), seed=0, dtype=torch.bfloat16)
    engine = ServeEngine(model, Config(serve=ServeConfig(...)))
    rid = engine.submit(Request(prompt_ids=[...], max_new_tokens=64))
    engine.run()                  # or step() / generate() / stream()
    result = engine.result(rid)   # tokens + per-request SLO metrics

The engine runs on the card: ``device=None`` means CUDA and raises when
there is none; the CPU is used only when the caller passes
``device="cpu"``.  The model's weights must already be on that device.

Admission control: a request enters a decode slot only when the block
pool has room for its whole reservation (prompt + max_new + in-flight
overhang), so an admitted request can always finish.  Until then it
waits in the queue (``serve.policy``: 'fcfs', 'sjf' or 'priority').

Live weights: ``from_train_state(trainer)`` serves a one-device
``Trainer``'s masters cast to the serving dtype, and ``load_params``
swaps an idle engine's weights in place, keeping its pools.

The request journal (``serve.journal_dir``, ``serve/journal.py``):
every accepted request and every completed or shed result is appended
durably, and after a restart ``recover()`` re-admits the journaled
requests that did not finish under their own ids (greedy replays are
token-identical), never serving a completed id twice.  Deadlines:
``serve.shed_deadlines`` gives a queued request whose deadline passed a
typed 'shed' result, and ``serve.preempt_deadlines`` evicts an admitted
one with a typed 'preempted' result and its partial tokens; both are
counted and journaled.  ``begin_drain()`` stops admission while the
in-flight requests finish (``drain_report()``, ``unserved_ids()``), and
``admission_snapshot()`` is the router's load signal.

Left out of this slice (ROADMAP.md): the train-to-serve resharding of a
mesh trainer and the TP pools (A2b-2), ``serve.drain_on_preempt`` (the
SIGTERM-driven drain, with A13a's preemption handler), the exit
disposition (A13c's flight recorder) and the telemetry session.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import time
from typing import Any, Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from torchacc_tpu_torch.config import Config
from torchacc_tpu_torch.models.transformer import TransformerLM
from torchacc_tpu_torch.ops._common import resolve_device
from torchacc_tpu_torch.serve.journal import (
    RequestJournal,
    read_journal,
    replay_state,
)
from torchacc_tpu_torch.serve.scheduler import Scheduler, Sequence, priority_key
from torchacc_tpu_torch.utils.logger import logger
from torchacc_tpu_torch.utils.metrics import BlockedMeter, counters, open_metrics


@dataclasses.dataclass
class Request:
    """One generation request.  Sampling params default to greedy."""

    prompt_ids: Seq[int]
    max_new_tokens: Optional[int] = None     # None = config.serve default
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    seed: int = 0
    # 'priority' policy inputs: higher priority = more urgent; within a
    # class the earliest deadline (seconds from submit) admits first
    priority: int = 0
    deadline_s: Optional[float] = None
    # the request's trace id (journaled); None: the engine makes one
    trace_id: Optional[str] = None


@dataclasses.dataclass
class RequestResult:
    """Tokens + the per-request SLO metrics."""

    request_id: int
    prompt_ids: List[int]
    tokens: List[int]                        # generated tokens only
    # 'eos' | 'length' | 'shed' | 'preempted'
    finish_reason: str
    queue_wait_s: float                      # submit -> slot admission
    ttft_s: float                            # submit -> first token
    total_s: float                           # submit -> finish
    token_latencies_s: List[float]           # inter-token gaps
    tokens_per_sec: float
    cached_prompt_tokens: int = 0
    deadline_met: Optional[bool] = None
    trace_id: str = ""


#: trace ids are unique in the process: engines side by side share it
_trace_seq = itertools.count()


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


class ServeEngine:
    """Continuous-batching serving engine over a paged KV cache.

    ``model``: a port ``TransformerLM`` holding the weights (cast to the
    serving precision by the caller); ``config``: the :class:`Config`
    whose ``serve`` block tunes the engine; ``device``: where it runs
    (None = CUDA); ``metrics_dir``: optional JSONL per-request records;
    ``attention_impl``: 'auto' | 'cuda' | 'torch' (default: the model
    config's ``attention_impl``)."""

    def __init__(self, model, config: Optional[Config] = None, *,
                 device=None, metrics_dir: Optional[str] = None,
                 attention_impl: Optional[str] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"the model's weights are on {model.device} but the engine "
                f"runs on {self.device}: move the model there first")
        config = config or Config()
        config.serve.validate()
        self.cfg = model.cfg
        self.config = config
        self.blocked = BlockedMeter()
        self.scheduler = Scheduler(model, config.serve, self.device,
                                   attention_impl=attention_impl,
                                   blocked=self.blocked)
        self._queue: "collections.deque[Sequence]" = collections.deque()
        self._all: Dict[int, Sequence] = {}
        self._next_id = 0
        self._metrics = open_metrics(metrics_dir)
        self._completed = 0
        # the drain: admission stopped, in-flight requests finish, the
        # queued ones are reported unserved (once)
        self._draining = False
        self._drain_reported = False
        serve = config.serve
        self._journal = (RequestJournal(
            serve.journal_dir, fsync=serve.journal_fsync,
            rotate_bytes=serve.journal_rotate_bytes,
            rotate_age_s=serve.journal_rotate_age_s)
            if serve.journal_dir else None)
        self._journal_fold = None
        if self._journal is not None:
            # one read at construction: the ids a predecessor journaled
            # are reserved (a submit() before recover() must not reuse
            # one), and recover() replays the pending records; only
            # their ids are kept of the terminal records
            pending, completed, shed = replay_state(
                read_journal(self._journal.dir))
            self._journal_fold = (pending, set(completed), set(shed))
            known = [rid for part in self._journal_fold for rid in part]
            if known:
                self._next_id = max(known) + 1
        self._recovered: Optional[Dict[str, List[int]]] = None
        # ids a recover() attempt already enqueued or shed, so that a
        # retry after a journal error reports the whole recovery
        self._replay_enqueued: set = set()
        self._replay_shed: set = set()
        self._shed_ids: List[int] = []
        self._preempted_ids: List[int] = []
        self._agg = self._fresh_agg()
        self._evict_base = 0

    @staticmethod
    def _fresh_agg() -> Dict:
        return {"ttft": [], "waits": [], "gaps": [], "tokens": 0,
                "requests": 0, "t0": None, "t1": None,
                "prefix_hits": 0, "cached_tokens": 0, "shared_blocks": 0,
                "cow": 0, "deadline_total": 0, "deadline_miss": 0,
                "shed": 0, "preempted": 0}

    # -- live weights (train -> serve handoff) ------------------------------

    @classmethod
    def from_train_state(cls, trainer, config: Optional[Config] = None, *,
                         dtype: Any = "auto",
                         metrics_dir: Optional[str] = None) -> "ServeEngine":
        """An engine over a live one-device ``Trainer``'s weights
        (``from_train_state`` of the JAX package, :249): a new model on
        the trainer's device holding the f32 masters cast to ``dtype``
        ('auto': the model's compute dtype; None keeps the masters'),
        with the quantized matmuls off (serving decodes in the compute
        dtype).  The trainer is left as it was.  A trainer on a mesh
        raises: resharding its state into the serving layout is
        ``parallel/transfer.py``, not ported yet (ROADMAP A2b)."""
        config = config or trainer.config
        # a bad ServeConfig fails before the weights are copied
        config.serve.validate()
        if trainer.mesh is not None:
            raise NotImplementedError(
                "ServeEngine.from_train_state of a Trainer on a mesh needs "
                "the train-to-serve resharding (parallel/transfer.py), "
                "which is not ported to torchacc_tpu_torch yet (ROADMAP "
                "A2b); save a checkpoint and serve it on one card")
        if trainer.state is None:
            raise RuntimeError("nothing to hand off: call init() (or "
                               "init_from_params / restore) first")
        cfg = dataclasses.replace(trainer.model.cfg, quant="none")
        dt = cfg.dtype if dtype == "auto" else dtype
        model = TransformerLM(cfg, device="meta", dtype=dt)
        model = model.to_empty(device=trainer.device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(trainer.state.params[name])
        model.requires_grad_(False).eval()
        return cls(model, config, device=trainer.device,
                   metrics_dir=metrics_dir)

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Swap the weights in place (``load_params`` of the JAX
        package, :272): ``params`` (the port's parameter names, e.g. a
        ``Trainer``'s ``state.params``) are copied into the engine's
        model, cast to its dtype; the pools, tables and decode carry are
        kept.  The engine must be idle (queued requests may wait): a
        swap under sequences mid-decode would splice two models' logits
        into one stream, so it raises.  In-flight ring entries resolve
        first, and the prefix cache is flushed (its k/v were computed
        under the old weights)."""
        with torch.inference_mode():
            self.scheduler.drain()
        self._drain_events()
        if self.scheduler.busy():
            busy = [s.sid for s in self.scheduler.slot_seq if s is not None]
            raise RuntimeError(
                f"cannot swap weights while sequences {busy} occupy decode "
                f"slots: run() the engine to completion first")
        model = self.scheduler.decoder.model
        named = dict(model.named_parameters())
        if set(named) != set(params):
            raise ValueError(
                f"load_params: the names do not match the model's: missing "
                f"{sorted(set(named) - set(params))[:5]}, unexpected "
                f"{sorted(set(params) - set(named))[:5]}")
        for name, p in named.items():
            if tuple(params[name].shape) != tuple(p.shape):
                raise ValueError(f"load_params: {name} has shape "
                                 f"{list(params[name].shape)}, the model "
                                 f"{list(p.shape)}")
        flushed = self.scheduler.flush_prefix_cache()
        if flushed:
            logger.info(f"prefix cache flushed on weight swap ({flushed} "
                        f"cached blocks dropped)")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(params[name])

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request, on_token=None) -> int:
        """Queue a request; returns its id.  Raises when the request can
        never be served or the queue is full.  ``on_token(token,
        t_monotonic)`` is called as the lagged ring resolves each token.
        With ``serve.journal_dir`` the request is journaled (durably,
        before this returns) before the engine takes it."""
        serve = self.config.serve
        seq = self._build_seq(req, self._next_id, on_token)
        if len(self._queue) >= serve.max_queue:
            raise RuntimeError(
                f"admission queue full ({serve.max_queue}); shed load "
                f"upstream or raise serve.max_queue")
        seq.t_submit = time.monotonic()
        if req.deadline_s is not None:
            seq.deadline = seq.t_submit + req.deadline_s
        # the id is spent from here on, even if the append fails: a raise
        # from fsync does not prove the line missed the disk
        self._next_id += 1
        if self._journal is not None:
            self._journal.accepted(
                rid=seq.sid, trace_id=seq.trace_id,
                prompt_ids=req.prompt_ids, max_new_tokens=seq.max_new,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, eos_id=req.eos_id, seed=req.seed,
                priority=req.priority,
                deadline_unix=(None if req.deadline_s is None
                               else time.time() + req.deadline_s))
        self._all[seq.sid] = seq
        self._queue.append(seq)
        counters.inc("serve_requests_submitted")
        return seq.sid

    def _build_seq(self, req: Request, rid: int, on_token) -> Sequence:
        prompt = np.asarray(list(req.prompt_ids), np.int32)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError("prompt_ids must be a non-empty 1-D sequence")
        if (prompt < 0).any() or (prompt >= self.cfg.vocab_size).any():
            raise ValueError(
                f"prompt_ids must lie in [0, {self.cfg.vocab_size})")
        max_new = (req.max_new_tokens if req.max_new_tokens is not None
                   else self.config.serve.max_new_tokens)
        if max_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new} (a decode "
                f"slot always generates at least one token)")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 seconds from submit, got "
                f"{req.deadline_s}")
        # pid x a process-wide count: unique across processes and engines
        trace_id = (req.trace_id if req.trace_id
                    else f"{os.getpid():x}-{next(_trace_seq):x}")
        seq = Sequence(sid=rid, prompt=prompt, max_new=max_new,
                       temperature=req.temperature, top_k=req.top_k,
                       top_p=req.top_p, eos_id=req.eos_id, seed=req.seed,
                       priority=req.priority, on_token=on_token,
                       trace_id=trace_id)
        need = self.scheduler.blocks_for(seq)
        if need > self.scheduler.max_blocks_per_seq:
            raise ValueError(
                f"request needs {need} KV blocks (prompt "
                f"{prompt.shape[0]} + max_new {max_new}) but a sequence "
                f"may own at most {self.scheduler.max_blocks_per_seq} "
                f"(min of pool size serve.num_blocks - 1 and the model's "
                f"position reach max_seq_len); raise serve.num_blocks / "
                f"the model max_seq_len or lower max_new_tokens")
        total = prompt.shape[0] + max_new
        if self.cfg.pos_emb == "learned" and total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the learned "
                f"position table max_seq_len {self.cfg.max_seq_len}")
        return seq

    # -- journal replay ------------------------------------------------------

    def recover(self) -> Dict[str, List[int]]:
        """Re-admit every journaled request that did not finish, after a
        restart (JAX :408).  Completed and shed ids are never served
        again, a replayed request keeps its id (and its trace id), and a
        second call returns the first's result.  A pending request whose
        absolute deadline passed while the engine was down is shed when
        ``serve.shed_deadlines`` is on (else it replays and counts as a
        deadline miss).  A journaled request this engine can no longer
        serve (a smaller pool, another model) is shed with the reason.

        Returns ``{"replayed", "completed", "shed", "shed_on_recovery"}``
        (ids); all empty without a journal."""
        if self._journal is None:
            return {"replayed": [], "completed": [], "shed": [],
                    "shed_on_recovery": []}
        if self._recovered is not None:
            return self._recovered
        pending, completed, shed = self._journal_fold
        replayed: List[int] = []
        shed_now: List[int] = []
        now_wall, now_mono = time.time(), time.monotonic()
        for rid in sorted(pending):
            if rid in self._all:
                # enqueued or shed by an earlier attempt, or accepted by
                # this engine itself
                if rid in self._replay_enqueued:
                    replayed.append(rid)
                elif rid in self._replay_shed:
                    shed_now.append(rid)
                continue
            rec = pending[rid]
            req = Request(
                prompt_ids=rec["prompt_ids"],
                max_new_tokens=rec.get("max_new_tokens"),
                temperature=rec.get("temperature", 0.0),
                top_k=rec.get("top_k", 0), top_p=rec.get("top_p", 1.0),
                eos_id=rec.get("eos_id"), seed=rec.get("seed", 0),
                priority=rec.get("priority", 0),
                trace_id=rec.get("trace_id") or None)
            try:
                seq = self._build_seq(req, rid, None)
            except (ValueError, RuntimeError) as e:
                # a finished stub keeps result()'s contract for the id
                stub = Sequence(
                    sid=rid, prompt=np.asarray(rec.get("prompt_ids") or [],
                                               np.int32),
                    max_new=int(rec.get("max_new_tokens") or 0),
                    trace_id=rec.get("trace_id") or "")
                stub.t_submit = stub.t_admit = now_mono
                stub.t_first_token = now_mono
                # journaled first: a failed append leaves nothing half
                # shed for a retry to skip
                self._shed(stub, f"unservable-after-restart: {e}")
                self._all[rid] = stub
                self._replay_shed.add(rid)
                shed_now.append(rid)
                continue
            # the wall-clock deadline on this process's monotonic clock;
            # queue wait and TTFT restart at recovery
            seq.t_submit = now_mono
            dl = rec.get("deadline_unix")
            if dl is not None:
                seq.deadline = now_mono + (float(dl) - now_wall)
            self._all[seq.sid] = seq
            self._queue.append(seq)
            self._replay_enqueued.add(rid)
            replayed.append(rid)
        if replayed or shed_now:
            logger.warning(
                f"request journal replay: {len(replayed)} request(s) "
                f"re-admitted ({len(completed)} already completed, "
                f"{len(shed)} already shed, {len(shed_now)} shed on "
                f"recovery) from {self._journal.path}")
        # replays whose deadline passed are shed now, and reported so
        self._shed_expired()
        still_live = []
        for rid in replayed:
            if self._all[rid].finish_reason == "shed":
                shed_now.append(rid)
            else:
                still_live.append(rid)
        counters.inc("serve_requests_replayed", len(still_live))
        self._recovered = {
            "replayed": still_live, "completed": sorted(completed),
            "shed": sorted(shed), "shed_on_recovery": sorted(shed_now),
        }
        # released on success only: a recover() that raised stays
        # retryable
        self._journal_fold = None
        return self._recovered

    # -- deadline shedding and preemption --------------------------------------

    def _shed(self, seq: Sequence, reason: str) -> None:
        """A queued sequence finished with ``finish_reason='shed'``, no
        tokens: journaled first (a failed append leaves it untouched),
        then counted."""
        if self._journal is not None:
            self._journal.shed(rid=seq.sid, reason=reason)
        self._shed_ids.append(seq.sid)
        counters.inc("serve_requests_shed")
        seq.finished = True
        seq.finish_reason = "shed"
        seq.t_finish = time.monotonic()
        self._agg["shed"] += 1
        logger.warning(f"serve: shed request {seq.sid} ({reason})")

    def _shed_expired(self) -> None:
        """Shed every queued request whose deadline has passed
        (``serve.shed_deadlines``, JAX :529): it still needs a decode
        step, so no schedule meets it.  Admitted requests are left to
        :meth:`_preempt_expired`."""
        if not self.config.serve.shed_deadlines or not self._queue:
            return
        now = time.monotonic()
        for seq in [s for s in self._queue
                    if s.deadline != float("inf") and now >= s.deadline]:
            self._shed(seq, "deadline-unmeetable"
                       + (" (drain)" if self._draining else ""))
            self._queue.remove(seq)

    def _preempt_expired(self) -> None:
        """Evict every admitted sequence whose deadline has passed
        (``serve.preempt_deadlines``, JAX :571): its slot and blocks are
        freed, and :meth:`_drain_events` journals and counts its typed
        'preempted' result with the tokens resolved so far."""
        if not self.config.serve.preempt_deadlines:
            return
        now = time.monotonic()
        for seq in self.scheduler.slot_seq:
            if (seq is not None and not seq.finished
                    and seq.deadline != float("inf")
                    and now >= seq.deadline):
                self.scheduler.preempt(seq, now)
                logger.warning(
                    f"serve: preempted in-flight request {seq.sid} "
                    f"(deadline passed; {len(seq.out_tokens)} token(s) "
                    "resolved so far returned as a typed partial)")

    # -- the loop -----------------------------------------------------------

    def _admit(self) -> None:
        """Move queue entries into free slots while headroom lasts
        ('fcfs' stops at the first miss; 'sjf' and 'priority' may skip a
        request that does not fit)."""
        if (self._draining or not self._queue
                or self.scheduler.free_slot() is None):
            return
        if self.config.serve.policy == "fcfs":
            while self._queue and self.scheduler.admit(self._queue[0]):
                self._queue.popleft()
                counters.inc("serve_requests_admitted")
            return
        if not self.scheduler.pool.can_alloc(
                min(self.scheduler.min_fresh_blocks(s)
                    for s in self._queue)):
            return
        order = list(self._queue)
        if self.config.serve.policy == "sjf":
            order.sort(key=lambda s: (s.prompt_len, s.sid))
        else:
            now = time.monotonic()
            aging = self.config.serve.priority_aging_s
            order.sort(key=lambda s: priority_key(s, now, aging))
        admitted = []
        for seq in order:
            if self.scheduler.free_slot() is None:
                break
            if self.scheduler.admit(seq):
                admitted.append(seq)
                counters.inc("serve_requests_admitted")
        for seq in admitted:
            self._queue.remove(seq)

    def step(self) -> bool:
        """One engine iteration (admission + scheduler step + completion
        accounting).  Returns True while there is work anywhere; while
        draining, while requests are in flight."""
        self._shed_expired()
        self._preempt_expired()
        with torch.inference_mode():
            self._admit()
            self.scheduler.step()
        self._drain_events()
        if self._draining:
            return self.scheduler.busy()
        return bool(self._queue) or self.scheduler.busy()

    def _check_progress(self, idle: int) -> int:
        """Queued work that can never admit while nothing runs is a
        configuration error, not a reason to spin."""
        if self._queue and not self.scheduler.busy() and not self._draining:
            idle += 1
            if idle > 3:
                raise RuntimeError(
                    "serving stalled: queued requests cannot be admitted "
                    "and no sequence is running")
            return idle
        return 0

    def run(self, max_iters: int = 1_000_000) -> None:
        """Drive until every submitted request completed, or while
        draining until the in-flight ones did (the queued ones stay
        unserved and are reported)."""
        idle = 0
        for _ in range(max_iters):
            if not self.step():
                if self._draining:
                    self._log_drain_report()
                return
            idle = self._check_progress(idle)
        raise RuntimeError(f"run() exceeded {max_iters} iterations")

    # -- the drain ------------------------------------------------------------

    def begin_drain(self, reason: str = "") -> None:
        """Stop admission now (JAX :731): the in-flight requests finish
        (an admitted request always finishes), the queued ones stay
        queued and are reported unserved.  Idempotent."""
        if self._draining:
            return
        self._draining = True
        self._drain_reported = False
        counters.inc("serve_drains")
        logger.warning(
            "serve engine draining" + (f" ({reason})" if reason else "")
            + f": admission stopped with {len(self._queue)} queued, "
            f"{sum(s is not None for s in self.scheduler.slot_seq)} "
            "in flight — in-flight decodes will finish")

    @property
    def draining(self) -> bool:
        return self._draining

    def unserved_ids(self) -> List[int]:
        """The ids in the queue, never admitted to a decode slot."""
        return [s.sid for s in self._queue]

    def drain_report(self) -> Dict[str, Any]:
        """What finished, what is in flight, what never started (resubmit
        the unserved ids elsewhere), what was shed or preempted, and
        where the journal lives."""
        return {
            "draining": self._draining,
            "completed": self._completed,
            "in_flight": sorted(
                s.sid for s in self.scheduler.slot_seq if s is not None),
            "unserved": self.unserved_ids(),
            "shed": list(self._shed_ids),
            "preempted": list(self._preempted_ids),
            "journal": (self._journal.path if self._journal is not None
                        else None),
        }

    def _log_drain_report(self) -> None:
        if self._drain_reported:
            return
        self._drain_reported = True
        r = self.drain_report()
        counters.inc("serve_requests_unserved", len(r["unserved"]))
        logger.warning(
            f"serve drain complete: {r['completed']} request(s) "
            f"finished, {len(r['unserved'])} never admitted "
            f"(unserved ids: {r['unserved']}) — resubmit them elsewhere")

    def generate(self, requests: List[Request]) -> List[RequestResult]:
        """Submit everything, run to completion, return results in
        submission order."""
        ids = [self.submit(r) for r in requests]
        self.run()
        return [self.result(i) for i in ids]

    def stream(self, request_id: int):
        """Yield request ``request_id``'s tokens as the lagged ring
        resolves them, driving the engine in between."""
        seq = self._all[request_id]
        sent = 0
        idle = 0
        while True:
            if sent < len(seq.out_tokens):
                yield seq.out_tokens[sent]
                sent += 1
                continue
            if seq.finished:
                return
            if not self.step():
                raise RuntimeError(
                    f"request {request_id} streamed {sent} tokens but "
                    f"the engine ran out of work before it finished")
            idle = self._check_progress(idle)

    # -- results / metrics --------------------------------------------------

    def _drain_events(self) -> None:
        """Account every sequence the scheduler finished since the last
        call."""
        fin = self.scheduler.finished
        while fin:
            seq = fin.pop()
            a = self._agg
            if seq.finish_reason == "preempted":
                # journaled as a shed: a replay never serves it again
                if self._journal is not None:
                    self._journal.shed(rid=seq.sid, reason="preempted")
                self._preempted_ids.append(seq.sid)
                counters.inc("serve_requests_preempted")
                a["preempted"] += 1
                a["deadline_total"] += 1
                a["deadline_miss"] += 1
                continue
            self._completed += 1
            counters.inc("serve_requests_completed")
            counters.inc("serve_tokens_generated", len(seq.out_tokens))
            if self._journal is not None:
                # the dedupe key: once durable, no restart serves the id
                self._journal.completed(rid=seq.sid,
                                        tokens=seq.out_tokens,
                                        finish_reason=seq.finish_reason)
            a["requests"] += 1
            a["tokens"] += len(seq.out_tokens)
            a["ttft"].append(max(seq.t_first_token - seq.t_submit, 0.0))
            a["waits"].append(max(seq.t_admit - seq.t_submit, 0.0))
            a["gaps"].extend(b - x for x, b in
                             zip(seq.token_times, seq.token_times[1:]))
            a["t0"] = (seq.t_submit if a["t0"] is None
                       else min(a["t0"], seq.t_submit))
            a["t1"] = (seq.t_finish if a["t1"] is None
                       else max(a["t1"], seq.t_finish))
            a["prefix_hits"] += 1 if seq.cached_tokens else 0
            a["cached_tokens"] += seq.cached_tokens
            a["shared_blocks"] += seq.shared_blocks
            a["cow"] += 1 if seq.cow else 0
            if seq.deadline != float("inf"):
                a["deadline_total"] += 1
                a["deadline_miss"] += (1 if seq.t_finish > seq.deadline
                                       else 0)
            if self._metrics is not None:
                r = self.result(seq.sid)
                rec = {
                    "serve/ttft_s": r.ttft_s,
                    "serve/queue_wait_s": r.queue_wait_s,
                    "serve/total_s": r.total_s,
                    "serve/tokens": len(r.tokens),
                    "serve/tokens_per_sec": r.tokens_per_sec,
                    "serve/cached_prompt_tokens": r.cached_prompt_tokens,
                }
                if r.deadline_met is not None:
                    rec["serve/deadline_met"] = float(r.deadline_met)
                self._metrics.log(self._completed, rec)

    def result(self, request_id: int, pop: bool = False) -> RequestResult:
        """The finished request's tokens + SLO metrics; ``pop=True`` also
        drops the engine's record of it."""
        seq = self._all[request_id]
        if not seq.finished:
            raise RuntimeError(f"request {request_id} not finished")
        gaps = [b - a for a, b in zip(seq.token_times, seq.token_times[1:])]
        total = max(seq.t_finish - seq.t_submit, 1e-9)
        r = RequestResult(
            request_id=request_id,
            prompt_ids=[int(t) for t in seq.prompt],
            tokens=list(seq.out_tokens),
            finish_reason=seq.finish_reason,
            queue_wait_s=max(seq.t_admit - seq.t_submit, 0.0),
            ttft_s=max(seq.t_first_token - seq.t_submit, 0.0),
            total_s=total,
            token_latencies_s=gaps,
            tokens_per_sec=len(seq.out_tokens) / total,
            cached_prompt_tokens=seq.cached_tokens,
            deadline_met=(None if seq.deadline == float("inf")
                          else bool(seq.t_finish <= seq.deadline)),
            trace_id=seq.trace_id,
        )
        if pop:
            del self._all[request_id]
        return r

    def discard(self, request_id: int) -> None:
        """Drop a finished request's record without building a result."""
        seq = self._all[request_id]
        if not seq.finished:
            raise RuntimeError(f"request {request_id} not finished")
        del self._all[request_id]

    def stats(self) -> Dict[str, float]:
        """Aggregate SLO view over every request completed since the
        engine started or the last :meth:`reset_stats`."""
        a = self._agg
        if not a["requests"]:
            # a window of sheds alone is still shown
            return {"requests": 0, "shed": a["shed"],
                    "preempted": a["preempted"]}
        pool = self.scheduler.pool
        return {
            "requests": a["requests"],
            "tokens": a["tokens"],
            "tokens_per_sec": a["tokens"] / max(a["t1"] - a["t0"], 1e-9),
            "host_blocked_ms": self.blocked.peek_ms(),
            "ttft_s_p50": _percentile(a["ttft"], 50),
            "ttft_s_p95": _percentile(a["ttft"], 95),
            "queue_wait_s_p50": _percentile(a["waits"], 50),
            "queue_wait_s_p95": _percentile(a["waits"], 95),
            "per_token_s_p50": _percentile(a["gaps"], 50),
            "per_token_s_p95": _percentile(a["gaps"], 95),
            "prefix_hits": a["prefix_hits"],
            "prefix_hit_rate": a["prefix_hits"] / a["requests"],
            "prefill_tokens_saved": a["cached_tokens"],
            "prefix_blocks_reused": a["shared_blocks"],
            "cow_copies": a["cow"],
            "prefix_evictions": pool.evictions - self._evict_base,
            "prefix_cached_blocks": pool.cached,
            "deadline_requests": a["deadline_total"],
            "deadline_misses": a["deadline_miss"],
            "shed": a["shed"],
            "preempted": a["preempted"],
        }

    def admission_snapshot(self) -> Dict[str, Any]:
        """The strict-JSON load signal a router reads (JAX :1041): queue
        depth, slot and KV-block headroom, TTFT p95, the drain state and
        the prefix cache's hits."""
        sched = self.scheduler
        pool = sched.pool
        return {
            "queue_depth": len(self._queue),
            "slots_busy": sum(s is not None for s in sched.slot_seq),
            "slots_total": len(sched.slot_seq),
            "free_blocks": int(pool.available - pool.cached),
            "cached_blocks": int(pool.cached),
            "blocks_in_use": int(pool.in_use),
            "block_size": int(self.config.serve.block_size),
            "ttft_p95_ms": round(_percentile(self._agg["ttft"], 95) * 1e3,
                                 3),
            "draining": bool(self._draining),
            "completed": int(self._completed),
            "shed": len(self._shed_ids),
            "preempted": len(self._preempted_ids),
            "requests": int(self._agg["requests"]),
            "prefix_hits": int(self._agg["prefix_hits"]),
            "pid": os.getpid(),
        }

    def reset_stats(self) -> None:
        """Start a fresh stats() window (call after warm-up)."""
        self._agg = self._fresh_agg()
        self._evict_base = self.scheduler.pool.evictions
        self.blocked.take_ms()

    def close(self) -> None:
        with torch.inference_mode():
            self.scheduler.drain()
        self._drain_events()
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None
        if self._journal is not None:
            self._journal.close()
        if self._queue:
            logger.warning(
                f"ServeEngine closed with {len(self._queue)} queued "
                f"requests unserved")
