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

Left out of this slice (ROADMAP.md): the request journal and
``recover``, deadline shedding and preemption, graceful drain,
``from_train_state``/``load_params`` and the telemetry session.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from torchacc_tpu_torch.config import Config
from torchacc_tpu_torch.ops._common import resolve_device
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


@dataclasses.dataclass
class RequestResult:
    """Tokens + the per-request SLO metrics."""

    request_id: int
    prompt_ids: List[int]
    tokens: List[int]                        # generated tokens only
    finish_reason: str                       # 'eos' | 'length'
    queue_wait_s: float                      # submit -> slot admission
    ttft_s: float                            # submit -> first token
    total_s: float                           # submit -> finish
    token_latencies_s: List[float]           # inter-token gaps
    tokens_per_sec: float
    cached_prompt_tokens: int = 0
    deadline_met: Optional[bool] = None


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
        self._agg = self._fresh_agg()
        self._evict_base = 0

    @staticmethod
    def _fresh_agg() -> Dict:
        return {"ttft": [], "waits": [], "gaps": [], "tokens": 0,
                "requests": 0, "t0": None, "t1": None,
                "prefix_hits": 0, "cached_tokens": 0, "shared_blocks": 0,
                "cow": 0, "deadline_total": 0, "deadline_miss": 0}

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request, on_token=None) -> int:
        """Queue a request; returns its id.  Raises when the request can
        never be served or the queue is full.  ``on_token(token,
        t_monotonic)`` is called as the lagged ring resolves each token."""
        serve = self.config.serve
        seq = self._build_seq(req, self._next_id, on_token)
        if len(self._queue) >= serve.max_queue:
            raise RuntimeError(
                f"admission queue full ({serve.max_queue}); shed load "
                f"upstream or raise serve.max_queue")
        seq.t_submit = time.monotonic()
        if req.deadline_s is not None:
            seq.deadline = seq.t_submit + req.deadline_s
        self._next_id += 1
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
        seq = Sequence(sid=rid, prompt=prompt, max_new=max_new,
                       temperature=req.temperature, top_k=req.top_k,
                       top_p=req.top_p, eos_id=req.eos_id, seed=req.seed,
                       priority=req.priority, on_token=on_token)
        need = self.scheduler.blocks_for(seq)
        if need > self.scheduler.max_blocks_per_seq:
            raise ValueError(
                f"request needs {need} KV blocks (prompt "
                f"{prompt.shape[0]} + max_new {max_new}) but a sequence "
                f"may own at most {self.scheduler.max_blocks_per_seq} "
                f"(min of pool size serve.num_blocks - 1 and the model's "
                f"position reach max_seq_len); raise serve.num_blocks / "
                f"the model max_seq_len or lower max_new_tokens")
        return seq

    # -- the loop -----------------------------------------------------------

    def _admit(self) -> None:
        """Move queue entries into free slots while headroom lasts
        ('fcfs' stops at the first miss; 'sjf' and 'priority' may skip a
        request that does not fit)."""
        if not self._queue or self.scheduler.free_slot() is None:
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
        accounting).  Returns True while there is work anywhere."""
        with torch.inference_mode():
            self._admit()
            self.scheduler.step()
        self._drain_events()
        return bool(self._queue) or self.scheduler.busy()

    def _check_progress(self, idle: int) -> int:
        """Queued work that can never admit while nothing runs is a
        configuration error, not a reason to spin."""
        if self._queue and not self.scheduler.busy():
            idle += 1
            if idle > 3:
                raise RuntimeError(
                    "serving stalled: queued requests cannot be admitted "
                    "and no sequence is running")
            return idle
        return 0

    def run(self, max_iters: int = 1_000_000) -> None:
        """Drive until every submitted request completed."""
        idle = 0
        for _ in range(max_iters):
            if not self.step():
                return
            idle = self._check_progress(idle)
        raise RuntimeError(f"run() exceeded {max_iters} iterations")

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
            self._completed += 1
            counters.inc("serve_requests_completed")
            counters.inc("serve_tokens_generated", len(seq.out_tokens))
            a = self._agg
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
            return {"requests": 0}
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
        if self._queue:
            logger.warning(
                f"ServeEngine closed with {len(self._queue)} queued "
                f"requests unserved")
