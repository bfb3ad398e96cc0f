"""Serving configuration (torchacc_tpu/config.py ``ServeConfig`` and its
``validate``), plus a small ``Config`` whose ``.serve`` is the block
the engine reads.

Only the fields this slice implements are here: the journal, deadline
shedding and preemption, and graceful drain are not ported yet
(ROADMAP.md, queue A), so their switches are absent rather than
silently ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ConfigError(ValueError):
    """An invalid configuration value."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ConfigError(msg)


@dataclass
class ServeConfig:
    """Serving engine policy.  See torchacc_tpu/config.py for the long
    form of every field; the semantics are the same."""

    # tokens per KV block
    block_size: int = 16
    # blocks in the pool; block 0 is the reserved null block
    num_blocks: int = 512
    # max sequences decoding in one batched step
    max_slots: int = 8
    # chunked prefill: tokens of one sequence prefilled per iteration
    prefill_chunk: int = 64
    # distinct sequences whose chunks prefill together per iteration
    prefill_batch: int = 1
    # shared-prefix KV reuse over the paged pool
    prefix_cache: bool = False
    # 'fcfs' | 'sjf' | 'priority'
    policy: str = "fcfs"
    # 'priority' policy aging: +1 class per priority_aging_s waited
    priority_aging_s: float = 30.0
    # iterations kept in flight before the host reads tokens back
    decode_depth: int = 2
    # default per-request new-token cap
    max_new_tokens: int = 128
    # bound on the admission queue; submit() raises when full
    max_queue: int = 4096

    def validate(self) -> None:
        _check(self.block_size >= 1, "serve.block_size must be >= 1")
        _check(self.num_blocks >= 2,
               "serve.num_blocks must be >= 2 (block 0 is the reserved "
               "null block)")
        _check(self.max_slots >= 1, "serve.max_slots must be >= 1")
        _check(self.prefill_chunk >= 1, "serve.prefill_chunk must be >= 1")
        _check(self.prefill_batch >= 1, "serve.prefill_batch must be >= 1")
        _check(self.policy in ("fcfs", "sjf", "priority"),
               f"serve.policy must be fcfs|sjf|priority, got {self.policy}")
        _check(self.priority_aging_s >= 0,
               "serve.priority_aging_s must be >= 0")
        _check(self.decode_depth >= 1, "serve.decode_depth must be >= 1")
        _check(self.max_new_tokens >= 1, "serve.max_new_tokens must be >= 1")
        _check(self.max_queue >= 1, "serve.max_queue must be >= 1")


@dataclass
class Config:
    """The framework config; this slice reads only ``serve``."""

    serve: ServeConfig = field(default_factory=ServeConfig)
