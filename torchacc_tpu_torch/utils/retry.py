"""Retry with jittered exponential backoff (the port of
torchacc_tpu/utils/retry.py ``RetryPolicy`` and ``retry_call``): the
checkpoint I/O wraps every save and restore in it, and
``parallel.initialize_distributed`` its join, so that a storage or
rendezvous blip below the retry limit is a log line and a count, not a
dead run.  Every retried attempt increments a counter of
``utils/metrics.py`` (``counter=``) and logs at WARNING; the last error
is re-raised unchanged, so callers keep their own typed wrapping.
``CircuitBreaker`` comes with the operations plane (ROADMAP A13)."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from torchacc_tpu_torch.utils.logger import logger
from torchacc_tpu_torch.utils.metrics import counters

# the JAX package's defaults, which no caller of the port changes
_MULTIPLIER = 2.0
_JITTER = 0.5


@dataclass(frozen=True)
class RetryPolicy:
    """How to retry a transient failure.

    ``max_retries`` counts *re*-tries: the call is attempted at most
    ``max_retries + 1`` times.  The delay before retry ``k`` (0-based)
    is ``min(base_delay_s * 2**k, max_delay_s)`` times a uniform jitter
    in ``[0.5, 1.5]``.  ``deadline_s`` bounds the total wall-clock spent
    (attempts and sleeps): once it would be exceeded, no further attempt
    is made and the last error is re-raised."""

    max_retries: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0
    deadline_s: Optional[float] = None

    def delay(self, attempt: int) -> float:
        base = min(self.base_delay_s * (_MULTIPLIER ** attempt),
                   self.max_delay_s)
        return base * (1.0 - _JITTER + 2.0 * _JITTER * random.random())


def retry_call(fn: Callable[[], Any], policy: RetryPolicy,
               description: str, counter: Optional[str] = None) -> Any:
    """Call ``fn()``, retrying any ``Exception`` per ``policy``.

    ``counter`` names a ``utils.metrics.counters`` entry incremented once
    per retried attempt.  The last exception is re-raised unchanged
    (earlier attempts visible through ``__context__``)."""
    start = time.monotonic()
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except Exception as e:
            if attempt >= policy.max_retries:
                raise
            delay = policy.delay(attempt)
            if (policy.deadline_s is not None
                    and time.monotonic() - start + delay > policy.deadline_s):
                logger.warning(
                    f"{description}: attempt {attempt + 1} failed ({e!r}) "
                    f"and the {policy.deadline_s:.1f}s retry deadline is "
                    f"exhausted")
                raise
            if counter is not None:
                counters.inc(counter)
            logger.warning(
                f"{description}: attempt {attempt + 1}/"
                f"{policy.max_retries + 1} failed ({e!r}); retrying in "
                f"{delay:.2f}s")
            time.sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
