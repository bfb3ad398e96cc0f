"""The parts of torchacc_tpu/utils/metrics.py the serving engine and the
checkpoints use:
the host-blocked meter, the process-wide counters and a JSONL metrics
writer (one JSON object per logged record; single process, so no
per-host file split and no TensorBoard sink)."""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Dict, Optional, Union

Number = Union[int, float]


class BlockedMeter:
    """Host-blocked wall-time accumulator (the ``host_blocked_ms``
    seam): the engine wraps every token readback in :meth:`blocked`."""

    __slots__ = ("_acc",)

    def __init__(self):
        self._acc = 0.0

    @contextlib.contextmanager
    def blocked(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc += time.perf_counter() - t0

    def peek_ms(self) -> float:
        return self._acc * 1e3

    def take_ms(self) -> float:
        """Pop the accumulated blocked time (ms) since the last take."""
        v, self._acc = self._acc * 1e3, 0.0
        return v


class Counters:
    """Process-wide monotonic counters (serving: ``prefix_hits``,
    ``prefix_blocks_reused``, ``prefix_evictions``, ``cow_copies``,
    ``serve_requests_*``, ``serve_tokens_generated``; checkpoints:
    ``ckpt_retries``, ``resumes``, ``elastic_reshards``,
    ``resume_replayed_batches``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n
            return self._c[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)


#: The process-wide instance every subsystem shares.
counters = Counters()


class MetricsWriter:
    """Scalar metrics sink: ``<logdir>/metrics.jsonl``, one strict-JSON
    object per record (non-finite values become ``null`` and are
    counted in ``metrics_nonfinite_values``)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a",
                           buffering=1)

    def log(self, step: int, scalars: Dict[str, Number]) -> None:
        vals = {k: float(v) for k, v in scalars.items()}
        rec: Dict[str, Optional[float]] = {"step": int(step),
                                           "time": time.time()}
        for k, v in vals.items():
            if math.isfinite(v):
                rec[k] = v
            else:
                rec[k] = None
                counters.inc("metrics_nonfinite_values")
        self._jsonl.write(json.dumps(rec, allow_nan=False) + "\n")

    def close(self) -> None:
        self._jsonl.close()


def open_metrics(logdir: Optional[str]) -> Optional[MetricsWriter]:
    """None-safe constructor for call sites with an optional dir."""
    if not logdir:
        return None
    return MetricsWriter(logdir)
