"""Async host -> device input feed with bucketing (the port of the core
of torchacc_tpu/data/async_loader.py ``AsyncLoader``, :90-620).

A producer thread fetches each batch from the source, pads it into the
buckets of ``config.data`` (``bucketing.pad_batch``) and uploads it; a
bounded queue of ``data.prefetch`` uploaded batches lets batch N+1's
upload overlap step N.  On a CUDA ``device`` the producer copies each
leaf into pinned host memory and from there to the card with a
``non_blocking`` copy on a side stream, then records an event; the
consumer makes its own stream wait on that event and marks every leaf
with ``record_stream``, so that the caching allocator does not reuse a
batch's memory while a step still reads it.  On the CPU the leaves are
copied into fresh tensors.

Durable state: ``state_dict()``/``load_state_dict()`` hold the
consumer-side batch count (the producer runs ahead of it) and the
source's own state where it has one (``PackedDataset``), in the JAX
package's schema; ``skip_batches(n)`` fast-forwards the source without
padding or uploading.  An early ``break`` in the consumer stops and
joins the producer thread.

Not ported here (ROADMAP A13): the fetch and transfer retries, the
chaos failpoints, the synchronous fallback, the stall deadline and the
bad-batch quarantine.  The batch sharding over a device mesh waits for
A8: with one device every leaf lands on ``device``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from torchacc_tpu_torch.config import Config
from torchacc_tpu_torch.data.bucketing import pad_batch
from torchacc_tpu_torch.data.dataset import DataLoaderError
from torchacc_tpu_torch.ops._common import resolve_device
from torchacc_tpu_torch.utils.logger import logger
from torchacc_tpu_torch.utils.metrics import counters

_SENTINEL = object()


class AsyncLoader:
    """Wrap an iterable of dict-of-arrays into an async device feed.

    Iterating yields dicts of tensors on ``device`` (the card unless the
    caller asks for the CPU).  ``wait_s`` is the host time the consumer
    of the current iteration has spent waiting on the queue."""

    def __init__(self, loader: Iterable[Dict[str, Any]], config: Config,
                 device: Optional[Union[str, torch.device]] = None):
        self._loader = loader
        self.device = resolve_device(device)
        self._buckets = config.data.bucket_sizes()
        self._pad_values = config.data.pad_value_dict
        self._prefetch = max(1, config.data.prefetch)
        self._stream = None
        # consumer-side batches delivered, and the source position after
        # the last delivered batch (equal here: nothing is skipped)
        self._consumed = 0
        self._src_pos = 0
        self._resume_state: Optional[Dict[str, Any]] = None
        self.wait_s = 0.0

    # -- durable state -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-serialisable resume state: the consumer-side count and
        the source's own ``state_dict()`` where it has one."""
        src_fn = getattr(self._loader, "state_dict", None)
        return {
            "version": 1,
            "kind": "async_loader",
            "batches_consumed": self._consumed,
            "source_position": self._src_pos,
            "source": src_fn() if callable(src_fn) else None,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Arm the next iteration to resume at the saved position: O(1)
        through the source's own ``load_state_dict`` where it has one,
        else a logged and counted replay of the consumed prefix."""
        self._resume_state = dict(state)

    # -- transfer --------------------------------------------------------------
    def _transfer(self, batch):
        """(leaves on the device, the upload's CUDA event or None)."""
        host = pad_batch(batch, self._buckets, self._pad_values)
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.array(v)).to(self.device)
                    for k, v in host.items()}, None
        with torch.cuda.stream(self._stream):
            dev = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def skip_batches(self, n: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Iterate after fast-forwarding ``n`` source batches without
        padding or uploading them."""
        return self._iterate(skip=n)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self._iterate(skip=0)

    def _iterate(self, skip: int) -> Iterator[Dict[str, torch.Tensor]]:
        resume, self._resume_state = self._resume_state, None
        if resume is not None:
            n = int(resume.get("batches_consumed", 0))
            spos = int(resume.get("source_position", n))
            src_state = resume.get("source")
            load_fn = getattr(self._loader, "load_state_dict", None)
            if src_state is not None and callable(load_fn):
                # the consumer-side position overrides the producer-side
                # one in the source's state (the producer ran ahead)
                src_state = dict(src_state)
                src_state["batches_consumed"] = spos
                load_fn(src_state)
            elif spos:
                counters.inc("resume_replayed_batches", spos)
                logger.warning(
                    f"resume: source exposes no durable state — replaying "
                    f"{spos} consumed batches to realign the stream")
                skip += spos
            self._consumed = n
            self._src_pos = spos
        else:
            self._consumed = skip
            self._src_pos = skip
        self.wait_s = 0.0
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        err: list = []
        stop = threading.Event()

        def _put(item) -> bool:
            # gives up when the consumer is gone, so that an early break
            # cannot leave the thread blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        it = iter(self._loader)
        base_idx = self._src_pos

        def produce():
            idx = base_idx
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                for _ in range(skip):
                    if stop.is_set() or next(it, _SENTINEL) is _SENTINEL:
                        return
                while not stop.is_set():
                    batch = next(it, _SENTINEL)
                    if batch is _SENTINEL:
                        break
                    dev, event = self._transfer(batch)
                    idx += 1
                    if not _put((dev, event, idx)):
                        return
            except Exception as e:
                err.append(e)
                logger.error(f"AsyncLoader producer failed: {e!r}")
            finally:
                _put(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True, name="async-loader")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is _SENTINEL:
                    if err:
                        raise DataLoaderError(
                            "input pipeline failed (batch fetch or "
                            "transfer)") from err[0]
                    return
                dev, event, pos = item
                if event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    for leaf in dev.values():
                        leaf.record_stream(cur)
                self._consumed += 1
                self._src_pos = pos
                yield dev
        finally:
            stop.set()
            # drain so that a producer blocked in _put sees stop, then
            # wait (bounded) for it to leave
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    def __len__(self) -> int:
        return len(self._loader)  # type: ignore[arg-type]
