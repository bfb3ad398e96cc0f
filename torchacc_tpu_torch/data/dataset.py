"""Packed dataset: documents -> fixed-shape batches (the port of
torchacc_tpu/data/dataset.py).

Accumulate documents, pack them into [rows, seq_len] with segment ids and
positions (``packing.pack_sequences``), emit fixed-size batches.  With
``AsyncLoader`` this is the input pipeline: one shape reaches the step.

Durable state: the packed row stream is a deterministic function of
(documents, shuffle permutation, seq_len, buffer_docs), so a mid-epoch
position is a handful of integers.  ``state_dict()`` /
``load_state_dict()`` make resume O(1) for seekable (Sequence) sources:
seek to the packing group holding the next undelivered row (the
cumulative row index ``_group_cum``), re-pack that one group, and
continue.  Non-seekable sources replay and discard the consumed prefix,
loudly (counter ``resume_replayed_batches``).  The state is JSON with the
JAX package's schema, so a state saved by either package loads in the
other.

Data sharding: ``batch_rows`` is the global batch; with
``num_shards``/``shard_index`` every host computes the same global row
stream and emits only its ``batch_rows / num_shards`` rows of each
batch, so a state saved at N hosts resumes at M.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from torchacc_tpu_torch.data.packing import pack_sequences
from torchacc_tpu_torch.utils.logger import logger
from torchacc_tpu_torch.utils.metrics import counters

class DataLoaderError(RuntimeError):
    """The input pipeline failed fatally, or a saved loader state does
    not describe this stream."""


#: state_dict keys that pin the packed stream itself — a mismatch means
#: the saved position indexes a DIFFERENT stream and resume would be
#: silently misaligned.
_GEOMETRY_KEYS = ("seq_len", "buffer_docs", "shuffle_seed")


class PackedDataset:
    """Wrap an iterable of token arrays into packed fixed-shape batches.

    Yields {"input_ids", "segment_ids", "positions"} of shape
    [batch_rows / num_shards, seq_len].  Rows are filled by
    first-fit-decreasing packing over a sliding buffer of
    ``buffer_docs`` documents; short final batches are dropped (static
    shapes) unless ``pad_final``.

    ``shuffle_seed`` (seekable sources only) shuffles document order
    per epoch with a permutation keyed on ``(seed, epoch)`` — iterating
    the dataset again after a completed pass advances the epoch.
    ``num_shards``/``shard_index`` slice each global batch for this
    host (see module docstring).  One live iterator per instance: the
    instance tracks that iterator's position for ``state_dict()``.
    """

    def __init__(
        self,
        documents: Iterable[Any],
        seq_len: int,
        batch_rows: int,
        *,
        buffer_docs: int = 512,
        pad_id: int = 0,
        pad_final: bool = False,
        shuffle_seed: Optional[int] = None,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        if num_shards < 1 or not (0 <= shard_index < num_shards):
            raise ValueError(
                f"need 0 <= shard_index < num_shards, got "
                f"{shard_index}/{num_shards}")
        if batch_rows % num_shards:
            raise ValueError(
                f"batch_rows {batch_rows} not divisible by num_shards "
                f"{num_shards}")
        self._docs = documents
        self.seq_len = seq_len
        self.batch_rows = batch_rows
        self.buffer_docs = buffer_docs
        self.pad_id = pad_id
        self.pad_final = pad_final
        self.shuffle_seed = shuffle_seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        if shuffle_seed is not None and not self._seekable():
            raise ValueError(
                "shuffle_seed requires a seekable (Sequence) document "
                "source — a plain iterator cannot be permuted")
        # live-iterator position (producer side under AsyncLoader; the
        # loader overrides batches_consumed with its consumer-side count)
        self._epoch = 0
        self._batches_emitted = 0
        # set at epoch end instead of bumping _epoch in place: a live
        # state_dict() between the producer finishing the pass and the
        # consumer draining the prefetched tail must still describe the
        # CURRENT epoch (the consumer's position indexes it)
        self._completed = False
        #: cumulative GLOBAL row count after each packed group — the
        #: seek index that makes resume O(1): one bisect + one group
        #: re-pack instead of replaying every consumed batch
        self._group_cum: List[int] = []
        self._resume: Optional[Dict[str, Any]] = None

    # -- durable state -------------------------------------------------------
    def _seekable(self) -> bool:
        return hasattr(self._docs, "__len__") and hasattr(
            self._docs, "__getitem__")

    def state_dict(self) -> Dict[str, Any]:
        """JSON-serialisable mid-epoch position (see module docstring).
        ``batches_consumed`` counts GLOBAL batches — identical on every
        shard, so the state is world-size independent."""
        return {
            "version": 1,
            "kind": "packed_dataset",
            "epoch": self._epoch,
            "batches_consumed": self._batches_emitted,
            "seq_len": self.seq_len,
            "batch_rows": self.batch_rows,
            "buffer_docs": self.buffer_docs,
            "shuffle_seed": self.shuffle_seed,
            "num_shards": self.num_shards,
            "shard_index": self.shard_index,
            "group_cum_rows": list(self._group_cum),
            "seekable": self._seekable(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Position the NEXT ``iter()`` at the saved mid-epoch point.

        Geometry keys (seq_len/buffer_docs/shuffle_seed) must match —
        they pin the packed stream, and a silent mismatch would deliver
        wrong batches.  ``batch_rows`` must match as global rows.  A
        *shard* change is fine: that is elastic resume, and the
        assignment is recomputed for this instance's
        ``num_shards``/``shard_index``."""
        for k in _GEOMETRY_KEYS:
            if state.get(k) != getattr(self, k):
                raise DataLoaderError(
                    f"loader-state mismatch: saved {k}={state.get(k)!r} "
                    f"but this dataset has {k}={getattr(self, k)!r} — "
                    "the saved position indexes a different packed "
                    "stream")
        if state.get("batch_rows") != self.batch_rows:
            raise DataLoaderError(
                f"loader-state mismatch: saved global batch_rows="
                f"{state.get('batch_rows')} but this dataset has "
                f"{self.batch_rows} — resume requires equal global batch")
        if (state.get("num_shards"), state.get("shard_index")) != (
                self.num_shards, self.shard_index):
            logger.info(
                f"elastic resume: data-shard assignment recomputed "
                f"(saved shard {state.get('shard_index')}/"
                f"{state.get('num_shards')} -> current "
                f"{self.shard_index}/{self.num_shards})")
        self._resume = dict(state)

    # -- iteration -----------------------------------------------------------
    def _perm(self, epoch: int) -> Optional[np.ndarray]:
        if self.shuffle_seed is None:
            return None
        return np.random.default_rng(
            [int(self.shuffle_seed), int(epoch)]).permutation(
                len(self._docs))  # type: ignore[arg-type]

    def _doc_stream(self, epoch: int, start_group: int) -> Iterator[Any]:
        if self._seekable():
            order = self._perm(epoch)
            if order is None:
                order = np.arange(len(self._docs))  # type: ignore[arg-type]
            for i in order[start_group * self.buffer_docs:]:
                yield self._docs[int(i)]  # type: ignore[index]
        else:
            assert start_group == 0, "non-seekable sources cannot seek"
            yield from self._docs

    def _packed_groups(self, epoch: int,
                       start_group: int) -> Iterator[Dict[str, np.ndarray]]:
        """Pack ``buffer_docs``-sized groups from ``start_group`` on,
        maintaining the cumulative-row seek index."""
        buf: List[np.ndarray] = []
        for doc in self._doc_stream(epoch, start_group):
            buf.append(np.asarray(doc, np.int32).reshape(-1))
            if len(buf) >= self.buffer_docs:
                yield self._emit_group(buf)
                buf = []
        if buf:
            yield self._emit_group(buf)

    def _emit_group(self, buf: List[np.ndarray]) -> Dict[str, np.ndarray]:
        packed = pack_sequences(buf, self.seq_len, pad_id=self.pad_id)
        base = self._group_cum[-1] if self._group_cum else 0
        self._group_cum.append(base + packed["input_ids"].shape[0])
        return packed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        resume, self._resume = self._resume, None
        start_group, skip_rows, start_batch = 0, 0, 0
        if resume is not None:
            epoch = int(resume.get("epoch", 0))
            start_batch = int(resume.get("batches_consumed", 0))
            r0 = start_batch * self.batch_rows
            cum = [int(c) for c in resume.get("group_cum_rows") or []]
            if self._seekable():
                # O(1) seek: bisect to the group holding row r0, re-pack
                # only from there, discard the rows already delivered
                start_group = bisect_right(cum, r0)
                base = cum[start_group - 1] if start_group else 0
                skip_rows = r0 - base
                self._group_cum = cum[:start_group]
            else:
                counters.inc("resume_replayed_batches", start_batch)
                logger.warning(
                    f"resume: document source is not seekable — replaying "
                    f"{start_batch} consumed batches to realign the "
                    "stream (wrap a Sequence source for O(1) resume)")
                skip_rows = r0
                self._group_cum = []
            self._epoch = epoch
        else:
            if self._completed:
                # the previous pass finished: this iteration is a new
                # epoch (fresh shuffle permutation when seeded)
                self._epoch += 1
            epoch = self._epoch
            self._group_cum = []
        self._completed = False
        self._batches_emitted = start_batch
        yield from self._iterate(epoch, start_group, skip_rows, start_batch)

    def _iterate(self, epoch: int, start_group: int, skip_rows: int,
                 start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        R = self.batch_rows
        per_shard = R // self.num_shards
        lo = self.shard_index * per_shard
        pending: List[Dict[str, np.ndarray]] = []
        n_pending = 0

        def emit(pad: bool = False):
            nonlocal pending, n_pending
            cat = {k: np.concatenate([p[k] for p in pending])
                   for k in pending[0]}
            take = min(R, cat["input_ids"].shape[0])
            batch = {k: v[:take] for k, v in cat.items()}
            if pad and take < R:
                extra = R - take
                batch = {
                    "input_ids": np.concatenate(
                        [batch["input_ids"],
                         np.full((extra, self.seq_len), self.pad_id,
                                 np.int32)]),
                    "segment_ids": np.concatenate(
                        [batch["segment_ids"],
                         np.full((extra, self.seq_len), -1, np.int32)]),
                    "positions": np.concatenate(
                        [batch["positions"],
                         np.zeros((extra, self.seq_len), np.int32)]),
                }
            rest = {k: v[take:] for k, v in cat.items()}
            n_rest = rest["input_ids"].shape[0]
            pending = [rest] if n_rest else []
            n_pending = n_rest
            self._batches_emitted += 1
            return {k: v[lo:lo + per_shard] for k, v in batch.items()}

        for packed in self._packed_groups(epoch, start_group):
            if skip_rows:
                rows = packed["input_ids"].shape[0]
                take = min(skip_rows, rows)
                skip_rows -= take
                if take == rows:
                    continue
                packed = {k: v[take:] for k, v in packed.items()}
            pending.append(packed)
            n_pending += packed["input_ids"].shape[0]
            while n_pending >= R:
                yield emit()
        if n_pending and self.pad_final:
            yield emit(pad=True)
        # a full pass completed: the NEXT plain iteration advances the
        # epoch — deferred (not bumped here) so a state_dict() taken
        # while the consumer drains the prefetched tail still labels
        # the position with the epoch it belongs to
        self._completed = True
