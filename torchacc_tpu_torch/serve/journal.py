"""The durable request journal (the port's copy of
torchacc_tpu/serve/journal.py, which imports no JAX): serving's state
capture and replay.

- :class:`RequestJournal` appends one strict-JSON line per event to
  ``<journal_dir>/journal.jsonl``: ``accepted`` when ``submit()``
  validates a request (id, trace id, prompt hash and token ids, sampling
  parameters, priority, the absolute wall-clock deadline, arrival
  time), ``completed`` when the engine resolves its last token (tokens
  and finish reason), ``shed`` when deadline shedding or preemption
  drops it.  Each append is flushed (and fsync'd by default) before
  ``submit()`` returns or the completion is visible, so the journal is
  never behind what a caller was told.
- :func:`read_journal` reads the files back: the one torn line a
  mid-write kill can leave is at the tail (one appender), and it is
  skipped, never fatal.
- :func:`replay_state` folds the records into what a restart must do:
  every accepted request with no terminal record, the completed ids (the
  dedupe set: a replayed engine never serves them twice) and the shed
  ids.

The file format is the JAX package's, line for line (the same record
kinds, keys, compact separators and file names), so each package reads
the other's journal to the same :func:`replay_state`.
``ServeEngine.recover()`` (``serve/engine.py``) consumes it.

Not ported: the off-host archive tier (``archive_store``, JAX :308 and
``read_archived_terminals`` :469), which uploads each rotation's terminal
records through the object-store client of ``torchacc_tpu/store/``
(ROADMAP A13d); asking for it raises by name.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from torchacc_tpu_torch.utils.logger import logger

#: the active journal file inside ``serve.journal_dir`` (one engine, one
#: journal; engines side by side need their own directories)
JOURNAL_NAME = "journal.jsonl"

#: the terminal records of rotated-out segments, compacted
ARCHIVE_NAME = "journal-archive.jsonl"

#: rotated-out segments are ``journal-<seq:05d>.jsonl``; compaction
#: removes each once its records live in the archive and the new active
#: file
SEGMENT_PREFIX = "journal-"

#: the record kinds a journal line may carry
KINDS = ("accepted", "completed", "shed")


def _unported_archive() -> None:
    raise NotImplementedError(
        "the journal's off-host archive (archive_store, "
        "read_archived_terminals) needs the object-store client, which is "
        "not ported to torchacc_tpu_torch yet (ROADMAP.md A13d)")


def _line(record: Dict[str, Any]) -> bytes:
    return (json.dumps(record, allow_nan=False, separators=(",", ":"))
            + "\n").encode()


def _segments(names: List[str]) -> List[str]:
    return [n for n in names
            if n.startswith(SEGMENT_PREFIX) and n.endswith(".jsonl")
            and n != ARCHIVE_NAME
            and n[len(SEGMENT_PREFIX):-len(".jsonl")].isdigit()]


def journal_files(journal_dir: str) -> List[str]:
    """Every journal file under ``journal_dir`` in replay order: the
    archive first (the oldest terminal records), then the rotated
    segments by sequence number, then the active file."""
    try:
        names = os.listdir(journal_dir)
    except OSError:
        return []
    ordered: List[str] = []
    if ARCHIVE_NAME in names:
        ordered.append(ARCHIVE_NAME)
    ordered.extend(sorted(_segments(names)))
    if JOURNAL_NAME in names:
        ordered.append(JOURNAL_NAME)
    return [os.path.join(journal_dir, n) for n in ordered]


def prompt_digest(prompt_ids) -> str:
    """A stable hash of a prompt's token ids (the journal's audit key)."""
    h = hashlib.sha256()
    for t in prompt_ids:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return h.hexdigest()[:16]


class RequestJournal:
    """Append-only strict-JSON event log of one serving engine.

    ``fsync=True`` (the default) makes every append durable before it
    returns: an id the caller was given has an ``accepted`` record, and
    tokens a caller could have read have a ``completed`` record.
    ``fsync=False`` keeps the flush (it survives a process kill, not a
    power loss).

    Rotation and compaction (``rotate_bytes`` / ``rotate_age_s``): when
    the active file crosses either bound at an append boundary it is
    renamed to ``journal-<seq>.jsonl`` and a fresh active file opens; the
    segment's terminal records go to ``journal-archive.jsonl``, its
    still-pending ``accepted`` records are appended again to the new
    active file (the first accepted record wins, so a duplicate is
    harmless), and only then is the segment deleted.  Every crash point
    leaves the segment or its compacted successor on disk, never
    neither."""

    def __init__(self, journal_dir: str, *, fsync: bool = True,
                 rotate_bytes: Optional[int] = None,
                 rotate_age_s: Optional[float] = None,
                 archive_store: Any = None):
        if archive_store is not None:
            _unported_archive()
        self.dir = journal_dir
        self.path = os.path.join(journal_dir, JOURNAL_NAME)
        self.fsync = bool(fsync)
        self.rotate_bytes = (None if not rotate_bytes
                             else max(int(rotate_bytes), 1))
        self.rotate_age_s = (None if not rotate_age_s
                             else max(float(rotate_age_s), 0.001))
        self.rotations = 0
        os.makedirs(journal_dir, exist_ok=True)
        self._f = open(self.path, "ab")
        try:
            st = os.fstat(self._f.fileno())
            # the active segment's age: the existing file's mtime on a
            # restart, now for a fresh file
            self._active_since = (st.st_mtime if st.st_size > 0
                                  else time.time())
        except OSError:
            self._active_since = time.time()
        # a failed append here or a kill mid-append before may have left
        # bytes with no trailing newline: the next append writes a
        # newline first, so it does not join that torn fragment (the
        # joined line would be skipped on replay, losing the later
        # record)
        self._torn = self._tail_unterminated()

    def _tail_unterminated(self) -> bool:
        """True when the existing file ends mid-line."""
        try:
            with open(self.path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return False
                f.seek(-1, os.SEEK_END)
                return f.read(1) != b"\n"
        except OSError:
            return False

    def append(self, record: Dict[str, Any]) -> None:
        """One strict-JSON line, flushed (and fsync'd) before it
        returns."""
        if record.get("kind") not in KINDS:
            raise ValueError(f"journal record kind must be one of "
                             f"{KINDS}, got {record.get('kind')!r}")
        line = _line(record)
        try:
            if self._torn:
                self._f.write(b"\n")     # seal the torn fragment
                self._f.flush()
                self._torn = False
            self._f.write(line)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        except OSError:
            self._torn = True
            raise
        self._maybe_rotate()

    def _maybe_rotate(self) -> None:
        """Roll the active file over when it crosses the size or age
        bound.  A failed rotation never fails the append that asked for
        it: the active file grows and the next append tries again."""
        if self.rotate_bytes is None and self.rotate_age_s is None:
            return
        try:
            size = self._f.tell()
        except OSError:
            return
        over_size = (self.rotate_bytes is not None
                     and size >= self.rotate_bytes)
        over_age = (self.rotate_age_s is not None
                    and time.time() - self._active_since
                    >= self.rotate_age_s)
        if not (over_size or over_age) or size == 0:
            return
        try:
            self._rotate()
        except OSError as e:
            logger.warning(f"request journal {self.path}: rotation "
                           f"failed ({e!r}); the active file keeps "
                           "growing until the next append retries")

    def _next_segment_path(self) -> str:
        try:
            names = os.listdir(self.dir)
        except OSError:
            names = []
        seqs = [int(n[len(SEGMENT_PREFIX):-len(".jsonl")])
                for n in _segments(names)]
        return os.path.join(
            self.dir, f"{SEGMENT_PREFIX}{max(seqs, default=0) + 1:05d}"
            ".jsonl")

    def _rotate(self) -> None:
        """active -> segment -> (archived terminals + pending admissions
        carried forward) -> the segment deleted, each step durable
        before the next."""
        seg = self._next_segment_path()
        self._f.close()
        os.rename(self.path, seg)
        self._f = open(self.path, "ab")
        self._torn = False
        self._active_since = time.time()
        pending, completed, shed = replay_state(read_journal(seg))
        with open(os.path.join(self.dir, ARCHIVE_NAME), "ab") as ar:
            for rec in list(completed.values()) + list(shed.values()):
                ar.write(_line(rec))
            ar.flush()
            os.fsync(ar.fileno())
        # the pending admissions, in their order of acceptance
        for rec in pending.values():
            self._f.write(_line(rec))
        self._f.flush()
        os.fsync(self._f.fileno())
        os.unlink(seg)
        self.rotations += 1
        logger.info(
            f"request journal {self.path}: rotated segment "
            f"{os.path.basename(seg)} — {len(completed) + len(shed)} "
            f"terminal record(s) archived, {len(pending)} pending "
            "admission(s) carried forward")

    def accepted(self, *, rid: int, trace_id: str, prompt_ids,
                 max_new_tokens: int, temperature: float, top_k: int,
                 top_p: float, eos_id: Optional[int], seed: int,
                 priority: int, deadline_unix: Optional[float]) -> None:
        """The admission record; ``deadline_unix`` is absolute wall time,
        so that a replay after a restart can judge whether it passed
        while the process was down."""
        self.append({
            "kind": "accepted", "rid": int(rid), "trace_id": trace_id,
            "prompt_sha": prompt_digest(prompt_ids),
            "prompt_ids": [int(t) for t in prompt_ids],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p),
            "eos_id": None if eos_id is None else int(eos_id),
            "seed": int(seed), "priority": int(priority),
            "deadline_unix": (None if deadline_unix is None
                              else float(deadline_unix)),
            "t_accept": time.time(),
        })

    def completed(self, *, rid: int, tokens, finish_reason: str) -> None:
        self.append({
            "kind": "completed", "rid": int(rid),
            "tokens": [int(t) for t in tokens],
            "finish_reason": finish_reason, "t_complete": time.time(),
        })

    def shed(self, *, rid: int, reason: str) -> None:
        self.append({"kind": "shed", "rid": int(rid), "reason": reason,
                     "t_shed": time.time()})

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def read_journal(path: str) -> List[Dict[str, Any]]:
    """The records of a journal file, or of every journal file in a
    directory in replay order (:func:`journal_files`).  A line that does
    not parse is skipped with a warning: with one appender only the tail
    can be torn, and a torn completion merely serves one request
    again."""
    if os.path.isdir(path):
        records: List[Dict[str, Any]] = []
        for p in journal_files(path):
            records.extend(read_journal(p))
        return records
    records = []
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return records
    for i, line in enumerate(raw.splitlines()):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            logger.warning(
                f"request journal {path}: skipping unparseable line "
                f"{i + 1} ({len(line)} bytes — a torn tail from an "
                f"unclean exit is expected; anything else is not)")
            continue
        if isinstance(rec, dict) and rec.get("kind") in KINDS:
            records.append(rec)
    return records


def replay_state(records: List[Dict[str, Any]]
                 ) -> Tuple[Dict[int, Dict[str, Any]], Dict[int, Dict],
                            Dict[int, Dict]]:
    """``(pending, completed, shed)``, each a dict by request id:
    ``pending`` the accepted records without a terminal record (the
    replay set, in order of acceptance; a duplicate admission keeps the
    first), ``completed`` and ``shed`` the terminal records (the dedupe
    sets)."""
    accepted: Dict[int, Dict[str, Any]] = {}
    completed: Dict[int, Dict[str, Any]] = {}
    shed: Dict[int, Dict[str, Any]] = {}
    for rec in records:
        rid = rec.get("rid")
        if not isinstance(rid, int):
            continue
        kind = rec["kind"]
        if kind == "accepted":
            accepted.setdefault(rid, rec)
        elif kind == "completed":
            completed[rid] = rec
        elif kind == "shed":
            shed[rid] = rec
    pending = {rid: rec for rid, rec in accepted.items()
               if rid not in completed and rid not in shed}
    return pending, completed, shed


def read_archived_terminals(store: Any, *,
                            prefix: str = "journal-archive"
                            ) -> List[Dict[str, Any]]:
    """The off-host archive's terminal records: not ported (raises)."""
    _unported_archive()
