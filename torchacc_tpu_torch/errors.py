"""Errors of the port (the port's own copy of the classes it needs from
torchacc_tpu/errors.py, with the same hierarchy and fields)."""

from __future__ import annotations

from typing import Optional


class TorchAccTPUError(Exception):
    """Base class for framework-raised errors."""


class CheckpointError(TorchAccTPUError):
    """Checkpoint save/restore failed (I/O, corruption, retry exhausted)."""


class CheckpointNotFoundError(CheckpointError, FileNotFoundError):
    """No (valid) checkpoint exists where one was requested.  Also a
    ``FileNotFoundError``, so ``except FileNotFoundError`` callers of
    ``CheckpointManager.restore`` keep working."""


class CheckpointCorruptionError(CheckpointError):
    """A checkpoint step exists but failed integrity validation
    (missing/unparseable manifest, tree-structure digest mismatch, or an
    unreadable payload)."""


class TopologyMismatchError(CheckpointError):
    """The checkpoint was saved under another mesh/process topology than
    the one restoring it, and the change is not one elastic resume
    supports (tp/pp/sp/spu/ep reshapes, or a data-parallel reshape with
    ``resilience.elastic_resume`` off).  Carries the differing axes and
    the human-readable schema diff."""

    def __init__(self, message: str, *, axes: Optional[list] = None,
                 diff: Optional[list] = None):
        super().__init__(message)
        self.axes = list(axes or [])
        self.diff = list(diff or [])


class StateSchemaError(CheckpointError):
    """The checkpoint's state schema (leaf paths, shapes, dtypes) does
    not match the target state.  Carries a human-readable diff."""

    def __init__(self, message: str, *, diff: Optional[list] = None):
        super().__init__(message)
        self.diff = list(diff or [])


class TrainerStateError(TorchAccTPUError):
    """The Trainer was driven in an invalid order (e.g. ``save()`` before
    ``init()``/``step()``, or ``fit(resume='auto')`` without a
    ``checkpoint_dir``)."""


class CoordinationError(TorchAccTPUError, RuntimeError):
    """A cross-process coordination primitive failed or timed out: the
    process group could not be joined.  Carries the primitive's name
    and the timeout, so that a dead coordinator is told apart from a
    logic error without running again."""

    def __init__(self, message: str, *, primitive: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        super().__init__(message)
        self.primitive = primitive
        self.timeout_s = timeout_s
