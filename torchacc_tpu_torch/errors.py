"""Errors of the port (the port's own copy of the classes it needs from
torchacc_tpu/errors.py)."""

from __future__ import annotations

from typing import Optional


class CoordinationError(RuntimeError):
    """A cross-process coordination primitive failed or timed out: the
    process group could not be joined.  Carries the primitive's name
    and the timeout, so that a dead coordinator is told apart from a
    logic error without running again."""

    def __init__(self, message: str, *, primitive: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        super().__init__(message)
        self.primitive = primitive
        self.timeout_s = timeout_s
