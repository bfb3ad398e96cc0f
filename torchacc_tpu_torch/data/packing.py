"""Sequence packing: documents -> fixed-length rows + segment ids (the
port of torchacc_tpu/data/packing.py).

The native C++ core (``_native/pack.cc``, the port's own copy) does
first-fit-decreasing bin packing; it is compiled by ``g++`` at first use
into the git-ignored ``torchacc_tpu_torch/_build/`` (``ops/_build.py``
``load_host``) and bound with ctypes.  Where it cannot be built, the
NumPy plan runs instead, as in the JAX package, with a warning; the
packer that ran last is :data:`last_packer` ('native' | 'numpy'), so a
caller can assert which one it got.  Both give the same rows.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from torchacc_tpu_torch.ops import _build
from torchacc_tpu_torch.utils.logger import logger

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "pack.cc")
_LIB = None
_LIB_TRIED = False

#: the packer the last pack_sequences call ran: 'native' | 'numpy'
#: (None before the first call)
last_packer = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _load_native():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = _build.load_host(_SRC)
        lib.pack_plan.restype = ctypes.c_int64
        lib.pack_plan.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64,
                                  _I64P, _I64P]
        lib.pack_fill.restype = ctypes.c_int64
        lib.pack_fill.argtypes = [_I32P, _I64P, ctypes.c_int64,
                                  ctypes.c_int64, _I64P, _I64P, _I32P,
                                  _I32P, _I32P]
        _LIB = lib
    except Exception as e:
        logger.warning(f"native packer unavailable ({e}); using the NumPy "
                       "plan")
        _LIB = None
    return _LIB


def _plan_numpy(lengths: np.ndarray, seq_len: int
                ) -> Tuple[int, np.ndarray, np.ndarray]:
    order = np.argsort(-lengths, kind="stable")
    space: List[int] = []
    row_of = np.zeros(len(lengths), np.int64)
    off_of = np.zeros(len(lengths), np.int64)
    for idx in order:
        ln = int(min(lengths[idx], seq_len))
        row = next((r for r, s in enumerate(space) if s >= ln), -1)
        if row < 0:
            row = len(space)
            space.append(seq_len)
        row_of[idx] = row
        off_of[idx] = seq_len - space[row]
        space[row] -= ln
    return len(space), row_of, off_of


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def pack_sequences(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Pack token documents into rows.

    Returns {"input_ids", "segment_ids", "positions"}, each int32
    [rows, seq_len].  Padding carries segment id -1 (matches nothing in
    the attention mask) and position 0; a document longer than
    ``seq_len`` is cut."""
    global last_packer
    docs = [np.asarray(d, np.int32).reshape(-1) for d in docs]
    lengths = np.asarray([len(d) for d in docs], np.int64)
    n = len(docs)
    if n == 0:
        raise ValueError("no documents to pack")
    lib = _load_native()
    row_of = np.zeros(n, np.int64)
    off_of = np.zeros(n, np.int64)
    if lib is not None:
        rows = lib.pack_plan(_ptr(lengths, _I64P), n, seq_len,
                             _ptr(row_of, _I64P), _ptr(off_of, _I64P))
        if rows < 0:
            raise ValueError("pack_plan failed")
    else:
        rows, row_of, off_of = _plan_numpy(lengths, seq_len)

    out_tokens = np.full((rows, seq_len), pad_id, np.int32)
    out_segments = np.full((rows, seq_len), -1, np.int32)
    out_positions = np.zeros((rows, seq_len), np.int32)

    if lib is not None:
        flat = np.concatenate(docs).astype(np.int32)
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(lengths, out=starts[1:])
        rc = lib.pack_fill(_ptr(flat, _I32P), _ptr(starts, _I64P), n,
                           seq_len, _ptr(row_of, _I64P), _ptr(off_of, _I64P),
                           _ptr(out_tokens, _I32P), _ptr(out_segments, _I32P),
                           _ptr(out_positions, _I32P))
        if rc != 0:
            raise ValueError("pack_fill failed")
    else:
        for d, doc in enumerate(docs):
            ln = min(len(doc), seq_len)
            r, o = int(row_of[d]), int(off_of[d])
            out_tokens[r, o:o + ln] = doc[:ln]
            out_segments[r, o:o + ln] = d
            out_positions[r, o:o + ln] = np.arange(ln)
    last_packer = "native" if lib is not None else "numpy"
    return {"input_ids": out_tokens, "segment_ids": out_segments,
            "positions": out_positions}
