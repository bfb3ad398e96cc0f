"""Shared op-layer helpers: constants, device resolution and the
counter-based dropout hash."""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x``."""
    return ((x + m - 1) // m) * m


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for something else.  ``None`` means ``cuda``; asking for CUDA
    where there is none raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: torchacc_tpu_torch runs on the "
            "GPU by default; pass device='cpu' explicitly to run on the "
            "CPU (tests, small shapes)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# Counter-based dropout hash (attention dropout): the port's own copy of
# torchacc_tpu/ops/_common.py ``mix32`` (:43) and ``dropout_keep`` (:59).
# A stateless murmur3-finalizer hash of the absolute coordinates (seed,
# batch, q head, global q position, global k position) -> uint32,
# thresholded at dropout_p * 2^32: the mask is the same in the forward
# and both backward kernels, in the kernels and the plain version, and
# bit for bit the JAX package's.  torch has no wrapping uint32 multiply
# on every backend, so the arithmetic runs in int64 and is masked back
# to 32 bits after every step that can carry.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_B_PRIME = 0x85EBCA6B
_K_PRIME = 0x9E3779B9  # golden-ratio odd constant


def _u32(x, device=None) -> torch.Tensor:
    """``x`` (int or integer tensor) as uint32 values held in int64."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def mix32(x) -> torch.Tensor:
    """murmur3 finalizer: uint32 -> well-mixed uint32 (in int64)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x


def dropout_threshold(dropout_p: float) -> int:
    """The uint32 threshold of ``dropout_p``: a pair is kept when its
    hash is at least this."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


def dropout_keep(seed, b_idx, h_idx, q_pos: torch.Tensor,
                 k_pos: torch.Tensor, dropout_p: float) -> torch.Tensor:
    """Boolean keep mask: True = keep.  ``q_pos`` [.., bq] and ``k_pos``
    [.., bk] are GLOBAL integer positions; broadcasting forms
    [.., bq, bk].  ``seed``, ``b_idx`` and ``h_idx`` are ints or integer
    tensors that broadcast against ``q_pos`` (``[b, 1, 1]`` and
    ``[1, h, 1]`` give a ``[b, h, bq, bk]`` mask).
    P(keep) = 1 - dropout_p (2^-32 granularity)."""
    dev = q_pos.device
    base = mix32((_u32(seed, dev) + _u32(b_idx, dev) * _B_PRIME
                  + _u32(h_idx, dev)) & _M32)
    row = mix32(base ^ _u32(q_pos))
    col = mix32((_u32(k_pos) * _K_PRIME) & _M32)
    bits = mix32(row[..., :, None] ^ col[..., None, :])
    return bits >= dropout_threshold(dropout_p)
