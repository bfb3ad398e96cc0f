"""Shared op-layer helpers: constants and device resolution."""

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
