"""Train state (the port of torchacc_tpu/train/state.py ``TrainState``,
:21): the step, the f32 master parameters by name, and the optimizer
state.  The fp16 scaler and the quantized-matmul histories of the JAX
state are not ported (ROADMAP A11).  The step is a host integer: the
JAX trainer mirrors its device step on the host too (``_host_step``),
and the port never needs it on the device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
