"""Train state (the port of torchacc_tpu/train/state.py ``TrainState``,
:21): the step, the f32 master parameters by name, the optimizer state,
the fp16 loss scaler (``train/amp.py``), and the delayed-scaling amax
histories of the quantized matmul sites.  The step is a host
integer: the JAX trainer mirrors its device step on the host too
(``_host_step``), and the port never needs it on the device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    # the fp16 dynamic loss scale ({"scale", "growth_count"}, device
    # tensors; train/amp.py scaler_init); None unless compute.dtype is
    # float16
    scaler: Optional[Dict[str, torch.Tensor]] = None
    # amax histories of the quantized matmul sites by site name
    # (models/transformer.py quant_site_names), each
    # [quant_amax_history_len] f32; None when compute.quant == 'none',
    # so the state without quantization is what it was
    quant: Optional[Dict[str, torch.Tensor]] = None
