"""Training (the port of torchacc_tpu/train, core only)."""

from torchacc_tpu_torch.train.accelerate import accelerate
from torchacc_tpu_torch.train.hf_trainer import HFTrainerAdapter
from torchacc_tpu_torch.train.schedules import (
    adamw,
    warmup_cosine,
    warmup_linear,
)
from torchacc_tpu_torch.train.state import TrainState
from torchacc_tpu_torch.train.trainer import Trainer, shift_labels

__all__ = ["accelerate", "Trainer", "TrainState", "adamw", "warmup_cosine",
           "warmup_linear", "shift_labels", "HFTrainerAdapter"]
