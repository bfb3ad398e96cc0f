"""Train state (the port of torchacc_tpu/train/state.py ``TrainState``,
:21): the step, the f32 master parameters by name, the optimizer state,
the fp16 loss scaler (``train/amp.py``), and the delayed-scaling amax
histories of the quantized matmul sites.  The step is a host
integer: the JAX trainer mirrors its device step on the host too
(``_host_step``), and the port never needs it on the device.

``flat_state`` is the named view a checkpoint holds
(``checkpoint/io.py``): one tensor per leaf, the state's own tensors
(DTensors where the state is sharded), with the step and the AdamW count
as 0-dim int64 host tensors.  The bf16 shadow of ``amp.bf16_param_shadow``
is not a leaf: it is the bf16 cast of the masters, and the trainer makes
it again after a restore.  ``set_scalars`` writes a loaded step and
count back into the state."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch

from torchacc_tpu_torch.train.schedules import AdamWState


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
    # the pipeline stages over 'pp' and the model's blocks: above one
    # stage, ``params`` (and the moments) hold this rank's blocks only
    pp_size: int = 1
    num_layers: int = 0


class FlatState(dict):
    """``flat_state``'s mapping.  Under pipeline parallelism it also
    names the 'pp' size and ``other_leaves``: ``{name: (shape, dtype)}``
    of the leaves the other stages hold (their blocks' masters and
    moments), so that a checkpoint's schema is the whole model's on
    every rank (``checkpoint/schema.py``)."""
    pp_size = 1
    other_leaves: Dict[str, Any] = {}


def adam_state(opt_state: Any) -> AdamWState:
    """The ``AdamWState`` of an optimizer state: itself, or the inner
    state of ``amp.bf16_param_shadow``'s ``(inner, shadow)``."""
    if isinstance(opt_state, tuple):
        opt_state = opt_state[0]
    if not isinstance(opt_state, AdamWState):
        raise TypeError(
            f"checkpoints hold the port's AdamW state; got an optimizer "
            f"state of type {type(opt_state).__name__}")
    return opt_state


def flat_state(state: TrainState) -> Dict[str, torch.Tensor]:
    """``{leaf name: tensor}`` of ``state``: ``step``, ``params/<name>``,
    ``opt_state/{count,mu/<name>,nu/<name>}``, ``scaler/<key>`` and
    ``quant/<site>``.  Tensors are the state's own (detached views, so a
    load into them writes the state); the step and the count are new
    host tensors, and reading the count waits for a pending fp16 skip
    flag (``schedules.AdamWState.count``), so a skipped update is never
    saved as applied."""
    opt = adam_state(state.opt_state)
    out = FlatState(step=torch.tensor(int(state.step), dtype=torch.int64))
    out.update({f"params/{n}": p.detach() for n, p in state.params.items()})
    out["opt_state/count"] = torch.tensor(opt.count, dtype=torch.int64)
    out.update({f"opt_state/mu/{n}": t for n, t in opt.mu.items()})
    out.update({f"opt_state/nu/{n}": t for n, t in opt.nu.items()})
    for part in ("scaler", "quant"):
        tensors = getattr(state, part)
        if tensors is not None:
            out.update({f"{part}/{k}": t for k, t in tensors.items()})
    if state.pp_size > 1:
        out.pp_size = state.pp_size
        out.other_leaves = _other_stages(out, state.num_layers)
    return out


_BLOCK_LEAF = re.compile(r"^(params|opt_state/mu|opt_state/nu)/layers\.(\d+)\.(.*)$")


def _other_stages(flat: Mapping[str, torch.Tensor], num_layers: int):
    """The leaves of the blocks this stage does not hold, by the shapes
    and dtypes of one it holds (every block is alike)."""
    mine: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, t in flat.items():
        m = _BLOCK_LEAF.match(name)
        if m:
            mine.setdefault(int(m.group(2)), {})[
                f"{m.group(1)}|{m.group(3)}"] = t
    if not mine:
        return {}
    like = mine[min(mine)]
    return {f"{key.split('|')[0]}/layers.{i}.{key.split('|')[1]}":
            (tuple(t.shape), t.dtype)
            for i in range(num_layers) if i not in mine
            for key, t in like.items()}


def set_scalars(state: TrainState, flat: Mapping[str, torch.Tensor]) -> None:
    """Write the step and the AdamW count of ``flat`` into ``state``."""
    state.step = int(flat["step"])
    adam_state(state.opt_state).count = int(flat["opt_state/count"])
