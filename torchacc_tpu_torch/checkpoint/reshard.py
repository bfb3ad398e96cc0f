"""Offline checkpoint consolidate and reshard (the port of
torchacc_tpu/checkpoint/reshard.py).

A DCP checkpoint stores each leaf as chunks of a global tensor, so both
operations are a restore and a save:

- consolidate: restore host-side whole tensors, save them (one chunk a
  leaf, which any single process reads);
- reshard: restore into a target of DTensors laid out as wanted, save
  it (the chunks follow the target's placements).
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist

from torchacc_tpu_torch.checkpoint.io import (
    _schema_sidecar,
    _write,
    _write_json,
    checkpoint_group,
    restore_checkpoint,
    save_checkpoint,
)
from torchacc_tpu_torch.checkpoint.schema import state_schema
from torchacc_tpu_torch.errors import CheckpointError
from torchacc_tpu_torch.utils.logger import logger


def _all_agree(ok: bool) -> bool:
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=checkpoint_group())
    return bool(flag.item())


def consolidate_checkpoint(src: str, dst: str) -> None:
    """Merge a sharded checkpoint into a consolidated one.

    With more than one rank only rank 0 reads the whole state into host
    memory and writes ``dst`` (every rank holding a copy would multiply
    the host memory, and racing writers would corrupt ``dst``); it
    reads and writes as one process, without collectives.  The other
    ranks wait at a vote that doubles as the verdict, so that none
    returns as if ``dst`` were durable when rank 0 failed."""
    multi = dist.is_initialized() and dist.get_world_size() > 1
    if multi and dist.get_rank() != 0:
        if not _all_agree(True):
            raise CheckpointError(
                f"consolidate {src} -> {dst} failed on rank 0")
        return
    ok = False
    try:
        state = restore_checkpoint(src)
        if multi:
            # this rank alone, without collectives: the host tensors are
            # written as they are
            dst = os.path.abspath(dst)
            _write_json(_schema_sidecar(dst), state_schema(state))
            _write(state, dst, None)
        else:
            save_checkpoint(dst, state)
        n = sum(t.numel() for t in state.values())
        logger.info(f"consolidated {n / 1e6:.1f}M elements: {src} -> {dst}")
        ok = True
    finally:
        if multi:
            try:
                _all_agree(ok)
            except Exception:  # noqa: BLE001
                if ok:
                    raise
                # the work already failed; the vote's own error must not
                # mask the real cause


def reshard_checkpoint(src: str, dst: str, target: Any) -> None:
    """Re-save ``src`` laid out as ``target`` (a mapping of tensors or a
    ``TrainState``, typically DTensors of the wanted placements): the
    restore reads into the target's layout, the save writes its chunks.
    Every rank of the target's mesh calls this."""
    restore_checkpoint(src, target)
    save_checkpoint(dst, target)
    logger.info(f"resharded {src} -> {dst}")
