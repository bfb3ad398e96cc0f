"""Joining the process group (the port of torchacc_tpu/parallel/
distributed.py: ``initialize_distributed`` :27, ``is_primary`` :117).

Where the JAX package calls ``jax.distributed.initialize`` once per
host, the port starts one process per card and joins them with
``torch.distributed.init_process_group``: NCCL for CUDA (the default),
gloo for the CPU.  The rank, world size and rendezvous come from
torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
``MASTER_PORT``, or from the JAX package's ``COORDINATOR_ADDRESS``/
``NUM_PROCESSES``/``PROCESS_ID`` where torchrun's are absent; explicit
arguments win over both.  Nothing here reads a cluster scheduler.
"""

from __future__ import annotations

import os
import random
import time
from typing import Optional, Union

import torch
import torch.distributed as dist

from torchacc_tpu_torch.errors import CoordinationError
from torchacc_tpu_torch.ops._common import resolve_device
from torchacc_tpu_torch.utils.logger import logger


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def _init_method(coordinator_address: Optional[str]) -> str:
    """A URL for ``init_process_group``: ``coordinator_address`` as
    given when it is one (``tcp://...``, ``file://...``), else
    ``tcp://host:port`` from it or from torchrun's variables."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        raise ValueError(
            "no coordinator: pass coordinator_address, or set MASTER_ADDR/"
            "MASTER_PORT (torchrun) or COORDINATOR_ADDRESS")
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
    init_retries: int = 3,
    retry_base_delay_s: float = 1.0,
    retry_max_delay_s: float = 15.0,
) -> None:
    """Join the default process group: NCCL when ``device`` is CUDA
    (None means the card, whose index is ``LOCAL_RANK``), gloo when it
    is the CPU.  ``coordinator_address`` is ``host:port`` or an
    ``init_process_group`` URL; ``num_processes``/``process_id`` are
    the world size and this rank.

    The join is retried ``init_retries`` times with the JAX package's
    jittered exponential backoff (``retry_base_delay_s`` doubling up to
    ``retry_max_delay_s``, times a uniform jitter in [0.5, 1.5]): at
    bring-up the coordinator often comes up
    after the workers.  When every attempt fails it raises a
    :class:`CoordinationError` naming the coordinator.  A process group
    that is already up is success, as in the JAX package."""
    if dist.is_initialized():
        logger.warning("torch.distributed already initialised; reusing the "
                       "existing process group")
        return
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(
            "no world size or rank: pass num_processes and process_id, or "
            "set WORLD_SIZE/RANK (torchrun) or NUM_PROCESSES/PROCESS_ID")
    local_rank = _env_int("LOCAL_RANK") or 0
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", local_rank)
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = _init_method(coordinator_address)
    attempts = max(init_retries, 0) + 1
    for attempt in range(attempts):
        try:
            dist.init_process_group(backend, init_method=url,
                                    world_size=num_processes,
                                    rank=process_id)
            break
        except (RuntimeError, ValueError) as e:
            if attempt + 1 == attempts:
                raise CoordinationError(
                    f"could not join the {backend} process group at "
                    f"coordinator {url} (process {process_id}/"
                    f"{num_processes}) after {attempts} attempt(s): {e!r}. "
                    f"Check that the coordinator is up, its address is "
                    f"reachable from this host, and every process was "
                    f"started with the same world size.",
                    primitive="initialize") from e
            delay = min(retry_max_delay_s, retry_base_delay_s * 2 ** attempt)
            logger.warning(f"init_process_group failed ({e!r}); retry "
                           f"{attempt + 1}/{attempts - 1} in {delay:.1f} s")
            time.sleep(delay * random.uniform(0.5, 1.5))
    logger.info(f"distributed initialised: rank {dist.get_rank()}/"
                f"{dist.get_world_size()} over {backend}")


def is_primary() -> bool:
    """True on the process that writes logs and metadata: rank 0, or
    the only process when no group is up."""
    return not dist.is_initialized() or dist.get_rank() == 0
