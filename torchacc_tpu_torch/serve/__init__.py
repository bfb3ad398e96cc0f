"""Serving: paged KV cache, continuous-batching scheduler, front-end."""

from torchacc_tpu_torch.serve.engine import Request, RequestResult, ServeEngine
from torchacc_tpu_torch.serve.kv_cache import (
    BlockPool,
    PrefixIndex,
    blocks_needed,
    make_pools,
)
from torchacc_tpu_torch.serve.scheduler import PagedDecoder, Scheduler

__all__ = ["Request", "RequestResult", "ServeEngine", "BlockPool",
           "PrefixIndex", "blocks_needed", "make_pools", "PagedDecoder",
           "Scheduler"]
