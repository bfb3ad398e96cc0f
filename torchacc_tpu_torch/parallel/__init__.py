"""Parallelism (the port of torchacc_tpu/parallel): joining the process
group, the device mesh, and the sharding rules and plan that compose
data parallelism, FSDP, tensor parallelism and context parallelism
('sp' x 'spu', ``ops/context_parallel``) on the training path.
Pipeline parallelism, the serving layouts and ``transfer`` are not
ported yet (ROADMAP.md A12b, A2b)."""

from torchacc_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_primary,
)
from torchacc_tpu_torch.parallel.mesh import (
    build_mesh,
    data_shard,
    describe_mesh,
    mesh_axis_size,
    seq_shard,
)
from torchacc_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    batch_spec,
    make_rules,
    shard_model,
    spec_for,
)

__all__ = [
    "initialize_distributed",
    "is_primary",
    "build_mesh",
    "describe_mesh",
    "mesh_axis_size",
    "data_shard",
    "seq_shard",
    "DEFAULT_RULES",
    "batch_spec",
    "make_rules",
    "spec_for",
    "shard_model",
]
