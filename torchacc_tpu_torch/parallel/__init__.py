"""Parallelism (the port of torchacc_tpu/parallel): joining the process
group, the device mesh, and the sharding rules and plan that compose
data parallelism, FSDP, tensor parallelism, context parallelism
('sp' x 'spu', ``ops/context_parallel``) and pipeline parallelism
('pp', ``parallel/pp.py``) on the training path.  The serving layouts
and ``transfer`` are not ported yet (ROADMAP.md A2b)."""

from torchacc_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_primary,
)
from torchacc_tpu_torch.parallel.mesh import (
    build_mesh,
    data_shard,
    describe_mesh,
    mesh_axis_size,
    pp_ranks,
    pp_stage,
    seq_shard,
)
from torchacc_tpu_torch.parallel.pp import (
    Pipeline,
    ProcessGroupTransport,
    gpipe_ticks,
    one_f_one_b_ticks,
    stage_layers,
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
    "pp_stage",
    "pp_ranks",
    "Pipeline",
    "ProcessGroupTransport",
    "gpipe_ticks",
    "one_f_one_b_ticks",
    "stage_layers",
    "DEFAULT_RULES",
    "batch_spec",
    "make_rules",
    "spec_for",
    "shard_model",
]
