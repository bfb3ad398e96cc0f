"""Checkpoints of the port (the port of torchacc_tpu/checkpoint/): a
sharded save and restore on ``torch.distributed.checkpoint`` with the
JAX package's directory layout and commit protocol (``io``), the schema
manifests and topology verdicts (``schema``), the offline consolidate
and reshard (``reshard``) and the operator CLI (``cli``).  The tiered
checkpoints wait for ROADMAP A13."""

from torchacc_tpu_torch.checkpoint.io import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from torchacc_tpu_torch.checkpoint.reshard import (
    consolidate_checkpoint,
    reshard_checkpoint,
)
from torchacc_tpu_torch.checkpoint.schema import (
    check_compatibility,
    schema_diff,
    state_schema,
    tree_digest,
)

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "consolidate_checkpoint",
    "reshard_checkpoint",
    "state_schema",
    "schema_diff",
    "check_compatibility",
    "tree_digest",
]
