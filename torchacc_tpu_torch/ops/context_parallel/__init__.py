"""Context parallelism: Ulysses, the ring, and their 2D composition (the
port of torchacc_tpu/ops/context_parallel)."""

from torchacc_tpu_torch.ops.context_parallel.dispatch import (
    CPLayout,
    cp_attention,
)
from torchacc_tpu_torch.ops.context_parallel.merge import merge_attention
from torchacc_tpu_torch.ops.context_parallel.ring import (
    RingTransport,
    VirtualRing,
    ring_attention_bwd,
    ring_attention_fwd,
    ring_bwd,
    ring_fwd,
    ring_step_bwd,
    ring_step_fwd,
    step_should_run,
)
from torchacc_tpu_torch.ops.context_parallel.ulysses import ulysses_attention

__all__ = [
    "CPLayout",
    "cp_attention",
    "merge_attention",
    "RingTransport",
    "VirtualRing",
    "ring_attention_bwd",
    "ring_attention_fwd",
    "ring_bwd",
    "ring_fwd",
    "ring_step_bwd",
    "ring_step_fwd",
    "step_should_run",
    "ulysses_attention",
]
