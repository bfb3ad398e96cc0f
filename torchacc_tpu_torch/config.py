"""Configuration (torchacc_tpu/config.py): ``ServeConfig`` for the
serving engine, ``ComputeConfig`` and ``MemoryConfig`` for training,
and a ``Config`` that holds them.

Only the fields the port implements are here.  The journal, deadline
shedding, preemption and graceful drain of serving, and the dist, data,
perf, resilience and obs blocks of training, are not ported yet
(ROADMAP.md, queue A), so their switches are absent rather than
silently ignored.  A field that is here but takes a value the port does
not implement (fp16 with its loss scaler, the quantized vocab head,
host offload, gradient accumulation) raises by name in ``validate``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch


class ConfigError(ValueError):
    """An invalid configuration value."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ConfigError(msg)


def _unported(cond: bool, msg: str) -> None:
    if not cond:
        raise NotImplementedError(msg + " is not ported to "
                                  "torchacc_tpu_torch yet (ROADMAP.md)")


@dataclass
class ServeConfig:
    """Serving engine policy.  See torchacc_tpu/config.py for the long
    form of every field; the semantics are the same."""

    # tokens per KV block
    block_size: int = 16
    # blocks in the pool; block 0 is the reserved null block
    num_blocks: int = 512
    # max sequences decoding in one batched step
    max_slots: int = 8
    # chunked prefill: tokens of one sequence prefilled per iteration
    prefill_chunk: int = 64
    # distinct sequences whose chunks prefill together per iteration
    prefill_batch: int = 1
    # shared-prefix KV reuse over the paged pool
    prefix_cache: bool = False
    # 'fcfs' | 'sjf' | 'priority'
    policy: str = "fcfs"
    # 'priority' policy aging: +1 class per priority_aging_s waited
    priority_aging_s: float = 30.0
    # iterations kept in flight before the host reads tokens back
    decode_depth: int = 2
    # default per-request new-token cap
    max_new_tokens: int = 128
    # bound on the admission queue; submit() raises when full
    max_queue: int = 4096

    def validate(self) -> None:
        _check(self.block_size >= 1, "serve.block_size must be >= 1")
        _check(self.num_blocks >= 2,
               "serve.num_blocks must be >= 2 (block 0 is the reserved "
               "null block)")
        _check(self.max_slots >= 1, "serve.max_slots must be >= 1")
        _check(self.prefill_chunk >= 1, "serve.prefill_chunk must be >= 1")
        _check(self.prefill_batch >= 1, "serve.prefill_batch must be >= 1")
        _check(self.policy in ("fcfs", "sjf", "priority"),
               f"serve.policy must be fcfs|sjf|priority, got {self.policy}")
        _check(self.priority_aging_s >= 0,
               "serve.priority_aging_s must be >= 0")
        _check(self.decode_depth >= 1, "serve.decode_depth must be >= 1")
        _check(self.max_new_tokens >= 1, "serve.max_new_tokens must be >= 1")
        _check(self.max_queue >= 1, "serve.max_queue must be >= 1")


@dataclass
class ComputeConfig:
    """Numerics and kernel selection (``ComputeConfig``), with torch
    dtypes in place of the JAX package's dtype names."""

    # activation/compute dtype
    dtype: torch.dtype = torch.bfloat16
    # master parameter dtype
    param_dtype: torch.dtype = torch.float32
    # 'auto' (the CUDA kernels for CUDA tensors, the plain version for
    # CPU tensors) | 'cuda' | 'torch'; the JAX package's auto|pallas|xla
    attention_impl: str = "auto"
    # fused (chunked) linear + cross-entropy loss
    fused_kernels: bool = True
    # 'default' | 'high' | 'highest': torch.set_float32_matmul_precision
    # ('default' leaves the process setting as it is)
    matmul_precision: str = "default"
    # Megatron-style main params: the forward and backward read a bf16
    # copy of the f32 masters (train/amp.py bf16_param_shadow)
    bf16_compute_params: bool = False
    # quantized forward matmuls (ops/quantized_matmul.py): 'int8' | 'fp8'
    # run the selected dense sites' forward product in the low-precision
    # format, with delayed per-tensor activation scaling (amax histories
    # in TrainState.quant) and just-in-time per-channel weight scales;
    # the backward stays in the compute dtype (straight-through).
    # 'none' is the unquantized step: no quant state exists
    quant: str = "none"
    # which dense sites quantize: 'attn' = q/k/v/o projections, 'mlp' =
    # gate/up/down; 'head' (the vocab projection) is not ported
    quant_sites: Tuple[str, ...] = ("attn", "mlp")
    # rolling amax window per site
    quant_amax_history_len: int = 16
    # 'auto' (the CUDA kernel for CUDA tensors, the plain version for
    # CPU tensors) | 'cuda' | 'torch'; the JAX package's auto|pallas|xla
    quant_impl: str = "auto"

    _QUANT_SITES = ("attn", "mlp", "head")

    def validate(self) -> None:
        _check(self.dtype in (torch.bfloat16, torch.float16, torch.float32),
               f"compute.dtype must be bfloat16|float16|float32, got "
               f"{self.dtype}")
        _unported(self.dtype != torch.float16,
                  "compute.dtype=float16 (the dynamic loss scaler)")
        _check(self.param_dtype in (torch.bfloat16, torch.float32),
               f"compute.param_dtype must be bfloat16|float32, got "
               f"{self.param_dtype}")
        _check(not self.bf16_compute_params
               or (self.dtype == torch.bfloat16
                   and self.param_dtype == torch.float32),
               "compute.bf16_compute_params requires dtype=bfloat16 with "
               "param_dtype=float32")
        _check(self.attention_impl in ("auto", "cuda", "torch"),
               f"compute.attention_impl must be auto|cuda|torch, got "
               f"{self.attention_impl!r}")
        _check(self.matmul_precision in ("default", "high", "highest"),
               f"compute.matmul_precision invalid: {self.matmul_precision}")
        _check(self.quant in ("none", "int8", "fp8"),
               f"compute.quant must be none|int8|fp8, got {self.quant}")
        _check(self.quant_impl in ("auto", "cuda", "torch"),
               f"compute.quant_impl must be auto|cuda|torch, got "
               f"{self.quant_impl!r}")
        _check(self.quant_amax_history_len >= 1,
               "compute.quant_amax_history_len must be >= 1")
        if self.quant != "none":
            _check(len(self.quant_sites) >= 1,
                   "compute.quant_sites must name at least one site")
            for s in self.quant_sites:
                _check(s in self._QUANT_SITES,
                       f"compute.quant_sites entries must be in "
                       f"{self._QUANT_SITES}, got {s!r}")
            _unported("head" not in self.quant_sites,
                      "compute.quant_sites containing 'head' (the "
                      "quantized vocab projection)")


@dataclass
class MemoryConfig:
    """Rematerialisation policy (``MemoryConfig``): ``gc`` wraps each
    decoder block in ``torch.utils.checkpoint`` with the selective save
    policy ``gc_policy`` (utils/remat.py)."""

    gc: bool = False
    # 'nothing' | 'save_attn' | 'save_attn_mlp' are ported; the JAX
    # package's 'dots', 'dots_with_no_batch_dims' and 'offload_dots'
    # raise by name
    gc_policy: str = "nothing"

    _GC_POLICIES = ("nothing", "dots", "dots_with_no_batch_dims",
                    "save_attn", "save_attn_mlp", "offload_dots")
    _PORTED = ("nothing", "save_attn", "save_attn_mlp")

    def validate(self) -> None:
        _check(self.gc_policy in self._GC_POLICIES,
               f"memory.gc_policy invalid: {self.gc_policy}")
        _unported(self.gc_policy in self._PORTED,
                  f"memory.gc_policy={self.gc_policy!r}")


@dataclass
class Config:
    """The framework config.  Serving reads ``serve``; training reads
    ``compute``, ``memory``, ``grad_accum`` and ``seed``."""

    serve: ServeConfig = field(default_factory=ServeConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    # micro-batches per optimizer step; only 1 is ported (gradient
    # accumulation, which also threads the quant histories micro by
    # micro, is still to port: ROADMAP.md)
    grad_accum: int = 1
    # seed of the random weights Trainer.init() makes
    seed: int = 0

    def validate(self) -> None:
        self.serve.validate()
        self.compute.validate()
        self.memory.validate()
        _check(self.grad_accum >= 1, "grad_accum must be >= 1")
        _unported(self.grad_accum == 1,
                  f"grad_accum={self.grad_accum} (gradient accumulation)")
