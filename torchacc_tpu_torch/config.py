"""Configuration (torchacc_tpu/config.py): ``ServeConfig`` for the
serving engine, ``ComputeConfig``, ``MemoryConfig`` and ``DataConfig``
for training, and a ``Config`` that holds them.

Only the fields the port implements are here.  The journal, deadline
shedding, preemption and graceful drain of serving, and the dist, perf,
resilience and obs blocks of training, are not ported yet (ROADMAP.md,
queue A), so their switches are absent rather than silently ignored.
A field that is here but takes a value the port does not implement (the
quantized vocab head; quantized matmuls under float16) raises by name
in ``validate``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

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
    # gradient-accumulation buffer dtype (grad_accum > 1): bfloat16 halves
    # the accumulator memory at some summation precision cost
    accum_dtype: torch.dtype = torch.float32
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
        _check(self.param_dtype in (torch.bfloat16, torch.float32),
               f"compute.param_dtype must be bfloat16|float32, got "
               f"{self.param_dtype}")
        _check(self.accum_dtype in (torch.bfloat16, torch.float32),
               f"compute.accum_dtype must be bfloat16|float32, got "
               f"{self.accum_dtype}")
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
            _unported(self.dtype != torch.float16,
                      "compute.quant with dtype=float16 (B4 and B5 in "
                      "float16, ROADMAP B-3)")


@dataclass
class MemoryConfig:
    """Rematerialisation and offload policy (``MemoryConfig``): ``gc``
    makes each decoder block (or, with ``gc_cls``, its attention or MLP)
    a checkpoint region with the save policy ``gc_policy``
    (utils/remat.py)."""

    gc: bool = False
    # layer class names to remat (None = the whole decoder Block):
    # 'Block', 'Attention', 'Mlp', 'MoEMlp'
    gc_cls: Optional[List[str]] = None
    # remat only the first N layers (None = all)
    gc_cnt: Optional[int] = None
    # 'nothing' | 'dots' | 'dots_with_no_batch_dims' | 'save_attn' |
    # 'save_attn_mlp' | 'offload_dots' (utils/remat.py remat_policy)
    gc_policy: str = "nothing"
    # force the host-offload remat policy (overrides gc_policy, implies gc)
    offload_activations: bool = False

    _GC_CLS = ("Block", "Attention", "Mlp", "MoEMlp")
    _GC_POLICIES = ("nothing", "dots", "dots_with_no_batch_dims",
                    "save_attn", "save_attn_mlp", "offload_dots")

    def validate(self) -> None:
        _check(self.gc_policy in self._GC_POLICIES,
               f"memory.gc_policy invalid: {self.gc_policy}")
        if self.gc_cnt is not None:
            _check(self.gc_cnt >= 0, "memory.gc_cnt must be >= 0")
        if self.gc_cls:
            for name in self.gc_cls:
                _check(name in self._GC_CLS,
                       f"memory.gc_cls entries must be in {self._GC_CLS}, "
                       f"got {name!r}")


@dataclass
class DataConfig:
    """Input pipeline (``DataConfig``): bucketing and the async
    host -> device feed of ``data.AsyncLoader``."""

    buckets: Optional[List[int]] = None  # explicit bucket lengths (sorted)
    max_length: Optional[int] = None     # with num_buckets -> uniform buckets
    num_buckets: int = 1
    pad_value_dict: Optional[Dict[str, Any]] = None  # per-feature pad value
    prefetch: int = 2                    # batches uploaded ahead of the step

    def validate(self) -> None:
        if self.buckets is not None:
            _check(len(self.buckets) > 0, "data.buckets must be non-empty")
            _check(list(self.buckets) == sorted(self.buckets),
                   "data.buckets must be sorted ascending")
        if self.max_length is not None:
            _check(self.max_length > 0, "data.max_length must be positive")
            _check(self.num_buckets >= 1, "data.num_buckets must be >= 1")
        _check(self.prefetch >= 1, "data.prefetch must be >= 1")

    def bucket_sizes(self) -> Optional[List[int]]:
        """The bucket lengths: ``buckets``, or ``num_buckets`` uniform
        ones up to ``max_length``, or None (no padding)."""
        if self.buckets is not None:
            return list(self.buckets)
        if self.max_length is None:
            return None
        step = self.max_length / self.num_buckets
        return [int(math.ceil(step * (i + 1)))
                for i in range(self.num_buckets)]


@dataclass
class Config:
    """The framework config.  Serving reads ``serve``; training reads
    ``compute``, ``memory``, ``data``, ``grad_accum`` and ``seed``."""

    serve: ServeConfig = field(default_factory=ServeConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    data: DataConfig = field(default_factory=DataConfig)
    # micro-batches per optimizer step (the global batch splits along
    # dim 0; the quant histories chain micro by micro)
    grad_accum: int = 1
    # seed of the random weights Trainer.init() makes
    seed: int = 0

    def validate(self) -> None:
        self.serve.validate()
        self.compute.validate()
        self.memory.validate()
        self.data.validate()
        _check(self.grad_accum >= 1, "grad_accum must be >= 1")
