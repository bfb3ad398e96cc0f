"""Configuration (torchacc_tpu/config.py): ``ServeConfig`` for the
serving engine, ``ComputeConfig``, ``MemoryConfig`` and ``DataConfig``
for training, ``DistConfig`` for the parallel composition and its mesh,
and a ``Config`` that holds them.

Only the fields the port implements are here.  The journal, deadline
shedding, preemption and graceful drain of serving, the perf and obs
blocks of training, and every resilience field but the checkpoint
path's (``ResilienceConfig``) are not ported yet (ROADMAP.md, queue A),
so their switches are absent rather than silently ignored.
A field that is here but takes a value the port does not implement
raises by name in ``validate``; ``perf.overlap_fsdp`` is folded into the model config and
refused with the model's other unported fields.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

# the mesh axes, in the JAX package's order: 'sp' is the outer (ring)
# sequence axis, 'spu' the inner (Ulysses) one
MESH_AXES: Tuple[str, ...] = ("dp", "pp", "fsdp", "sp", "spu", "ep", "tp")
# the axes along which the batch is split
DATA_AXES: Tuple[str, ...] = ("dp", "fsdp")


class ConfigError(ValueError):
    """An invalid configuration value."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ConfigError(msg)


def _unported(cond: bool, msg: str, item: str = "") -> None:
    if not cond:
        where = f"ROADMAP.md {item}" if item else "ROADMAP.md"
        raise NotImplementedError(msg + " is not ported to "
                                  f"torchacc_tpu_torch yet ({where})")


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
    # the durable request journal (serve/journal.py): every accepted
    # request and every completed or shed result appends one strict-JSON
    # line to <journal_dir>/journal.jsonl, and ServeEngine.recover()
    # re-admits the journaled requests that did not finish.  None: no
    # journal
    journal_dir: Optional[str] = None
    # fsync every journal append (False: flushed only)
    journal_fsync: bool = True
    # rotate and compact the active journal file past these bounds
    # (None or 0: never)
    journal_rotate_bytes: Optional[int] = None
    journal_rotate_age_s: Optional[float] = None
    # a queued request whose deadline has passed gets a typed 'shed'
    # result (counted, journaled) instead of being served late
    shed_deadlines: bool = False
    # an admitted request whose deadline has passed is evicted with a
    # typed 'preempted' result carrying its partial tokens
    preempt_deadlines: bool = False

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
    # gate/up/down; 'head' = the materialised vocab projection (with
    # compute.fused_kernels=False, or a head_bias model: the fused CE
    # head stays in the compute dtype and the Trainer refuses it)
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
class DPConfig:
    """Data parallelism: replicated parameters, the batch split.
    ``size=-1`` (default) infers dp as world/(pp*fsdp*sp*ep*tp)."""
    size: int = -1

    def validate(self) -> None:
        _check(self.size >= -1 and self.size != 0,
               "dp.size must be -1 or >= 1")


@dataclass
class TPConfig:
    """Tensor parallelism: Megatron heads and MLP, the vocab-parallel
    embedding and head."""
    size: int = 1

    def validate(self) -> None:
        _check(self.size >= 1, "tp.size must be >= 1")


@dataclass
class FSDPConfig:
    """ZeRO-3 over the 'fsdp' axis: parameters, gradients and AdamW
    state sharded.  ``shard_axis_rules`` is read as in the JAX package.
    FSDP2 shards every parameter on its dim 0, small ones included
    (ROADMAP.md C2), so ``min_weight_size`` keeps only its default,
    under which the JAX package keeps small parameters replicated;
    another value raises."""
    size: int = 1
    min_weight_size: int = 2 ** 12
    shard_axis_rules: Optional[List[Tuple[str, Any]]] = None

    def validate(self) -> None:
        _check(self.size >= 1, "fsdp.size must be >= 1")
        _unported(self.min_weight_size == 2 ** 12,
                  "fsdp.min_weight_size other than 2 ** 12 (small "
                  "parameters kept replicated)", "A8b")


@dataclass
class PPConfig:
    """Pipeline parallelism over the 'pp' axis (``parallel/pp.py``):
    the blocks split into ``size`` stages (``virtual_stages`` chunks a
    stage, the interleaved schedule), ``num_micro_batches`` micro-batches
    a step passed between the stages' ranks, under ``schedule`` 'gpipe'
    (every forward, then every backward) or '1f1b' (PipeDreamFlush: each
    micro-batch's backward as soon as its forward ends, the stage re-run
    from its banked input).  Fields, defaults and validation as in the
    JAX package (torchacc_tpu/config.py:261-304)."""
    size: int = 1
    num_micro_batches: int = 1
    # 'gpipe' | '1f1b'
    schedule: str = "gpipe"
    # interleaved (Megatron virtual-pipeline) chunks a stage
    virtual_stages: int = 1

    def validate(self) -> None:
        _check(self.size >= 1, "pp.size must be >= 1")
        _check(self.num_micro_batches >= 1, "pp.num_micro_batches must be >= 1")
        _check(self.schedule in ("gpipe", "1f1b"),
               f"pp.schedule must be gpipe|1f1b, got {self.schedule}")
        _check(self.virtual_stages >= 1, "pp.virtual_stages must be >= 1")
        if self.size > 1:
            _check(self.num_micro_batches % self.size == 0,
                   "pp.num_micro_batches must be a multiple of pp.size")


@dataclass
class SPConfig:
    """Sequence (context) parallelism (``ops/context_parallel``).
    ``mode`` picks Ulysses (all-to-all on heads over 'spu'), the ring (kv
    chunks rotating over 'sp'), or their 2D composition, with
    ``intra_size`` the Ulysses degree and ``size / intra_size`` the
    ring's; fields, validation and degrees as in the JAX package
    (torchacc_tpu/config.py:308-342)."""
    size: int = 1
    mode: str = "ulysses"             # 'ulysses' | 'ring' | '2d'
    intra_size: Optional[int] = None  # 2D: Ulysses degree; ring = size/intra

    def validate(self) -> None:
        _check(self.size >= 1, "sp.size must be >= 1")
        _check(self.mode in ("ulysses", "ring", "2d"),
               f"sp.mode invalid: {self.mode}")
        if self.mode == "2d":
            _check(self.intra_size is not None and self.intra_size >= 1,
                   "sp.intra_size required for 2d mode")
            _check(self.size % self.intra_size == 0,
                   "sp.size must be divisible by sp.intra_size")

    @property
    def ulysses_degree(self) -> int:
        """Extent of the 'spu' (all-to-all) mesh axis."""
        if self.mode == "ulysses":
            return self.size
        if self.mode == "2d":
            return self.intra_size or 1
        return 1

    @property
    def ring_degree(self) -> int:
        """Extent of the 'sp' (ring) mesh axis."""
        return self.size // self.ulysses_degree


@dataclass
class EPConfig:
    """Expert parallelism for a mixture of experts: the experts split
    over 'ep' (``parallel/sharding.py``, ``models/moe.py``)."""
    size: int = 1
    # switch-style expert capacity factor: None = dense dispatch (no
    # token dropping).  Folded into the model's ``moe_capacity_factor``
    # by accelerate() unless the model config sets its own value.
    capacity_factor: Optional[float] = None

    def validate(self) -> None:
        _check(self.size >= 1, "ep.size must be >= 1")
        if self.capacity_factor is not None:
            _check(self.capacity_factor > 0,
                   "ep.capacity_factor must be > 0")


@dataclass
class DistConfig:
    """The parallel composition and its topology.  ``topology`` orders
    the mesh axes slowest network first (a permutation of
    ``MESH_AXES``); ``build_mesh`` lays it onto rank-major order, so the
    last axes join ranks of one node.  ``dp.size = -1`` is inferred as
    world/(pp*fsdp*sp*ep*tp)."""
    dp: DPConfig = field(default_factory=DPConfig)
    tp: TPConfig = field(default_factory=TPConfig)
    fsdp: FSDPConfig = field(default_factory=FSDPConfig)
    pp: PPConfig = field(default_factory=PPConfig)
    sp: SPConfig = field(default_factory=SPConfig)
    ep: EPConfig = field(default_factory=EPConfig)
    topology: Tuple[str, ...] = MESH_AXES
    # DCN-connected slices; only the axis-order check is ported
    num_slices: int = 1

    def validate(self) -> None:
        for sub in (self.dp, self.tp, self.fsdp, self.pp, self.sp, self.ep):
            sub.validate()
        _check(tuple(sorted(self.topology)) == tuple(sorted(MESH_AXES)),
               f"dist.topology must be a permutation of {MESH_AXES}, got "
               f"{self.topology}")
        _check(self.num_slices >= 1, "dist.num_slices must be >= 1")

    def axis_sizes(self, world_size: int) -> Dict[str, int]:
        """Every axis size, dp inferred when dp.size == -1."""
        sizes = {
            "tp": self.tp.size,
            "fsdp": self.fsdp.size,
            "pp": self.pp.size,
            "sp": self.sp.ring_degree,
            "spu": self.sp.ulysses_degree,
            "ep": self.ep.size,
        }
        fixed = math.prod(sizes.values())
        if self.dp.size == -1:
            _check(world_size % fixed == 0,
                   f"world size {world_size} not divisible by "
                   f"pp*fsdp*sp*ep*tp={fixed}")
            sizes["dp"] = world_size // fixed
        else:
            sizes["dp"] = self.dp.size
        total = math.prod(sizes.values())
        _check(total == world_size,
               f"product of parallel sizes {total} != device count "
               f"{world_size} (sizes={sizes})")
        return sizes


@dataclass
class PerfConfig:
    """The hot loop's policy: only ``overlap_fsdp`` is here, for the
    JAX package's refusal of it under pipeline parallelism.
    ``accelerate()`` folds it into the model config, as the JAX package
    does, where the training check refuses it as it refuses the model's
    own ``overlap_fsdp`` (the overlap is not ported, ROADMAP.md A8b)."""
    # FSDP all-gather / compute overlap of the JAX package's unrolled loop
    overlap_fsdp: bool = False


@dataclass
class ResilienceConfig:
    """The checkpoint path's part of the JAX package's
    ``ResilienceConfig`` (torchacc_tpu/config.py:641-822), with its
    defaults and validation messages: the I/O retries and their backoff,
    the coordination timeout of the multi-rank resume consensus, and
    elastic resume.  The guards, SDC defense, watchdog, loader retries,
    batch validation and the preemption handler's emergency save come
    with ROADMAP A13 and are absent: the port makes no emergency save on
    SIGTERM.  ``tiered_checkpointing`` is here only to raise by name."""

    # checkpoint save/restore I/O retries (jittered exponential backoff)
    ckpt_retries: int = 3
    retry_base_delay_s: float = 0.5
    retry_max_delay_s: float = 8.0
    retry_deadline_s: Optional[float] = None   # total wall-clock budget
    # timeout of the resume consensus' collectives (more than one rank)
    coord_timeout_s: float = 120.0
    # allow fit(resume='auto') to restore a checkpoint saved under
    # another data-parallel layout or process count (dp/fsdp/hosts);
    # tp/pp/sp/spu/ep changes always raise TopologyMismatchError
    elastic_resume: bool = False
    # zero-stall tiered checkpoints (checkpoint/tiered.py): not ported
    tiered_checkpointing: bool = False

    def validate(self) -> None:
        _check(self.ckpt_retries >= 0, "resilience.ckpt_retries must be >= 0")
        _check(self.retry_base_delay_s >= 0,
               "resilience.retry_base_delay_s must be >= 0")
        _check(self.retry_max_delay_s >= self.retry_base_delay_s,
               "resilience.retry_max_delay_s must be >= retry_base_delay_s")
        if self.retry_deadline_s is not None:
            _check(self.retry_deadline_s > 0,
                   "resilience.retry_deadline_s must be positive")
        _check(self.coord_timeout_s > 0,
               "resilience.coord_timeout_s must be positive")
        _unported(not self.tiered_checkpointing,
                  "resilience.tiered_checkpointing (tiered zero-stall "
                  "checkpoints)", "A13")

    def retry_policy(self, max_retries: int):
        """The ``utils.retry.RetryPolicy`` of the delay and deadline
        fields."""
        from torchacc_tpu_torch.utils.retry import RetryPolicy
        return RetryPolicy(max_retries=max_retries,
                           base_delay_s=self.retry_base_delay_s,
                           max_delay_s=self.retry_max_delay_s,
                           deadline_s=self.retry_deadline_s)


@dataclass
class Config:
    """The framework config.  Serving reads ``serve``; training reads
    ``compute``, ``memory``, ``data``, ``dist``, ``resilience``,
    ``perf``, ``grad_accum`` and ``seed``."""

    serve: ServeConfig = field(default_factory=ServeConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    data: DataConfig = field(default_factory=DataConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    perf: PerfConfig = field(default_factory=PerfConfig)
    # micro-batches per optimizer step (the global batch splits along
    # dim 0; the quant histories chain micro by micro)
    grad_accum: int = 1
    # seed of the random weights Trainer.init() makes
    seed: int = 0

    _mesh: Any = field(default=None, repr=False, compare=False)

    def validate(self) -> None:
        self.serve.validate()
        self.compute.validate()
        self.memory.validate()
        self.data.validate()
        self.dist.validate()
        self.resilience.validate()
        _check(self.grad_accum >= 1, "grad_accum must be >= 1")
        # JAX's two refusals under pipeline parallelism, with its messages
        # (torchacc_tpu/config.py:915-921)
        _check(self.compute.quant == "none" or self.dist.pp.size == 1,
               "compute.quant does not compose with pipeline "
               "parallelism (pp.size > 1) — the pipeline regions do "
               "not thread the delayed-scaling state")
        _check(not self.perf.overlap_fsdp or self.dist.pp.size == 1,
               "perf.overlap_fsdp does not compose with pipeline "
               "parallelism (the pp schedules own their layer loop)")

    def get_mesh(self, device_type: str = "cuda"):
        """The device mesh of ``dist`` over the process group, built at
        the first call (``parallel.mesh.build_mesh``)."""
        if self._mesh is None:
            from torchacc_tpu_torch.parallel.mesh import build_mesh
            self._mesh = build_mesh(self.dist, device_type)
        return self._mesh
