"""Logical-axis rules and the sharding plan (the port of torchacc_tpu/
parallel/sharding.py: the rule table :47-55, ``make_rules`` :63,
``spec_for`` :78, ``batch_spec`` :163).

The JAX package maps logical axes to mesh axes and lets GSPMD insert
the collectives.  The port keeps the same table and reads it into
torch placements:

- ``heads``/``mlp`` on 'tp': q/k/v and gate/up are column-parallel
  (``Shard(0)`` of the ``[out, in]`` weight on the 'tp' mesh, as
  ``ColwiseParallel`` places them), o and down row-parallel
  (``Shard(1)``, as ``RowwiseParallel`` does); ``vocab`` on 'tp': the
  embedding and the head are vocab-parallel (``Shard(0)``).  Every
  other parameter is ``Replicate()`` on 'tp', so that each parameter's
  placements name every axis it is replicated over.  The forward
  (``models/transformer.py``) reads the local shards with ``to_local()``
  and issues the Megatron collectives itself, since the kernels take
  raw pointers.
- ``embed`` on 'fsdp': ``fully_shard`` over the ('dp', 'fsdp')
  sub-mesh, once per decoder block and once at the root: ZeRO-3 over
  'fsdp', replicated over 'dp' (HSDP when both are above 1).  FSDP2
  shards each parameter's dim 0, not its ``embed`` dim, and shards the
  small ones too where JAX keeps those under ``min_weight_size``
  replicated; the function computed is the same (ROADMAP.md C2).

Gradients are reduced as sums (divide factor 1): the Trainer divides by
the global token count, as the JAX Trainer does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from torchacc_tpu_torch.config import DATA_AXES, Config
from torchacc_tpu_torch.models.axes import param_axes
from torchacc_tpu_torch.parallel.mesh import data_mesh, describe_mesh

# a rule maps a logical axis to a mesh axis, a tuple of mesh axes, or
# None (replicated)
LogicalRules = Sequence[Tuple[str, Union[str, Tuple[str, ...], None]]]

DEFAULT_RULES: LogicalRules = (
    ("batch", ("dp", "fsdp")),
    ("seq", ("sp", "spu")),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("expert_mlp", "tp"),
    ("stage", "pp"),
    ("norm", None),
    ("layers", None),
)

# the logical axes the forward splits over 'tp' (Megatron heads and MLP,
# the vocab-parallel embedding and head)
_TP_AXES = ("heads", "mlp", "vocab")


def make_rules(config: Optional[Config] = None) -> LogicalRules:
    """The rule table of ``config``: ``fsdp.shard_axis_rules`` first
    (first match wins), then the defaults."""
    rules: List[Tuple[str, Any]] = []
    if config is not None and config.dist.fsdp.shard_axis_rules:
        rules.extend(config.dist.fsdp.shard_axis_rules)
    rules.extend(DEFAULT_RULES)
    return tuple(rules)


def _table(rules: LogicalRules) -> Dict[str, Any]:
    table: Dict[str, Any] = {}
    for name, target in rules:
        table.setdefault(name, target)
    return table


def spec_for(logical_axes: Sequence[Any], rules: LogicalRules
             ) -> Tuple[Any, ...]:
    """The mesh axes of each dim (a ``PartitionSpec``'s entries: a mesh
    axis, a tuple of them, or None), first match wins and a mesh axis is
    used at most once.  A dim that holds flattened logical axes (a tuple,
    ``models/axes.py``) takes its major axis's target; a minor axis
    mapped to a mesh axis raises, since a flattened dim cannot be split
    along its minor part."""
    table = _table(rules)
    used: set = set()
    out: List[Any] = []
    for ax in logical_axes:
        if isinstance(ax, tuple):
            for minor in ax[1:]:
                if table.get(minor) is not None:
                    raise ValueError(
                        f"logical axis {minor!r} is flattened into {ax} and "
                        f"cannot be sharded on its own")
            ax = ax[0]
        if ax is not None and ax not in table:
            raise ValueError(
                f"unknown logical axis {ax!r}; known axes: {sorted(table)} "
                "(add a rule via fsdp.shard_axis_rules to extend)")
        tgt = table.get(ax) if ax is not None else None
        if tgt is None:
            out.append(None)
        elif isinstance(tgt, tuple):
            kept = tuple(t for t in tgt if t not in used)
            used.update(kept)
            out.append(kept if kept else None)
        elif tgt in used:
            out.append(None)
        else:
            used.add(tgt)
            out.append(tgt)
    return tuple(out)


def batch_spec(config: Optional[Config] = None) -> Tuple[Any, ...]:
    """The input batch's sharding: its leading dim over the data axes,
    its sequence dim over the sequence axes."""
    return spec_for(("batch", "seq"), make_rules(config))


def _check_plan(cfg, rules: LogicalRules, sizes: Dict[str, int],
                grad_accum: int = 1) -> None:
    """Raise where the rule table, the model or the step asks for a
    layout the forward does not implement."""
    table = _table(rules)
    tp = sizes["tp"]
    if tp > 1:
        off = [ax for ax in _TP_AXES if table.get(ax) != "tp"]
        extra = [ax for ax, tgt in table.items() if ax not in _TP_AXES
                 and ax != "expert_mlp"
                 and "tp" in (tgt if isinstance(tgt, tuple) else (tgt,))]
        if off or extra:
            raise NotImplementedError(
                f"a rule table that splits {sorted(extra)} over 'tp', or "
                f"not {off}, is not ported to torchacc_tpu_torch yet: the "
                f"forward implements Megatron heads/mlp and the vocab-"
                f"parallel embedding and head (ROADMAP.md A8b)")
        for what, n in (("num_heads", cfg.num_heads),
                        ("num_kv_heads", cfg.kv_heads),
                        ("intermediate_size", cfg.ffn_size),
                        ("vocab_size", cfg.vocab_size)):
            if n % tp:
                raise NotImplementedError(
                    f"{what} {n} is not divisible by tp {tp}: the JAX "
                    f"package replicates such a dim (and the head falls "
                    f"back to a replicated one); the port does not "
                    f"(ROADMAP.md A8b)")
    if cfg.attn_dropout > 0.0 and (tp > 1 or sizes["dp"] * sizes["fsdp"]
                                   > 1):
        raise NotImplementedError(
            "attention dropout on a mesh needs the flash kernels' batch and "
            "head offsets, so that a shard draws the masks of its global "
            "coordinates; they are not ported to torchacc_tpu_torch yet "
            "(ROADMAP.md B-1)")
    if cfg.quant != "none" and grad_accum > 1 \
            and sizes["dp"] * sizes["fsdp"] > 1:
        raise NotImplementedError(
            "compute.quant with grad_accum > 1 on more than one data shard "
            "is not ported to torchacc_tpu_torch yet (ROADMAP.md A8b): "
            "each rank splits its own rows into micro-batches, where the "
            "JAX package splits the global batch, so micro-batch i's "
            "activation amax would cover other rows than JAX's")
    if sizes["fsdp"] > 1 and table.get("embed") != "fsdp":
        raise NotImplementedError(
            "a rule table that does not shard 'embed' over 'fsdp' is not "
            "ported to torchacc_tpu_torch yet: FSDP2 shards every "
            "parameter (ROADMAP.md A8b)")


def _place_tp(module: nn.Module, prefix: str, tp_mesh: DeviceMesh,
              rules: LogicalRules) -> None:
    """Make every parameter of ``module`` a DTensor on the 'tp' mesh:
    ``Shard(d)`` on the dim the rules put on 'tp', else ``Replicate()``.
    Every rank holds the same full weights, so each keeps its own slice
    without communication."""
    named = list(module.named_parameters(prefix=prefix))
    axes = param_axes(named)
    for name, p in named:
        spec = spec_for(axes[name], rules)
        dims = [d for d, tgt in enumerate(spec)
                if "tp" in (tgt if isinstance(tgt, tuple) else (tgt,))]
        placement = Shard(dims[0]) if dims else Replicate()
        local = name[len(prefix) + 1:] if prefix else name
        owner, _, leaf = local.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(
            distribute_tensor(p.detach(), tp_mesh, [placement],
                              src_data_rank=None),
            requires_grad=p.requires_grad))


def mixed_precision(config: Config) -> MixedPrecisionPolicy:
    """FSDP2's policy: with ``compute.bf16_compute_params`` the blocks
    read bf16 copies of the f32 masters and reduce f32 gradients (the
    function of the one-device bf16 shadow, ``train/amp.py``); otherwise
    they read the masters as they are, as on one device."""
    bf16 = config.compute.bf16_compute_params
    return MixedPrecisionPolicy(
        param_dtype=config.compute.dtype if bf16 else None,
        reduce_dtype=torch.float32, cast_forward_inputs=False)


def shard_model(model: nn.Module, mesh: DeviceMesh, config: Config,
                materialize: Optional[Callable[[nn.Module, str], None]]
                = None) -> nn.Module:
    """Shard a port ``TransformerLM`` over ``mesh`` in place (the plan
    above) and hand its modules their 'tp' group.  ``materialize(module,
    prefix)``: makes the weights of a module on ``meta``, in the order
    of ``named_parameters`` (``models.transformer.materializer``); the
    blocks are made and sharded one at a time, so that no rank holds
    more than one block unsharded."""
    sizes = describe_mesh(mesh)
    rules = make_rules(config)
    _check_plan(model.cfg, rules, sizes, config.grad_accum)
    tp_mesh = mesh["tp"] if sizes["tp"] > 1 else None
    fsdp_kw = dict(mesh=data_mesh(mesh), mp_policy=mixed_precision(config))

    def prepare(module, prefix):
        if materialize is not None:
            materialize(module, prefix)
        if tp_mesh is not None:
            _place_tp(module, prefix, tp_mesh, rules)

    prepare(model.embed_tokens, "embed_tokens")
    for i, block in enumerate(model.layers):
        prepare(block, f"layers.{i}")
        fully_shard(block, **fsdp_kw)
    prepare(model.final_norm, "final_norm")
    if model.lm_head is not None:
        prepare(model.lm_head, "lm_head")
    fully_shard(model, **fsdp_kw)
    for mod in [model] + list(model.layers):
        # the reduce-scatter (and HSDP's all-reduce) sums
        mod.set_gradient_divide_factor(1.0)
        mod.set_force_sum_reduction_for_comms(True)
    group = None if tp_mesh is None else tp_mesh.get_group()
    for mod in model.modules():
        if hasattr(type(mod), "tp_group"):
            mod.tp_group = group
    model.data_groups = data_groups(mesh)
    return model


def data_groups(mesh: DeviceMesh) -> Tuple[Any, ...]:
    """The process groups of the data axes above 1: a sum or max over the
    global batch is an all-reduce over each."""
    sizes = describe_mesh(mesh)
    return tuple(mesh.get_group(a) for a in DATA_AXES if sizes[a] > 1)
