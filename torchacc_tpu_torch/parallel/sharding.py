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
- ``expert`` on 'ep' and ``expert_mlp`` on 'tp': a mixture of experts'
  stacked experts (``models/moe.py``) are split by expert over 'ep'
  (``Shard(0)``) and by ffn column over 'tp'; every rank of one 'ep' x
  'tp' group holds the same tokens (the batch splits over the data and
  sequence axes only), computes its experts' share on all of them, and
  the shares are summed over the group (:func:`axes_group`).  Where
  'ep' is above 1 every parameter is a DTensor on the ('ep', 'tp')
  mesh, ``Replicate()`` on 'ep' but the experts, so that the global
  norm counts a copy once.  The router stays whole on every rank (JAX
  splits its expert dim over 'ep' and gathers it): each rank routes
  its tokens over all the experts.
- ``embed`` on 'fsdp': ``fully_shard`` over the ('dp', 'fsdp')
  sub-mesh, once per decoder block and once at the root: ZeRO-3 over
  'fsdp', replicated over 'dp' (HSDP when both are above 1).  FSDP2
  shards each parameter's dim 0, not its ``embed`` dim, and shards the
  small ones too where JAX keeps those under ``min_weight_size``
  replicated; the function computed is the same (ROADMAP.md C2).

Gradients are reduced as sums (divide factor 1): the Trainer divides by
the global token count, as the JAX Trainer does.

Context parallelism ('sp' x 'spu', ``ops/context_parallel``): the
parameters are replicated over the sequence axes, as JAX's rules keep
them (``embed`` on 'fsdp' only), and each sequence rank's gradient is
a partial sum over its own chunk of the tokens.  FSDP2 shards and
reduces over the data axes only; the Trainer then all-reduces the local
gradient shards over the sequence ranks of this rank's data shard, one
group over 'sp' x 'spu' (:func:`seq_group`).
FSDP2 with the sequence axes in its replicate dim would need one mesh
dim over 'dp', 'sp' and 'spu', which are not contiguous in
``MESH_AXES``, and would change the data mesh (HSDP) that the
checkpoints and the one-device equality rest on.  Every attention layer
gets this rank's :class:`CPLayout` (its groups, its chunk, its batch and
head offsets), so that dropout draws the global masks on any mesh.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from torchacc_tpu_torch.config import DATA_AXES, Config
from torchacc_tpu_torch.models.axes import param_axes
from torchacc_tpu_torch.ops.context_parallel import CPLayout
from torchacc_tpu_torch.parallel.mesh import data_mesh, describe_mesh, pp_stage

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
# the model-parallel mesh axes, whose ranks hold the same tokens
MP_AXES = ("ep", "tp")
# parameters kept whole on the model-parallel mesh whatever their axes
_WHOLE = re.compile(r"moe\.router\.weight$")


def make_rules(config: Optional[Config] = None) -> LogicalRules:
    """The rule table of ``config``: ``fsdp.shard_axis_rules`` first
    (first match wins), then under pipeline parallelism JAX's
    ``("layers", "pp")``, then the defaults."""
    rules: List[Tuple[str, Any]] = []
    if config is not None and config.dist.fsdp.shard_axis_rules:
        rules.extend(config.dist.fsdp.shard_axis_rules)
    if config is not None and config.dist.pp.size > 1:
        # JAX's stacking dim becomes the stage dim; here each stage holds
        # its own blocks (shard_model), the same placement
        rules.append(("layers", "pp"))
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


def _check_plan(cfg, rules: LogicalRules, sizes: Dict[str, int]) -> None:
    """Raise where the rule table or the model asks for a layout the
    forward does not implement."""
    table = _table(rules)
    tp = sizes["tp"]
    moe = cfg.num_experts > 0
    if tp > 1:
        off = [ax for ax in _TP_AXES + (("expert_mlp",) if moe else ())
               if table.get(ax) != "tp"]
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
    ep = sizes.get("ep", 1)
    if ep > 1 and moe:
        if table.get("expert") != "ep":
            raise NotImplementedError(
                "a rule table that does not shard 'expert' over 'ep' is not "
                "ported to torchacc_tpu_torch yet (ROADMAP.md A8b)")
        if cfg.num_experts % ep:
            raise NotImplementedError(
                f"num_experts {cfg.num_experts} is not divisible by ep "
                f"{ep}: the JAX package replicates such a dim; the port "
                f"does not (ROADMAP.md A8b)")
    seq = sizes["sp"] * sizes["spu"]
    if seq > 1:
        if not cfg.context_parallel:
            raise ValueError(
                "a mesh with 'sp' x 'spu' > 1 needs a model with "
                "context_parallel=True (accelerate() sets it from "
                "dist.sp.size)")
        for what, n in (("num_heads", cfg.num_heads),
                        ("num_kv_heads", cfg.kv_heads)):
            if (n // tp) % sizes["spu"]:
                raise ValueError(
                    f"{what} {n} over tp {tp} is not divisible by the "
                    f"ulysses degree {sizes['spu']}")
    pp = sizes.get("pp", 1)
    if pp > 1:
        if cfg.pp_size != pp:
            raise ValueError(
                f"a mesh with 'pp' {pp} needs a model with pp_size {pp} "
                f"(accelerate() sets it from dist.pp), got {cfg.pp_size}")
        if cfg.num_layers % (pp * cfg.pp_virtual):
            raise ValueError(
                f"num_layers {cfg.num_layers} not divisible by pp size {pp} "
                f"x virtual_stages {cfg.pp_virtual}")
    if sizes["fsdp"] > 1 and table.get("embed") != "fsdp":
        raise NotImplementedError(
            "a rule table that does not shard 'embed' over 'fsdp' is not "
            "ported to torchacc_tpu_torch yet: FSDP2 shards every "
            "parameter (ROADMAP.md A8b)")


def _place_mp(module: nn.Module, prefix: str, mp_mesh: DeviceMesh,
              axes_names: Sequence[str], rules: LogicalRules) -> None:
    """Make every parameter of ``module`` a DTensor on the model-parallel
    mesh ``mp_mesh`` (its dims ``axes_names``, of 'ep' and 'tp'): along
    each, ``Shard(d)`` on the dim the rules put on that axis, else
    ``Replicate()`` (the router always).  Every rank holds the same full
    weights, so each keeps its own slice without communication."""
    named = list(module.named_parameters(prefix=prefix))
    axes = param_axes(named)
    for name, p in named:
        spec = spec_for(axes[name], rules)
        placements = []
        for a in axes_names:
            dims = [d for d, tgt in enumerate(spec)
                    if a in (tgt if isinstance(tgt, tuple) else (tgt,))]
            placements.append(Shard(dims[0]) if dims and not
                              _WHOLE.search(name) else Replicate())
        local = name[len(prefix) + 1:] if prefix else name
        owner, _, leaf = local.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(
            distribute_tensor(p.detach(), mp_mesh, placements,
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
                = None, draws: bool = True) -> nn.Module:
    """Shard a port ``TransformerLM`` over ``mesh`` in place (the plan
    above) and hand its modules their 'tp' group.  Over 'pp' the model
    keeps only this rank's stage's blocks (``parallel.pp.stage_layers``:
    under ``pp_virtual`` the chunks d, d+P, ...), in a ``StageLayers``
    under their global names; the embedding, the final norm and the
    head stay on every stage, and the Trainer sums their gradients over
    the 'pp' group (``model.pp_group``).  ``materialize(module,
    prefix)``: makes the weights of a module on ``meta``, in the order
    of ``named_parameters`` (``models.transformer.materializer``); the
    blocks are made and sharded one at a time, so that no rank holds
    more than one block unsharded.  Another stage's block is made only
    where ``materialize`` ``draws`` from a random stream (so that the
    blocks after it draw the one-device model's values), and released
    at once: a stage holds its own blocks and at most one other.  Where
    ``materialize`` gives storage only (``draws`` false: the weights
    come from a checkpoint next) it is never made."""
    sizes = describe_mesh(mesh)
    rules = make_rules(config)
    _check_plan(model.cfg, rules, sizes)
    # the parameters' model-parallel mesh: 'tp', 'ep' or both, where
    # above 1
    mp_axes = tuple(a for a in MP_AXES if sizes[a] > 1)
    mp_mesh = (None if not mp_axes else mesh[mp_axes[0]] if len(mp_axes) == 1
               else mesh[mp_axes])
    fsdp_kw = dict(mesh=data_mesh(mesh), mp_policy=mixed_precision(config))

    def prepare(module, prefix):
        if materialize is not None:
            materialize(module, prefix)
        if mp_mesh is not None:
            _place_mp(module, prefix, mp_mesh, mp_axes, rules)

    prepare(model.embed_tokens, "embed_tokens")
    n_pp, stage = pp_stage(mesh)
    owned = set(range(model.cfg.num_layers))
    if n_pp > 1:
        from torchacc_tpu_torch.models.transformer import StageLayers
        from torchacc_tpu_torch.parallel.pp import stage_layers
        owned = {i for chunk in stage_layers(model.cfg.num_layers, n_pp,
                                             model.cfg.pp_virtual, stage)
                 for i in chunk}
    kept = {}
    for i, block in enumerate(model.layers):
        if i not in owned:
            # another stage's block: its draws made (so that the random
            # stream of the blocks after it is the one-device model's),
            # then its storage released before the next block is made
            if materialize is not None and draws:
                materialize(block, f"layers.{i}")
            block.to_empty(device="meta")
            continue
        prepare(block, f"layers.{i}")
        fully_shard(block, **fsdp_kw)
        kept[i] = block
    if n_pp > 1:
        model.layers = StageLayers(kept)
    prepare(model.final_norm, "final_norm")
    if model.lm_head is not None:
        prepare(model.lm_head, "lm_head")
    fully_shard(model, **fsdp_kw)
    for mod in [model] + list(model.layers):
        # the reduce-scatter (and HSDP's all-reduce) sums
        mod.set_gradient_divide_factor(1.0)
        mod.set_force_sum_reduction_for_comms(True)
    group = mesh.get_group("tp") if sizes["tp"] > 1 else None
    layout = CPLayout.from_mesh(mesh)
    for mod in model.modules():
        if hasattr(type(mod), "tp_group"):
            mod.tp_group = group
        if hasattr(type(mod), "layout"):
            mod.layout = layout
    model.seq_group = seq_group(mesh)
    model.data_groups = data_groups(mesh, model.seq_group)
    if model.cfg.num_experts > 0:
        _wire_experts(model, mesh, model.seq_group)
    model.pp_group = mesh.get_group("pp") if n_pp > 1 else None
    return model


def _wire_experts(model: nn.Module, mesh: DeviceMesh, seq: Any) -> None:
    """Hand every ``MoEMlp`` its groups (``models/moe.py``): the 'ep' x
    'tp' group of the experts' sum, its first expert, and the groups
    over which the tokens are split (the data axes, major first, and the
    sequence ranks)."""
    from torchacc_tpu_torch.models.moe import MoEMlp
    sizes = describe_mesh(mesh)
    group = axes_group(mesh, MP_AXES)
    first = mesh.get_local_rank("ep") * (model.cfg.num_experts
                                         // sizes["ep"])
    rows = tuple(mesh.get_group(a) for a in DATA_AXES if sizes[a] > 1)
    for mod in model.modules():
        if isinstance(mod, MoEMlp):
            mod.expert_group, mod.expert_offset = group, first
            mod.row_groups, mod.seq_group = rows, seq


SEQ_AXES = ("sp", "spu")


def axes_group(mesh: DeviceMesh, axes: Sequence[str]) -> Any:
    """The process group of this rank's ranks along the mesh ``axes``
    (adjacent in ``MESH_AXES``; None where all are 1), ranked in their
    flattened order.  Where two axes are above 1 the group is made here
    over them flattened, which is a collective: every rank calls this
    with the same mesh."""
    sizes = describe_mesh(mesh)
    live = [a for a in axes if sizes[a] > 1]
    if len(live) < 2:
        return mesh.get_group(live[0]) if live else None
    names = list(mesh.mesh_dim_names)
    order = [i for i, a in enumerate(names) if a not in axes] \
        + [names.index(a) for a in axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    ranks = mesh.mesh.permute(order).reshape(-1, n).tolist()
    group, _ = dist.new_subgroups_by_enumeration(ranks)
    return group


def seq_group(mesh: DeviceMesh) -> Any:
    """The process group of this rank's sequence ranks, 'sp' x 'spu'
    (None where both are 1): a gradient summed over them is one
    all-reduce (:func:`axes_group`)."""
    return axes_group(mesh, SEQ_AXES)


def data_groups(mesh: DeviceMesh, seq: Any = None) -> Tuple[Any, ...]:
    """The process groups of the data axes above 1 and ``seq``, the
    sequence ranks' group (:func:`seq_group`), over which a step's
    tokens are split: a sum or max over the global batch is an
    all-reduce over each."""
    sizes = describe_mesh(mesh)
    return tuple(mesh.get_group(a) for a in DATA_AXES if sizes[a] > 1) \
        + (() if seq is None else (seq,))
