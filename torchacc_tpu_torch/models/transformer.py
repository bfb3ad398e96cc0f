"""Decoder-only transformer LM (the port of torchacc_tpu/models/
transformer.py, Llama subset).

``ModelConfig`` is a copy of the JAX package's config with torch dtypes:
every field is there, so a JAX config maps onto it field by field, but
the port implements only the Llama family — rmsnorm, swiglu, plain RoPE
(``rope_theta``, ``rope_scale``), GQA, ``qkv_bias``, ``tie_embeddings``
and ``attn_logit_softcap`` — plus, in the training forward, attention
dropout (``attn_dropout``) and quantized forward matmuls (``quant``,
``quant_sites`` 'attn' and 'mlp', ``quant_amax_history_len``,
``quant_impl``).  The serving forward (serve/scheduler.py) and the
training forward here both reject the rest by name.

Quantized sites keep ``nn.Linear``'s parameter names and shapes:
``quant`` flips execution, never layout.  Their delayed-scaling amax
histories are not held by the modules.  As the flax ``'quant'``
collection is passed to ``apply``, ``forward`` takes them as ``quant``
(site name -> history) and, on a train step, writes the advanced ones
into the dict ``quant_out``; it never changes a history in place.  So a
checkpoint region that re-runs in the backward reads the histories the
step started with, computes the same scales, and writes the same new
histories again: the ``Trainer`` commits them once, after the backward.

``TransformerLM`` is an ``nn.Module`` that holds the weights in
``nn.Linear`` layout (``[out, in]``).  Its ``forward`` is the training
forward (``TransformerLM.__call__`` of the JAX package): embedding,
the blocks — each rematerialised under ``cfg.remat`` with the selective
policy of utils/remat.py — the final norm, and the head (or the final
hidden for the fused CE loss).  Attention goes through ``ops.attn``, so
the flash-attention kernels run for CUDA tensors.  The forward over the
paged cache lives in ``serve.scheduler.PagedDecoder`` as in the JAX
package.  ``init_params`` draws every matrix from normal(0.02) with a
``torch.Generator`` (norm scales one, biases zero), as the flax init
does — the numbers differ from JAX's for the same seed; tests that
compare the two packages carry the JAX weights over with
``models.convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from torchacc_tpu_torch.models.generate import embed
from torchacc_tpu_torch.ops._common import resolve_device, to_local
from torchacc_tpu_torch.ops.attn import attention
from torchacc_tpu_torch.ops.fused import (
    fused_linear_cross_entropy,
    fused_linear_cross_entropy_tp,
)
from torchacc_tpu_torch.ops.quantized_matmul import (
    amax_history_init,
    quant_linear,
)
from torchacc_tpu_torch.utils.remat import (
    checkpoint_block,
    checkpoint_name,
    offload_product,
)


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None      # None = MHA; < num_heads = GQA
    head_dim: Optional[int] = None          # None = hidden / heads
    intermediate_size: Optional[int] = None  # None = llama rule
    max_seq_len: int = 2048
    pos_emb: str = "rope"
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    embed_scale: bool = False
    logit_softcap: float = 0.0
    parallel_block: bool = False
    parallel_block_shared_norm: bool = True
    head_bias: bool = False
    norm_bias: bool = True
    rope_interleaved: bool = False
    logit_scale: float = 1.0
    qkv_bias: bool = False
    o_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16             # activation dtype
    param_dtype: Any = torch.float32
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "nothing"
    remat_cls: Optional[Tuple[str, ...]] = None
    remat_cnt: Optional[int] = None
    attention_impl: str = "auto"            # 'auto' | 'cuda' | 'torch'
    window: Tuple[int, int] = (-1, -1)
    attn_logit_softcap: float = 0.0
    query_scale: Optional[float] = None     # None = head_dim ** -0.5
    sandwich_norms: bool = False
    qk_norm: bool = False
    qk_norm_proj: bool = False
    norm_placement: str = "pre"
    rope_llama3: Optional[Tuple[float, float, float, float]] = None
    rope_longrope: Optional[Tuple] = None
    partial_rotary: float = 1.0
    rope_yarn: Optional[Tuple] = None
    rope_local_theta: Optional[float] = None
    rope_scale: float = 1.0
    layer_pattern: Optional[Tuple[str, ...]] = None
    decode: bool = False
    cache_len: Optional[int] = None
    attn_dropout: float = 0.0
    quant: str = "none"
    quant_sites: Tuple[str, ...] = ("attn", "mlp")
    quant_amax_history_len: int = 16
    quant_impl: str = "auto"
    overlap_fsdp: bool = False
    context_parallel: bool = False
    pp_size: int = 1
    pp_num_micro: int = 1
    pp_virtual: int = 1
    logical_axis_rules: Optional[Tuple] = None
    tp_vocab_head: bool = True
    num_experts: int = 0
    num_experts_per_tok: int = 2
    router_aux_weight: float = 0.01
    moe_dispatch: str = "auto"
    moe_renorm_topk: bool = True
    moe_capacity_factor: Optional[float] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        if self.activation in ("swiglu", "geglu"):
            return ((8 * self.hidden_size // 3) + 255) // 256 * 256
        return 4 * self.hidden_size


def rms_norm(cfg: ModelConfig, x: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """``Norm`` with ``norm='rmsnorm'``: computed in f32, cast back to
    the compute dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True)
                         + cfg.norm_eps)
    return (y * to_local(weight).float()).to(cfg.dtype)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_rope`` for plain RoPE: llama half-split convention, angles in
    f32, outputs cast back to the inputs' dtype.  ``positions`` [S, T]
    (already divided by ``rope_scale`` by the caller when it is not 1)."""
    d = q.shape[-1]
    freqs = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d))
    angles = positions[..., None].float() * freqs            # [S, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        xf = x.float()
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


class RMSNorm(nn.Module):
    def __init__(self, size: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size, **factory))


# ModelConfig fields of the Llama family, which the serving and the
# training forward implement for any value
LLAMA_FIELDS = frozenset({
    "vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
    "head_dim", "intermediate_size", "max_seq_len", "rope_theta",
    "rope_scale", "norm_eps", "qkv_bias", "tie_embeddings",
    "attn_logit_softcap", "query_scale", "dtype", "param_dtype",
})
# the training forward also implements remat (its policy, the
# submodules and the number of layers it covers), the attention choice,
# attention dropout and the quantized matmuls; every other field must
# keep its default
_TRAIN_FIELDS = LLAMA_FIELDS | {
    "remat", "remat_policy", "remat_cls", "remat_cnt", "attention_impl",
    "attn_dropout", "quant", "quant_sites", "quant_amax_history_len",
    "quant_impl"}
# fields that pick how the JAX package lays out or shards the step, or
# knobs inert while their feature is off; none changes what one device
# computes
_TRAIN_INERT = frozenset({
    "scan_layers", "cache_len", "pp_num_micro", "pp_virtual",
    "logical_axis_rules",
    "tp_vocab_head", "num_experts_per_tok", "router_aux_weight",
    "moe_dispatch", "moe_renorm_topk", "moe_capacity_factor",
    "parallel_block_shared_norm", "norm_bias",
})


def check_training_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming every field the training forward
    of this port does not implement."""
    bad = [f"{f.name}={getattr(cfg, f.name)!r}"
           for f in dataclasses.fields(cfg)
           if f.name not in _TRAIN_FIELDS and f.name not in _TRAIN_INERT
           and getattr(cfg, f.name) != f.default]
    if bad:
        raise NotImplementedError(
            "the training forward of torchacc_tpu_torch does not support "
            + ", ".join(bad) + " (it implements rmsnorm, swiglu, plain "
            "RoPE, GQA, qkv_bias, tie_embeddings and attn_logit_softcap)")
    if cfg.quant != "none" and "head" in cfg.quant_sites:
        raise NotImplementedError(
            "quant_sites includes 'head': the quantized vocab projection "
            "is not ported to torchacc_tpu_torch yet (the fused CE head "
            "stays in the compute dtype, and the materialised quantized "
            "head waits for the model-breadth slice, ROADMAP.md A10); "
            "drop 'head' from quant_sites")


_M32 = 0xFFFFFFFF


def _layer_seed(dropout_seed: int, layer_idx: int) -> int:
    """Decorrelate dropout across layers: mix the layer index into the
    seed on uint32 arithmetic (``_layer_seed`` of the JAX package)."""
    return ((int(dropout_seed) & _M32) + layer_idx * 0x9E3779B9) & _M32


def quant_site_on(cfg: ModelConfig, site: str) -> bool:
    """Whether a dense ``site`` ('attn' | 'mlp' | 'head') runs the
    quantized matmul.  Decode always runs the plain dense; the parameter
    layouts are the same either way, so this only picks execution."""
    return (cfg.quant != "none" and site in cfg.quant_sites
            and not cfg.decode)


_SITE_LINEARS = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
                 "mlp": ("gate_proj", "up_proj", "down_proj")}


def quant_site_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The name of every quantized matmul site of ``cfg``, in forward
    order: ``layers.<i>.<attn|mlp>.<linear>`` (the module's path)."""
    return tuple(f"layers.{i}.{site}.{lin}"
                 for i in range(cfg.num_layers)
                 for site, lins in _SITE_LINEARS.items()
                 if quant_site_on(cfg, site) for lin in lins)


def init_quant_state(cfg: ModelConfig,
                     device: Optional[Union[str, torch.device]] = None):
    """Fresh (all zero: "no observation yet") amax histories for every
    quantized site, on the card unless ``device`` says otherwise; None
    when ``cfg.quant`` is 'none'."""
    names = quant_site_names(cfg)
    if not names:
        return None
    device = resolve_device(device)
    return {n: amax_history_init(cfg.quant_amax_history_len, device=device)
            for n in names}


class QuantScope:
    """The delayed-scaling histories of one forward: sites read theirs
    from ``histories`` and, when ``new`` is a dict (a train step), put
    the advanced one there.  With ``new`` None (evaluation) nothing is
    written."""

    def __init__(self, histories, new=None, amax_groups=()):
        self.histories = histories
        self.new = new
        # the data axes' process groups (ops/quantized_matmul.py
        # quant_linear): empty on one device
        self.amax_groups = amax_groups

    def linear(self, cfg: ModelConfig, name: str, x: torch.Tensor,
               lin: nn.Linear) -> torch.Tensor:
        if name not in self.histories:
            raise KeyError(
                f"no amax history for the quantized site {name!r}: pass "
                f"the TrainState.quant of this model config")
        y, hist = quant_linear(
            x, lin.weight, lin.bias, self.histories[name], fmt=cfg.quant,
            impl=cfg.quant_impl, dtype=cfg.dtype,
            update=self.new is not None, amax_groups=self.amax_groups)
        if self.new is not None:
            self.new[name] = hist
        return y


def dense(cfg: ModelConfig, x: torch.Tensor, lin: nn.Linear,
          quant: Optional[QuantScope] = None,
          name: Optional[str] = None) -> torch.Tensor:
    """A projection with both operands in the compute dtype (flax
    ``Dense(dtype=cfg.dtype)``); ``.to`` is free when the weight already
    is (the bf16 shadow).  With ``quant`` the product is the quantized
    one of the site ``name`` (``_quant_dense`` of the JAX package); the
    bias is added after it, in the compute dtype.  Under 'offload_dots'
    the product of an offloaded site goes through
    ``utils.remat.offload_product``.  A tensor-parallel weight (a
    ``DTensor``) is read as this rank's shard: the product is this
    rank's heads or MLP columns (column-parallel), or its partial sum
    (row-parallel, which the caller reduces)."""
    dt = cfg.dtype
    operands = lambda: (x.to(dt), to_local(lin.weight).to(dt))
    if quant is not None:
        return offload_product(operands,
                               lambda: quant.linear(cfg, name, x, lin))
    y = offload_product(operands, lambda: F.linear(*operands()))
    if lin.bias is not None:
        y = y + to_local(lin.bias).to(dt)
    return y


class _TPCopy(torch.autograd.Function):
    """Megatron's f: the identity forward into the column-parallel
    projections; the backward sums the input's gradient over the 'tp'
    ranks (each holds the part from its own heads or columns)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TPSum(torch.autograd.Function):
    """Megatron's g: the forward sums the row-parallel partial products
    (and the vocab-parallel embedding's rows) over the 'tp' ranks; the
    backward is the identity."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_in(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _TPCopy.apply(x, group)


def _tp_out(y: torch.Tensor, group) -> torch.Tensor:
    return y if group is None else _TPSum.apply(y, group)


class Attention(nn.Module):
    # the 'tp' process group (parallel/sharding.py shard_model): the
    # projections hold this rank's heads; None on one device
    tp_group = None

    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_size
        self.q_proj = nn.Linear(h, cfg.num_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.k_proj = nn.Linear(h, cfg.kv_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.v_proj = nn.Linear(h, cfg.kv_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.o_proj = nn.Linear(cfg.num_heads * d, h, bias=False, **factory)

    def forward(self, x, positions, segment_ids=None, dropout_seed=None,
                quant=None, name="attn"):
        """``Attention.__call__`` (:480) without the KV cache: q/k/v
        projections, RoPE, causal attention over ``segment_ids``, o
        projection.  The ``checkpoint_name`` sites are the JAX package's
        names for the selective remat policies.  ``dropout_seed`` (this
        layer's) turns attention dropout on when ``cfg.attn_dropout`` is
        set; ``quant`` is the forward's :class:`QuantScope` and ``name``
        this module's path, which prefixes its sites' names.  Under
        tensor parallelism the heads are this rank's (``num_heads / tp``
        and ``kv_heads / tp``; the GQA group is unchanged)."""
        cfg = self.cfg
        b, s = x.shape[:2]
        d = cfg.head_size
        qs = quant if quant_site_on(cfg, "attn") else None
        x = _tp_in(x, self.tp_group)
        with checkpoint_name("qkv_proj"):
            q = dense(cfg, x, self.q_proj, qs, f"{name}.q_proj").view(
                b, s, -1, d)
            k = dense(cfg, x, self.k_proj, qs, f"{name}.k_proj").view(
                b, s, -1, d)
            v = dense(cfg, x, self.v_proj, qs, f"{name}.v_proj").view(
                b, s, -1, d)
        rp = (positions.float() / cfg.rope_scale if cfg.rope_scale != 1.0
              else positions)
        q, k = rope(q, k, rp, cfg)
        dropout_p, seed = 0.0, None
        if cfg.attn_dropout > 0.0 and dropout_seed is not None:
            dropout_p, seed = cfg.attn_dropout, dropout_seed
        out = attention(q, k, v, causal=True, window=cfg.window,
                        scale=cfg.query_scale, q_segment_ids=segment_ids,
                        kv_segment_ids=segment_ids, dropout_p=dropout_p,
                        dropout_seed=seed,
                        logit_softcap=cfg.attn_logit_softcap,
                        impl=cfg.attention_impl)
        with checkpoint_name("attn_out"):
            # the JAX o_proj contracts (heads, d); flattened it is the
            # same [M, K] @ [K, N]
            return _tp_out(dense(cfg, out.reshape(b, s, -1), self.o_proj,
                                 qs, f"{name}.o_proj"), self.tp_group)


class Mlp(nn.Module):
    # the 'tp' process group: gate/up hold this rank's columns, down the
    # matching rows; None on one device
    tp_group = None

    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.ffn_size
        self.gate_proj = nn.Linear(h, f, bias=False, **factory)
        self.up_proj = nn.Linear(h, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, h, bias=False, **factory)

    def forward(self, x, quant=None, name="mlp"):
        """SwiGLU ``Mlp.__call__`` (:665)."""
        cfg = self.cfg
        qs = quant if quant_site_on(cfg, "mlp") else None
        x = _tp_in(x, self.tp_group)
        with checkpoint_name("mlp_gate_up"):
            gate = dense(cfg, x, self.gate_proj, qs, f"{name}.gate_proj")
            up = dense(cfg, x, self.up_proj, qs, f"{name}.up_proj")
        with checkpoint_name("mlp_out"):
            return _tp_out(dense(cfg, F.silu(gate) * up, self.down_proj, qs,
                                 f"{name}.down_proj"), self.tp_group)


def _sub_remat(cfg: ModelConfig) -> bool:
    """Remat covers the attention and/or the MLP inside each block
    (``remat_cls`` without 'Block'), not the whole block."""
    return bool(cfg.remat and cfg.remat_cls
                and "Block" not in cfg.remat_cls)


def _remat_layer(cfg: ModelConfig, i: int) -> bool:
    """Layer ``i`` rematerialises: all layers, or the first
    ``remat_cnt``."""
    return cfg.remat and (cfg.remat_cnt is None
                          or not 0 <= cfg.remat_cnt < cfg.num_layers
                          or i < cfg.remat_cnt)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.hidden_size, **factory)
        self.attn = Attention(cfg, **factory)
        self.ln2 = RMSNorm(cfg.hidden_size, **factory)
        self.mlp = Mlp(cfg, **factory)

    def forward(self, x, positions, segment_ids=None, dropout_seed=None,
                quant=None, name="block", sub_remat=False):
        """Pre-norm ``Block.__call__`` (:722).  ``sub_remat``: the
        attention and/or MLP named by ``cfg.remat_cls`` are checkpoint
        regions under ``cfg.remat_policy`` (the block itself is not)."""
        cfg = self.cfg
        remat_attn = sub_remat and "Attention" in cfg.remat_cls
        remat_mlp = sub_remat and "Mlp" in cfg.remat_cls
        attn = functools.partial(self.attn, dropout_seed=dropout_seed,
                                 quant=quant, name=f"{name}.attn")
        mlp = functools.partial(self.mlp, quant=quant, name=f"{name}.mlp")
        a_in = rms_norm(cfg, x, self.ln1.weight)
        h = x + (checkpoint_block(attn, cfg.remat_policy, a_in, positions,
                                  segment_ids) if remat_attn
                 else attn(a_in, positions, segment_ids))
        m_in = rms_norm(cfg, h, self.ln2.weight)
        return h + (checkpoint_block(mlp, cfg.remat_policy, m_in)
                    if remat_mlp else mlp(m_in))


class TransformerLM(nn.Module):
    """A Llama-family decoder: ``embed_tokens``,
    ``layers[i].{ln1, attn.{q,k,v,o}_proj, ln2, mlp.{gate,up,down}_proj}``,
    ``final_norm`` and ``lm_head`` (absent when ``tie_embeddings``).

    The weights are made on ``device``: the card when it is ``None``
    (raising where there is none), ``"meta"`` for a model whose weights
    are made later (``init_params``, ``Trainer.init``).  Their values are
    ``nn.Linear``'s default init; ``init_params`` gives the flax one.

    On a mesh (``parallel.sharding.shard_model``) the parameters are
    DTensors and ``tp_group``/``data_groups`` name the process groups of
    the 'tp' axis and of the data axes; the embedding and the head are
    then vocab-parallel."""

    # the 'tp' process group (None on one device) and the process groups
    # of the data axes above 1 (the quantized sites' amax reduce)
    tp_group = None
    data_groups = ()

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        factory = {"device": resolve_device(device),
                   "dtype": dtype or cfg.param_dtype}
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **factory)
        self.layers = nn.ModuleList(
            [Block(cfg, **factory) for _ in range(cfg.num_layers)])
        self.final_norm = RMSNorm(cfg.hidden_size, **factory)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False, **factory))

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                dropout_seed: Optional[int] = None,
                quant=None, quant_out=None,
                labels: Optional[torch.Tensor] = None):
        """``TransformerLM.__call__`` (:853): f32 logits ``[b, s, V]``, or
        with ``return_hidden`` the final-normed hidden in the compute
        dtype, or with ``labels`` the fused linear + CE head's
        ``(loss_sum, valid_count)`` (``ops/fused.py``; vocab-parallel
        under tensor parallelism), computed inside the forward so that a
        sharded head is read while FSDP2 holds it gathered.
        ``positions`` default to ``arange``; ``segment_ids`` mark packed
        documents.  Under ``cfg.remat`` each block (or, with
        ``remat_cls``, its attention and/or MLP) of the first
        ``remat_cnt`` layers (all when None) is a checkpoint region with
        the policy ``cfg.remat_policy``.

        ``dropout_seed``: attention dropout is on iff ``cfg.attn_dropout``
        is set and the caller gives a seed (a host int: train steps do,
        evaluation does not); one seed fans out to per-layer seeds.
        ``quant``: with ``cfg.quant`` on, the amax histories by site name
        (``TrainState.quant``, ``init_quant_state``); they are read, never
        changed.  ``quant_out``: a dict that receives each site's
        advanced history (a train step; the flax mutable collection);
        None reads the scales and records nothing (evaluation)."""
        cfg = self.cfg
        check_training_supported(cfg)
        scope = None
        if quant_site_names(cfg):
            if quant is None:
                raise ValueError(
                    "quant != 'none' but no amax histories were passed to "
                    "forward(): thread TrainState.quant through it "
                    "(init_quant_state(cfg) makes fresh ones)")
            scope = QuantScope(quant, quant_out, self.data_groups)
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        x = self._embed(input_ids)
        grad = torch.is_grad_enabled()
        sub = _sub_remat(cfg)
        drop = cfg.attn_dropout > 0.0 and dropout_seed is not None
        for i, layer in enumerate(self.layers):
            remat = grad and _remat_layer(cfg, i)
            kw = dict(dropout_seed=_layer_seed(dropout_seed, i) if drop
                      else None, quant=scope, name=f"layers.{i}",
                      sub_remat=remat and sub)
            if remat and not sub:
                x = checkpoint_block(functools.partial(layer, **kw),
                                     cfg.remat_policy, x, positions,
                                     segment_ids)
            else:
                x = layer(x, positions, segment_ids, **kw)
        if return_hidden or labels is not None:
            x = rms_norm(cfg, x, self.final_norm.weight)
        if labels is not None:
            w = to_local(head_weight(self)).t()
            if self.tp_group is None:
                return fused_linear_cross_entropy(
                    x, w, labels, logit_softcap=cfg.logit_softcap)
            return fused_linear_cross_entropy_tp(
                x, w, labels, group=self.tp_group,
                logit_softcap=cfg.logit_softcap)
        if return_hidden:
            return x
        if self.tp_group is not None:
            raise NotImplementedError(
                "full logits under tensor parallelism (the JAX package's "
                "replicated head) are not ported to torchacc_tpu_torch "
                "yet (ROADMAP.md A8b): pass labels for the vocab-parallel "
                "fused CE")
        logits = head_logits(cfg, self, x)
        if cfg.logit_softcap > 0.0:
            logits = torch.tanh(logits / cfg.logit_softcap) \
                * cfg.logit_softcap
        return logits

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The token embedding in the compute dtype; vocab-parallel under
        tensor parallelism: each rank looks up the ids of its rows (the
        rest read as zero) and the ranks sum."""
        if self.tp_group is None:
            return embed(self.cfg, self, ids)
        w = to_local(self.embed_tokens.weight)
        off = dist.get_rank(self.tp_group) * w.shape[0]
        mine = (ids >= off) & (ids < off + w.shape[0])
        x = F.embedding(torch.where(mine, ids - off, 0).long(), w)
        x = torch.where(mine[..., None], x, 0.0)
        return _tp_out(x, self.tp_group).to(self.cfg.dtype)


def set_model_config(model: nn.Module, cfg: ModelConfig) -> None:
    """Give ``model`` and every submodule holding a config ``cfg`` (the
    weights are untouched)."""
    for mod in model.modules():
        if isinstance(getattr(mod, "cfg", None), ModelConfig):
            mod.cfg = cfg


def head_weight(model: TransformerLM) -> torch.Tensor:
    """The vocab projection ``[V, h]``: the embedding when tied."""
    return (model.embed_tokens.weight if model.cfg.tie_embeddings
            else model.lm_head.weight)


def loss_sum_count(logits: torch.Tensor, labels: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross entropy (:1268): (sum over valid tokens, valid
    count); -100 labels are ignored."""
    valid = labels != -100
    if loss_mask is not None:
        valid = valid & (loss_mask != 0)
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    return (torch.where(valid, -ll, 0.0).sum(),
            valid.sum().to(torch.float32))


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy (:1289)."""
    total, count = loss_sum_count(logits, labels, loss_mask)
    return total / torch.clamp(count, min=1.0)


def head_logits(cfg: ModelConfig, model: TransformerLM,
                x: torch.Tensor) -> torch.Tensor:
    """Final norm -> vocab projection in the compute dtype -> f32 logits
    (``head_logits`` of the JAX package)."""
    xn = rms_norm(cfg, x, model.final_norm.weight)
    return F.linear(xn.to(cfg.dtype), head_weight(model).to(cfg.dtype)
                    ).float()


def materializer(seed: int, device: torch.device):
    """``make(module, prefix)``: gives the ``meta`` parameters of
    ``module`` (named ``prefix.<name>`` in the whole model) storage on
    ``device`` and the flax initialisers' values, drawn from one
    ``torch.Generator`` seeded with ``seed``: every matrix normal(0.02),
    norm scales one, biases zero.  Called on the model's submodules in
    the order of ``named_parameters``, it makes the weights
    ``init_params`` makes, one module at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    @torch.no_grad()
    def make(module: nn.Module, prefix: str = "") -> None:
        module.to_empty(device=device)
        for name, p in module.named_parameters(prefix=prefix):
            if name.endswith("ln1.weight") or name.endswith("ln2.weight") \
                    or name == "final_norm.weight":
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return make


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: Optional[torch.dtype] = None) -> TransformerLM:
    """A ``TransformerLM`` with random weights made on ``device`` (the
    card when ``None``) from a ``torch.Generator`` seeded with ``seed``
    (:func:`materializer`).  ``dtype`` defaults to ``cfg.param_dtype``;
    serving passes ``cfg.dtype``."""
    device = resolve_device(device)
    model = TransformerLM(cfg, device="meta", dtype=dtype)
    materializer(seed, device)(model)
    return model.requires_grad_(False).eval()
