"""Decoder-only transformer LM (the port of torchacc_tpu/models/
transformer.py, its dense forward).

``ModelConfig`` is a copy of the JAX package's config with torch dtypes:
every field is there, so a JAX config maps onto it field by field, but
the port implements the Llama family — rmsnorm, swiglu, RoPE
(``rope_theta``, ``rope_scale`` and Llama-3.1's ``rope_llama3``
banding), GQA, ``qkv_bias``, ``o_bias``, ``mlp_bias``,
``tie_embeddings`` and ``attn_logit_softcap`` — what the Gemma,
Mistral and Qwen3 families add: ``norm='rmsnorm1p'`` (scale 1 + w),
``activation='geglu'``, ``embed_scale``, per-head ``qk_norm`` and the
final ``logit_softcap``, and in training and ``generate`` also
``sandwich_norms``, a uniform ``window`` and ``layer_pattern`` with
``rope_local_theta`` (``pattern_cfg``) — and what the GPT-2, GPT-NeoX,
Phi, StarCoder2 and Nemotron families add: ``norm`` 'layernorm' and
'layernorm1p' with ``norm_bias``, the non-gated MLPs (``activation``
'gelu', 'gelu_exact', 'relu2'), ``partial_rotary``, learned positions
(``pos_emb='learned'``, the ``pos_embed`` table) and ALiBi
(``pos_emb='alibi'``), and in training and ``generate`` also the
parallel residual (``parallel_block``, ``parallel_block_shared_norm``)
and ``head_bias`` — and what Phi-3, Cohere, OLMo2 and Qwen's long-context
variants add: ``rope_longrope`` (its switch over the whole global batch,
``rope_pos_max``), ``rope_yarn``, ``rope_interleaved``, ``logit_scale``
(``scale_hidden``, on every head path) and ``qk_norm_proj`` (the flat
qk-norm, its statistics summed over the 'tp' ranks), and in training
and ``generate`` also ``norm_placement='post'`` — and in training and
``generate`` the mixtures of experts (``num_experts`` > 0: the block's
``moe``, models/moe.py, in place of its ``mlp``; Mixtral, Qwen3-MoE),
whose router losses the forward sums over the layers and returns
beside its output (``with_aux``).  The training forward adds
attention dropout (``attn_dropout``) and quantized forward matmuls
(``quant``, ``quant_sites`` 'attn', 'mlp' and 'head': the materialised
head's ``lm_head``, ``quant_amax_history_len``, ``quant_impl``).  The serving forward (serve/scheduler.py) and the
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
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from torchacc_tpu_torch.models.generate import embed, embed_extras
from torchacc_tpu_torch.ops._common import resolve_device, to_local
from torchacc_tpu_torch.ops.attn import attention
from torchacc_tpu_torch.ops.context_parallel import cp_attention
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
        if self.activation in GATED:
            return ((8 * self.hidden_size // 3) + 255) // 256 * 256
        return 4 * self.hidden_size

    def num_params(self) -> int:
        """Every parameter of the model this config makes (``num_params``
        of the JAX package, :232, for MFU): the position table, the
        q/k/v/o/MLP and head biases, the norms' scales and biases, the
        qk and sandwich norms, one norm a block fewer under a shared
        parallel-block norm."""
        h, v = self.hidden_size, self.vocab_size
        d = self.head_size
        emb = v * h + (self.max_seq_len * h if self.pos_emb == "learned"
                       else 0)
        attn = h * (self.num_heads * d) + h * (2 * self.kv_heads * d) \
            + (self.num_heads * d) * h
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.kv_heads) * d
        if self.o_bias:
            attn += h
        if self.qk_norm:
            attn += ((self.num_heads + self.kv_heads) * d
                     if self.qk_norm_proj else 2 * d)
        n_mats = 3 if self.activation in GATED else 2
        mlp = n_mats * h * self.ffn_size
        if self.mlp_bias:
            mlp += (n_mats - 1) * self.ffn_size + h
        if self.num_experts > 0:
            mlp = mlp * self.num_experts + h * self.num_experts
        norm_size = 2 * h if norm_has_bias(self) else h
        per_block = (1 if self.parallel_block
                     and self.parallel_block_shared_norm
                     else (4 if self.sandwich_norms else 2))
        norms = (per_block * self.num_layers + 1) * norm_size
        out = 0 if self.tie_embeddings else v * h
        if self.head_bias:
            out += v
        return emb + self.num_layers * (attn + mlp) + norms + out


# the gated MLPs (gate_proj, up_proj, down_proj); the others have no gate
GATED = ("swiglu", "geglu")
_LAYERNORMS = ("layernorm", "layernorm1p")


def norm_has_bias(cfg: ModelConfig) -> bool:
    """A LayerNorm carries a bias unless ``norm_bias`` is off (Cohere);
    an RMSNorm never does."""
    return cfg.norm in _LAYERNORMS and cfg.norm_bias


def norm(cfg: ModelConfig, x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Norm`` (:399): 'rmsnorm', or 'layernorm' (the mean taken out,
    then the variance about it), the stored w scaling by 1 + w under
    'rmsnorm1p' (Gemma) and 'layernorm1p' (Nemotron), and a LayerNorm's
    ``bias`` added after the scale; the statistics and the affine in
    f32, cast back to the compute dtype."""
    xf = x.float()
    if cfg.norm in _LAYERNORMS:
        xf = xf - xf.mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True)
                         + cfg.norm_eps)
    scale = to_local(weight).float()
    if cfg.norm in ("rmsnorm1p", "layernorm1p"):
        scale = 1.0 + scale
    y = y * scale
    if bias is not None:
        y = y + to_local(bias).float()
    return y.to(cfg.dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor,
               mod: "Norm") -> torch.Tensor:
    """:func:`norm` with the scale and bias of the module ``mod``."""
    return norm(cfg, x, mod.weight, mod.bias)


def pattern_cfg(cfg: ModelConfig, i: int) -> ModelConfig:
    """The config of layer ``i`` under ``cfg.layer_pattern``
    (``pattern_cfg`` of the JAX package, :1308): the layer takes
    ``pattern[i % len]``; 'sliding' keeps ``cfg.window`` and, with
    ``rope_local_theta``, takes that base unscaled (Gemma3's local
    rope), 'global' lifts the window.  ``cfg`` itself without a
    pattern."""
    if not cfg.layer_pattern:
        return cfg
    kind = cfg.layer_pattern[i % len(cfg.layer_pattern)]
    if kind == "sliding":
        if cfg.rope_local_theta is not None:
            return dataclasses.replace(cfg, rope_theta=cfg.rope_local_theta,
                                       rope_scale=1.0)
        return cfg
    if kind == "global":
        return dataclasses.replace(cfg, window=(-1, -1))
    raise ValueError(f"layer_pattern entries must be 'sliding' | 'global', "
                     f"got {kind!r}")


def mlp_act(cfg: ModelConfig, up: torch.Tensor,
            gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MLP's hidden (``Mlp`` :684): gated, SiLU(gate) * up, or under
    'geglu' flax's ``nn.gelu`` (the tanh approximation, HF's
    gelu_pytorch_tanh) of the gate; non-gated, 'gelu' (the same tanh
    approximation, GPT-2's gelu_new), 'gelu_exact' (erf, GPT-NeoX) or
    'relu2' (the square of relu, Nemotron) of ``up``."""
    act = cfg.activation
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if act == "gelu":
        return F.gelu(up, approximate="tanh")
    if act == "gelu_exact":
        return F.gelu(up)
    if act == "relu2":
        return torch.square(F.relu(up))
    raise ValueError(f"activation {act!r}")


def mlp_out(cfg: ModelConfig, mlp: "Mlp", x: torch.Tensor) -> torch.Tensor:
    """The MLP of one block on ``x`` without remat names or quantized
    sites (``generate``'s and serving's cached forwards)."""
    gate = (dense(cfg, x, mlp.gate_proj) if cfg.activation in GATED
            else None)
    return dense(cfg, mlp_act(cfg, dense(cfg, x, mlp.up_proj), gate),
                 mlp.down_proj)


def block_mlp(cfg: ModelConfig, layer: "Block",
              x: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_out` of the block ``layer``, or its mixture of experts'
    output (its router loss dropped; under capacity dispatch the cap of
    ``x``'s own tokens, as JAX's cached forward has it)."""
    if cfg.num_experts > 0:
        return layer.moe(x)[0]
    return mlp_out(cfg, layer.mlp, x)


def alibi_slopes(num_heads: int) -> Tuple[float, ...]:
    """The ALiBi slopes of ``num_heads`` heads (``alibi_slopes`` :433):
    geometric 2^(-8i/n), with the paper's interpolation where n is not a
    power of two."""
    def pow2(n):
        start = 2.0 ** (-8.0 / n)
        return [start ** (i + 1) for i in range(n)]

    if math.log2(num_heads).is_integer():
        return tuple(pow2(num_heads))
    m = 2 ** math.floor(math.log2(num_heads))
    return tuple(pow2(m) + pow2(2 * m)[0::2][:num_heads - m])


def qk_rope(cfg: ModelConfig, attn: "Attention", q: torch.Tensor,
            k: torch.Tensor, positions: torch.Tensor,
            pos_max: Optional[torch.Tensor] = None,
            tp_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k ``[b, s, heads, d]`` after the qk norms (by ``cfg.norm``,
    before RoPE: per head under ``qk_norm`` (Gemma3, Qwen3), over the
    flat ``heads * d`` projection under ``qk_norm_proj`` (OLMo2; its
    statistics summed over the 'tp' ranks of ``tp_group``, which hold
    the other heads) and, under ``pos_emb='rope'``, RoPE at
    ``positions`` (divided by ``rope_scale`` when it is not 1).
    ``pos_max`` is the largest position of the whole batch (longrope's
    switch, taken over the data and sequence ranks on a mesh); the
    largest of ``positions`` when None.  ``cfg`` is the layer's
    (``pattern_cfg``)."""
    if cfg.qk_norm and cfg.qk_norm_proj:
        q = flat_norm(cfg, q, attn.q_norm, tp_group)
        k = flat_norm(cfg, k, attn.k_norm, tp_group)
    elif cfg.qk_norm:
        q = apply_norm(cfg, q, attn.q_norm)
        k = apply_norm(cfg, k, attn.k_norm)
    if cfg.pos_emb != "rope":
        return q, k
    scaled = lambda p: (p.float() / cfg.rope_scale if cfg.rope_scale != 1.0
                        else p)
    rp = scaled(positions)
    return rope(q, k, rp, cfg,
                None if pos_max is None else scaled(pos_max))


def flat_norm(cfg: ModelConfig, x: torch.Tensor, mod: "Norm",
              tp_group=None) -> torch.Tensor:
    """``cfg.norm`` of ``x [b, s, heads, d]`` over its flat ``heads * d``
    (OLMo2's qk-norm, JAX :507-516) with the scale of ``mod`` (``[all
    heads * d]``).  Under tensor parallelism ``x`` holds this rank's
    heads: the sums behind the mean and the variance are summed over
    the 'tp' ranks (forward and backward, :class:`_TPSumBoth`) and the
    rank's slice of the replicated scale is read, its gradient summed
    over the ranks (``_tp_in``)."""
    b, s = x.shape[:2]
    flat = x.reshape(b, s, -1)
    if tp_group is None:
        return apply_norm(cfg, flat, mod).view_as(x)
    n = flat.shape[-1]
    total = n * dist.get_world_size(tp_group)
    lo = dist.get_rank(tp_group) * n
    xf = flat.float()
    if cfg.norm in _LAYERNORMS:
        xf = xf - _TPSumBoth.apply(xf.sum(-1, keepdim=True), tp_group) / total
    ms = _TPSumBoth.apply(xf.pow(2).sum(-1, keepdim=True), tp_group) / total
    y = xf * torch.rsqrt(ms + cfg.norm_eps)
    scale = _tp_in(to_local(mod.weight), tp_group)[lo:lo + n].float()
    if cfg.norm in ("rmsnorm1p", "layernorm1p"):
        scale = 1.0 + scale
    y = y * scale
    if mod.bias is not None:
        y = y + _tp_in(to_local(mod.bias), tp_group)[lo:lo + n].float()
    return y.to(cfg.dtype).view_as(x)


def rope_pos_max(positions: torch.Tensor, groups=()) -> torch.Tensor:
    """The largest position of ``positions`` and of every rank of the
    process ``groups`` (a mesh's data and sequence ranks), as JAX's
    ``jnp.max`` over the whole global batch reads it (:364)."""
    m = positions.detach().max().float()
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    return m


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig, pos_max: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_rope`` (:290): angles in f32, outputs cast back to the inputs'
    dtype.  ``positions`` [S, T] (already divided by ``rope_scale`` by
    the caller when it is not 1).  The frequency chain, in JAX's order:

    - ``partial_rotary`` < 1: only the first ``int(d * partial_rotary)``
      dims rotate (their own frequencies) and the rest pass through
      (Phi, GPT-NeoX's ``rotary_pct``, Nemotron, Phi-4-mini);
    - ``rope_llama3``: Llama-3.1's banding, long wavelengths divided by
      ``factor``, short ones kept, the band between interpolated;
    - ``rope_yarn`` ``(factor, original, beta_fast, beta_slow,
      attention_factor, truncate)``: YaRN's NTK-by-parts, a linear ramp
      between the correction dims of the two betas (floored and ceiled
      under ``truncate``, HF's guard where they meet) from the original
      frequencies to those divided by ``factor``; cos and sin scaled by
      the attention factor, 0.1 ln(factor) + 1 when it is None;
    - ``rope_longrope`` ``(short, long, original, attention_factor)``:
      the frequencies divided per dim by the long factors where the
      largest position (``pos_max``, else that of ``positions``) + 1
      exceeds the original context, else by the short ones (a select on
      the device, no host read); cos and sin scaled by the attention
      factor (JAX's default from ``max_seq_len`` when None).

    Pairs rotate half-split (Llama), or under ``rope_interleaved``
    (Cohere) as (even, odd) dims, the interleaving restored after."""
    d = q.shape[-1]
    rot_d = int(d * cfg.partial_rotary)
    theta = cfg.rope_theta
    dev = q.device
    freqs = 1.0 / (theta ** (
        torch.arange(0, rot_d, 2, dtype=torch.float32, device=dev) / rot_d))
    scale = None
    if cfg.rope_llama3 is not None:
        factor, lo, hi, old_len = cfg.rope_llama3
        wavelen = 2.0 * math.pi / freqs
        low_wl, high_wl = old_len / lo, old_len / hi
        smooth = (old_len / wavelen - lo) / (hi - lo)
        scaled = torch.where(wavelen > low_wl, freqs / factor, freqs)
        smoothed = ((1.0 - smooth) / factor + smooth) * freqs
        freqs = torch.where((wavelen >= high_wl) & (wavelen <= low_wl),
                            smoothed, scaled)
    if cfg.rope_yarn is not None:
        factor, old_len, bfast, bslow, attn_f, truncate = cfg.rope_yarn

        def corr_dim(beta):
            return (rot_d * math.log(old_len / (beta * 2 * math.pi))
                    / (2 * math.log(theta)))

        low, high = corr_dim(bfast), corr_dim(bslow)
        if truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, rot_d - 1)
        if low == high:
            high += 0.001               # HF's guard
        ramp = torch.clamp(
            (torch.arange(rot_d // 2, dtype=torch.float32, device=dev)
             - low) / (high - low), 0.0, 1.0)
        mask = 1.0 - ramp               # 1 keeps the original frequency
        freqs = (freqs / factor) * (1.0 - mask) + freqs * mask
        if attn_f is None:
            attn_f = (1.0 if factor <= 1.0
                      else 0.1 * math.log(factor) + 1.0)
        scale = attn_f
    if cfg.rope_longrope is not None:
        short_f, long_f, old_len, attn_f = cfg.rope_longrope
        short = freqs / torch.tensor(short_f, dtype=torch.float32,
                                     device=dev)
        long = freqs / torch.tensor(long_f, dtype=torch.float32, device=dev)
        top = (positions.detach().max() if pos_max is None else pos_max)
        freqs = torch.where(top.float() + 1 > old_len, long, short)
        if attn_f is None:
            s = cfg.max_seq_len / old_len
            attn_f = (1.0 if s <= 1.0
                      else math.sqrt(1.0 + math.log(s) / math.log(old_len)))
        scale = attn_f
    angles = positions[..., None].float() * freqs            # [S, T, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scale is not None:
        f = torch.tensor(scale, dtype=torch.float32, device=dev)
        cos, sin = cos * f, sin * f
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    def rot(x):
        xf = x.float()
        xr = xf[..., :rot_d]
        if cfg.rope_interleaved:
            x1, x2 = xr[..., 0::2], xr[..., 1::2]
            out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(xr.shape)
        else:
            x1, x2 = xr.chunk(2, dim=-1)
            out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                            dim=-1)
        if rot_d < x.shape[-1]:
            out = torch.cat([out, xf[..., rot_d:]], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


class Norm(nn.Module):
    """A norm's scale, initialised to ``fill``: one, or zero for
    rmsnorm1p and layernorm1p, whose stored w scales by 1 + w (flax's
    zeros init); and a LayerNorm's ``bias`` (zero; None without one).
    Applied by :func:`apply_norm`."""

    def __init__(self, cfg: ModelConfig, size: int, **factory):
        super().__init__()
        self.fill = 0.0 if cfg.norm in ("rmsnorm1p", "layernorm1p") else 1.0
        self.weight = nn.Parameter(torch.full((size,), self.fill, **factory))
        self.bias = (nn.Parameter(torch.zeros((size,), **factory))
                     if norm_has_bias(cfg) else None)


# ModelConfig fields of the Llama family and of what Gemma v1, Qwen3,
# the LayerNorm families, Phi-3, Cohere, OLMo2 and YaRN add, which the
# serving and the training forward implement (``norm``, ``activation``,
# ``pos_emb`` and ``norm_placement`` for the values of MODEL_VALUES;
# serving refuses ``parallel_block``, post-norms and ALiBi as JAX's
# does)
MODEL_FIELDS = frozenset({
    "vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
    "head_dim", "intermediate_size", "max_seq_len", "rope_theta",
    "rope_scale", "rope_llama3", "norm_eps", "qkv_bias", "o_bias",
    "mlp_bias", "tie_embeddings", "attn_logit_softcap", "query_scale",
    "dtype", "param_dtype", "norm", "activation", "embed_scale",
    "logit_softcap", "qk_norm", "pos_emb", "norm_bias", "partial_rotary",
    "parallel_block", "parallel_block_shared_norm", "head_bias",
    "rope_interleaved", "logit_scale", "rope_longrope", "rope_yarn",
    "norm_placement", "qk_norm_proj",
})
MODEL_VALUES = {"norm": ("rmsnorm", "rmsnorm1p", "layernorm",
                         "layernorm1p"),
                "activation": ("swiglu", "geglu", "gelu", "gelu_exact",
                               "relu2"),
                "pos_emb": ("rope", "learned", "alibi"),
                "norm_placement": ("pre", "post")}
# what those fields are, for the messages that reject the others
MODEL_SURFACE = ("rmsnorm, rmsnorm1p, layernorm and layernorm1p (with "
                 "norm_bias), pre- and post-norm placement, swiglu, geglu, "
                 "gelu, gelu_exact and relu2, RoPE (plain, partial, "
                 "interleaved; linear, llama3, yarn and longrope scaling), "
                 "learned positions and ALiBi, GQA, qkv/o/mlp/head "
                 "biases, the parallel block, tie_embeddings, embed_scale, "
                 "per-head and flat qk_norm, attn_logit_softcap, "
                 "logit_softcap and logit_scale")
# the fields the port leaves out name this ROADMAP item: overlap_fsdp
# (JAX's in-model KV cache, decode, is models/generate.py here)
MODEL_PENDING = "ROADMAP.md A8b"
# the mixture-of-experts fields (models/moe.py); moe_dispatch picks a
# mechanism of JAX's that gives the same values as its other, so it
# changes nothing the port computes (PARITY.md)
MOE_FIELDS = ("num_experts", "num_experts_per_tok", "router_aux_weight",
              "moe_renorm_topk", "moe_capacity_factor")
# the training forward also implements Gemma2/3's sandwich norms, the
# sliding window and the sliding/global layer pattern with its local
# rope base, the mixtures of experts; remat (its policy, the submodules and the number of layers
# it covers), the attention choice, attention dropout and the quantized
# matmuls; every other field must keep its default
_TRAIN_FIELDS = MODEL_FIELDS | {
    "sandwich_norms", "window", "layer_pattern", "rope_local_theta",
    "remat", "remat_policy", "remat_cls", "remat_cnt", "attention_impl",
    "attn_dropout", "quant", "quant_sites", "quant_amax_history_len",
    "quant_impl", "context_parallel", "pp_size", "pp_num_micro",
    "pp_virtual"} | set(MOE_FIELDS)
# fields that pick how the JAX package lays out or shards the step, or
# knobs inert while their feature is off; none changes what one device
# computes
_TRAIN_INERT = frozenset({
    "scan_layers", "cache_len", "logical_axis_rules",
    "tp_vocab_head", "moe_dispatch",
})


def unsupported_fields(cfg: ModelConfig, fields, inert) -> list:
    """``name=value`` of every field of ``cfg`` outside ``fields`` and
    ``inert`` that is not at its default, and of ``norm``/``activation``
    at a value outside MODEL_VALUES."""
    bad = [f"{f.name}={getattr(cfg, f.name)!r}"
           for f in dataclasses.fields(cfg)
           if f.name not in fields and f.name not in inert
           and getattr(cfg, f.name) != f.default]
    return bad + [f"{name}={getattr(cfg, name)!r}"
                  for name, ok in MODEL_VALUES.items()
                  if getattr(cfg, name) not in ok]


def check_composition(cfg: ModelConfig) -> None:
    """The compositions JAX's forward refuses, with its messages:
    post-norms with sandwich norms (``Block`` :741), the parallel block
    with post-norms or sandwich norms (:749) and a head bias on a tied
    head (:1242)."""
    if cfg.norm_placement == "post" and cfg.sandwich_norms:
        raise ValueError("norm_placement='post' (OLMo2) does not "
                         "compose with sandwich_norms (gemma2)")
    if cfg.parallel_block and (cfg.norm_placement == "post"
                               or cfg.sandwich_norms):
        raise ValueError("parallel_block (phi) does not compose "
                         "with norm_placement='post' or "
                         "sandwich_norms")
    if cfg.head_bias and cfg.tie_embeddings:
        raise ValueError(
            "head_bias does not compose with tie_embeddings "
            "(the tied head has no bias parameter)")


def check_training_supported(cfg: ModelConfig) -> None:
    """Raise naming every field the training forward of this port does
    not implement, and the compositions JAX rejects: those of
    :func:`check_composition`, the 'head' quant site on a tied head (JAX
    :1244), a layer pattern with quantized matmuls (JAX :929) or with
    ``overlap_fsdp`` (:953), and under pipeline parallelism a pattern period that does not divide a stage chunk
    (``pp_block_appliers``)."""
    check_composition(cfg)
    if cfg.tie_embeddings and quant_site_on(cfg, "head"):
        raise ValueError(
            "quant_sites includes 'head' but tie_embeddings "
            "projects through the embedding table — drop "
            "'head' from quant_sites (the tied head stays in "
            "the compute dtype)")
    if cfg.layer_pattern:
        if cfg.quant != "none":
            raise NotImplementedError(
                "quant != 'none' does not compose with layer_pattern "
                "models yet")
        if cfg.overlap_fsdp:
            raise NotImplementedError(
                "perf.overlap_fsdp does not compose with layer_pattern "
                "models (the pattern's per-layer loop does not take the "
                "overlap path) — disable one of the two")
    if cfg.pp_size > 1:
        pp_block_appliers(cfg)
    bad = unsupported_fields(cfg, _TRAIN_FIELDS, _TRAIN_INERT)
    if bad:
        raise NotImplementedError(
            "the training forward of torchacc_tpu_torch does not support "
            + ", ".join(bad) + f" (it implements {MODEL_SURFACE}; the "
            f"rest waits for {MODEL_PENDING})")


_M32 = 0xFFFFFFFF


def _layer_seed(dropout_seed: int, layer_idx: int) -> int:
    """Decorrelate dropout across layers: mix the layer index into the
    seed on uint32 arithmetic (``_layer_seed`` of the JAX package)."""
    return ((int(dropout_seed) & _M32) + layer_idx * 0x9E3779B9) & _M32


def _micro_seed(base: int, micro_idx: int) -> int:
    """Decorrelate dropout across pipeline micro-batches under 1F1B
    (``_micro_seed`` of the JAX package, :1347): another odd constant
    than :func:`_layer_seed`'s, on uint32 arithmetic."""
    return ((int(base) & _M32) + micro_idx * 0x85EBCA6B) & _M32


def quant_site_on(cfg: ModelConfig, site: str) -> bool:
    """Whether a dense ``site`` ('attn' | 'mlp' | 'head') runs the
    quantized matmul.  Decode always runs the plain dense; the parameter
    layouts are the same either way, so this only picks execution."""
    return (cfg.quant != "none" and site in cfg.quant_sites
            and not cfg.decode)


def mlp_linears(cfg: ModelConfig) -> Tuple[str, ...]:
    """The MLP's projections: a gated MLP's three, else up and down."""
    return (("gate_proj",) if cfg.activation in GATED else ()) \
        + ("up_proj", "down_proj")


def quant_site_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The name of every quantized matmul site of ``cfg``, in forward
    order: ``layers.<i>.<attn|mlp>.<linear>`` (the module's path), then
    ``lm_head`` where the 'head' site quantizes the materialised vocab
    projection (a tied head has no ``lm_head``: JAX refuses it,
    :func:`check_training_supported`)."""
    sites = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
             # the experts are never quantized (JAX's einsums)
             "mlp": mlp_linears(cfg) if cfg.num_experts == 0 else ()}
    head = (("lm_head",) if quant_site_on(cfg, "head")
            and not cfg.tie_embeddings else ())
    return tuple(f"layers.{i}.{site}.{lin}"
                 for i in range(cfg.num_layers)
                 for site, lins in sites.items()
                 if quant_site_on(cfg, site) for lin in lins) + head


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
               lin: nn.Linear, bias: bool = True,
               k_group=None) -> torch.Tensor:
        """The quantized product of the site ``name``; ``k_group``: the
        'tp' group of a row-parallel site, whose contracting dim is split
        over it (``quant_linear``)."""
        if name not in self.histories:
            raise KeyError(
                f"no amax history for the quantized site {name!r}: pass "
                f"the TrainState.quant of this model config")
        y, hist = quant_linear(
            x, to_local(lin.weight), to_local(lin.bias) if bias else None,
            self.histories[name], fmt=cfg.quant,
            impl=cfg.quant_impl, dtype=cfg.dtype,
            update=self.new is not None, amax_groups=self.amax_groups,
            k_group=k_group)
        if self.new is not None:
            self.new[name] = hist
        return y


def dense(cfg: ModelConfig, x: torch.Tensor, lin: nn.Linear,
          quant: Optional[QuantScope] = None,
          name: Optional[str] = None, bias: bool = True,
          k_group=None) -> torch.Tensor:
    """A projection with both operands in the compute dtype (flax
    ``Dense(dtype=cfg.dtype)``); ``.to`` is free when the weight already
    is (the bf16 shadow).  With ``quant`` the product is the quantized
    one of the site ``name`` (``_quant_dense`` of the JAX package); the
    bias is added after it, in the compute dtype.  Under 'offload_dots'
    the product of an offloaded site goes through
    ``utils.remat.offload_product``.  A tensor-parallel weight (a
    ``DTensor``) is read as this rank's shard: the product is this
    rank's heads or MLP columns (column-parallel), or its partial sum
    (row-parallel, which the caller reduces and then adds the bias to:
    ``bias=False`` leaves it out here, and ``k_group`` names the 'tp'
    group for the quantized scales, see :func:`row_parallel`)."""
    dt = cfg.dtype
    operands = lambda: (x.to(dt), to_local(lin.weight).to(dt))
    if quant is not None:
        return offload_product(
            operands, lambda: quant.linear(cfg, name, x, lin, bias, k_group))
    y = offload_product(operands, lambda: F.linear(*operands()))
    if bias and lin.bias is not None:
        y = y + to_local(lin.bias).to(dt)
    return y


def row_parallel(cfg: ModelConfig, x: torch.Tensor, lin: nn.Linear,
                 group, quant: Optional[QuantScope] = None,
                 name: Optional[str] = None) -> torch.Tensor:
    """An output projection (o_proj, down_proj): under tensor
    parallelism each rank's partial product is summed over the 'tp'
    ranks and the bias, replicated, is added once after the sum.  A
    quantized site takes its scales over the whole contracting dim,
    all-reduced over the 'tp' group (``quant_linear``'s ``k_group``)."""
    if group is None:
        return dense(cfg, x, lin, quant, name)
    y = _tp_out(dense(cfg, x, lin, quant, name, bias=False, k_group=group),
                group)
    if lin.bias is not None:
        y = y + to_local(lin.bias).to(cfg.dtype)
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


class _TPSumBoth(torch.autograd.Function):
    """A sum over the 'tp' ranks whose every rank reads the result for
    its own heads only (the flat qk-norm's statistics): the forward sums
    the ranks' parts, and so does the backward, each rank's gradient
    holding only its heads' share."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _tp_in(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _TPCopy.apply(x, group)


def _tp_out(y: torch.Tensor, group) -> torch.Tensor:
    return y if group is None else _TPSum.apply(y, group)


class Attention(nn.Module):
    # the 'tp' process group (parallel/sharding.py shard_model): the
    # projections hold this rank's heads; None on one device
    tp_group = None
    # this rank's place on the mesh (ops/context_parallel CPLayout): the
    # sequence groups and chunk, the batch and head offsets; None on one
    # device
    layout = None

    def __init__(self, cfg: ModelConfig, layer: int = 0, **factory):
        super().__init__()
        self.cfg = cfg
        self.layer = layer          # its index: the layer pattern's slot
        h, d = cfg.hidden_size, cfg.head_size
        if cfg.qk_norm:
            # per head (d), or over the flat projection (OLMo2)
            flat = cfg.qk_norm_proj
            self.q_norm = Norm(cfg, cfg.num_heads * d if flat else d,
                               **factory)
            self.k_norm = Norm(cfg, cfg.kv_heads * d if flat else d,
                               **factory)
        self.q_proj = nn.Linear(h, cfg.num_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.k_proj = nn.Linear(h, cfg.kv_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.v_proj = nn.Linear(h, cfg.kv_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.o_proj = nn.Linear(cfg.num_heads * d, h, bias=cfg.o_bias,
                                **factory)

    def forward(self, x, positions, segment_ids=None, dropout_seed=None,
                quant=None, name="attn", pos_max=None):
        """``Attention.__call__`` (:480) without the KV cache: q/k/v
        projections, the qk norms, RoPE (longrope's switch at
        ``pos_max``, the batch's largest position) (or ALiBi's slopes:
        this rank's heads' under tensor parallelism), causal attention
        over ``segment_ids``, o projection, each with this layer's
        config (``pattern_cfg``: its window and rope base).  The
        ``checkpoint_name`` sites are the JAX package's names for the
        selective remat policies.  ``dropout_seed`` (this
        layer's) turns attention dropout on when ``cfg.attn_dropout`` is
        set; ``quant`` is the forward's :class:`QuantScope` and ``name``
        this module's path, which prefixes its sites' names.  Under
        tensor parallelism the heads are this rank's (``num_heads / tp``
        and ``kv_heads / tp``; the GQA group is unchanged).  On a mesh
        attention goes through ``cp_attention`` with this rank's
        ``layout`` (JAX :629-644): the ring and Ulysses under
        ``context_parallel``, x and ``positions`` then being this rank's
        chunk of the sequence, and on any mesh the global batch and head
        offsets, so that dropout draws the one-device masks."""
        cfg = pattern_cfg(self.cfg, self.layer)
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
        q, k = qk_rope(cfg, self, q, k, positions, pos_max, self.tp_group)
        dropout_p, seed = 0.0, None
        if cfg.attn_dropout > 0.0 and dropout_seed is not None:
            dropout_p, seed = cfg.attn_dropout, dropout_seed
        kw = dict(causal=True, window=cfg.window, scale=cfg.query_scale,
                  q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                  alibi_slopes=layer_slopes(cfg, q, self.layout),
                  dropout_p=dropout_p, dropout_seed=seed,
                  logit_softcap=cfg.attn_logit_softcap,
                  impl=cfg.attention_impl)
        out = (attention(q, k, v, **kw) if self.layout is None
               else cp_attention(q, k, v, mesh=self.layout, **kw))
        with checkpoint_name("attn_out"):
            # the JAX o_proj contracts (heads, d); flattened it is the
            # same [M, K] @ [K, N]
            return row_parallel(cfg, out.reshape(b, s, -1), self.o_proj,
                                self.tp_group, qs, f"{name}.o_proj")


def layer_slopes(cfg: ModelConfig, q: torch.Tensor,
                 layout=None) -> Optional[torch.Tensor]:
    """Under ``pos_emb='alibi'`` the f32 slopes of the heads of ``q``
    ``[b, s, heads, d]``: all of them on one device, this rank's slice
    under tensor parallelism (``layout``'s head offset); else None."""
    if cfg.pos_emb != "alibi":
        return None
    h = q.shape[2]
    off = 0 if layout is None else layout.h_offset(h)
    return torch.tensor(alibi_slopes(cfg.num_heads)[off:off + h],
                        dtype=torch.float32, device=q.device)


class Mlp(nn.Module):
    # the 'tp' process group: gate/up hold this rank's columns, down the
    # matching rows; None on one device
    tp_group = None

    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.ffn_size
        if cfg.activation in GATED:
            self.gate_proj = nn.Linear(h, f, bias=cfg.mlp_bias, **factory)
        self.up_proj = nn.Linear(h, f, bias=cfg.mlp_bias, **factory)
        self.down_proj = nn.Linear(f, h, bias=cfg.mlp_bias, **factory)

    def forward(self, x, quant=None, name="mlp"):
        """``Mlp.__call__`` (:684): SwiGLU or GeGLU, or a non-gated MLP
        (up, then gelu, exact gelu or relu2) with no ``gate_proj``."""
        cfg = self.cfg
        qs = quant if quant_site_on(cfg, "mlp") else None
        x = _tp_in(x, self.tp_group)
        with checkpoint_name("mlp_gate_up"):
            gate = (dense(cfg, x, self.gate_proj, qs, f"{name}.gate_proj")
                    if cfg.activation in GATED else None)
            up = dense(cfg, x, self.up_proj, qs, f"{name}.up_proj")
        with checkpoint_name("mlp_out"):
            return row_parallel(cfg, mlp_act(cfg, up, gate), self.down_proj,
                                self.tp_group, qs, f"{name}.down_proj")


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


def has_ln2(cfg: ModelConfig) -> bool:
    """A block has its MLP norm ``ln2`` unless it is a parallel block
    sharing ``ln1`` (Phi; GPT-NeoX's keeps its own)."""
    return not (cfg.parallel_block and cfg.parallel_block_shared_norm)


def post_norm(cfg: ModelConfig) -> bool:
    """OLMo2's placement: ``ln1``/``ln2`` norm the attention's and the
    MLP's outputs, and nothing norms their inputs."""
    return cfg.norm_placement == "post"


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: int = 0, **factory):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, cfg.hidden_size, **factory)
        self.attn = Attention(cfg, layer, **factory)
        if has_ln2(cfg):
            self.ln2 = Norm(cfg, cfg.hidden_size, **factory)
        if cfg.num_experts > 0:
            from torchacc_tpu_torch.models.moe import MoEMlp
            self.moe = MoEMlp(cfg, **factory)
        else:
            self.mlp = Mlp(cfg, **factory)
        if cfg.sandwich_norms:
            self.ln1_post = Norm(cfg, cfg.hidden_size, **factory)
            self.ln2_post = Norm(cfg, cfg.hidden_size, **factory)

    def forward(self, x, positions, segment_ids=None, dropout_seed=None,
                quant=None, name="block", sub_remat=False, pos_max=None):
        """Pre-norm ``Block.__call__`` (:722), with Gemma2's
        post-attention and post-MLP norms under ``sandwich_norms``, or
        under ``parallel_block`` the parallel residual ``x + attn(ln1(x))
        + mlp(ln1(x))`` (Phi; ``ln2(x)`` for the MLP without
        ``parallel_block_shared_norm``, GPT-NeoX), or under
        ``norm_placement='post'`` (OLMo2) ``x + ln(f(x))`` for each
        sublayer with no pre-norm.  ``sub_remat``: the attention and/or
        MLP named by ``cfg.remat_cls`` are checkpoint regions under
        ``cfg.remat_policy`` (the block itself is not); a mixture of
        experts' ``moe`` is one where ``remat_cls`` names 'MoEMlp' or
        'Mlp' (JAX :738).  ``pos_max``: the batch's largest position
        (longrope).  A mixture of experts' block returns ``(x, aux)``,
        its router's load-balancing loss beside the output."""
        cfg = self.cfg
        moe = cfg.num_experts > 0
        remat_attn = sub_remat and "Attention" in cfg.remat_cls
        remat_mlp = sub_remat and ("Mlp" in cfg.remat_cls or (
            moe and "MoEMlp" in cfg.remat_cls))
        attn = functools.partial(self.attn, dropout_seed=dropout_seed,
                                 quant=quant, name=f"{name}.attn",
                                 pos_max=pos_max)
        mlp = (self.moe if moe else
               functools.partial(self.mlp, quant=quant, name=f"{name}.mlp"))
        post = post_norm(cfg)
        a_in = x if post else apply_norm(cfg, x, self.ln1)
        a = (checkpoint_block(attn, cfg.remat_policy, a_in, positions,
                              segment_ids) if remat_attn
             else attn(a_in, positions, segment_ids))
        if cfg.parallel_block:
            m_in = a_in if not has_ln2(cfg) else apply_norm(cfg, x, self.ln2)
            h = x + a
        else:
            if cfg.sandwich_norms:
                a = apply_norm(cfg, a, self.ln1_post)
            if post:
                a = apply_norm(cfg, a, self.ln1)
            h = x + a
            m_in = h if post else apply_norm(cfg, h, self.ln2)
        m = (checkpoint_block(mlp, cfg.remat_policy, m_in) if remat_mlp
             else mlp(m_in))
        if moe:
            m, aux = m
        if cfg.sandwich_norms:
            m = apply_norm(cfg, m, self.ln2_post)
        if post:
            m = apply_norm(cfg, m, self.ln2)
        return (h + m, aux) if moe else h + m


class StageLayers(nn.ModuleDict):
    """The blocks one pipeline stage holds (``parallel/sharding.py``
    ``shard_model`` under 'pp'), keyed by their global index, so that
    their parameters keep the names ``layers.{i}.*`` of the whole model
    (checkpoints, ``models/convert.py``, Hugging Face streaming).
    ``stage[i]`` is block i; iteration yields the blocks in order."""

    def __init__(self, blocks):
        super().__init__({str(i): b for i, b in sorted(blocks.items())})

    def __getitem__(self, i):
        return super().__getitem__(str(i))

    def __iter__(self):
        return iter(self.values())

    def items(self):
        return [(int(k), b) for k, b in super().items()]


class TransformerLM(nn.Module):
    """A decoder of the families the port runs: ``embed_tokens``,
    ``pos_embed`` (learned positions only),
    ``layers[i].{ln1, attn.{q,k,v,o}_proj, ln2, mlp.{gate,up,down}_proj}``
    (with ``attn.{q,k}_norm`` under ``qk_norm``, ``ln{1,2}_post`` under
    ``sandwich_norms``, no ``ln2`` in a parallel block sharing ``ln1``
    and no ``gate_proj`` in a non-gated MLP), ``final_norm`` and
    ``lm_head`` (absent when ``tie_embeddings``; biased under
    ``head_bias``).  A LayerNorm's ``bias`` sits beside its ``weight``.

    The weights are made on ``device``: the card when it is ``None``
    (raising where there is none), ``"meta"`` for a model whose weights
    are made later (``init_params``, ``Trainer.init``).  Their values are
    ``nn.Linear``'s default init; ``init_params`` gives the flax one.

    On a mesh (``parallel.sharding.shard_model``) the parameters are
    DTensors and ``tp_group``/``data_groups`` name the process groups of
    the 'tp' axis and of the data axes; the embedding and the head are
    then vocab-parallel."""

    # the 'tp' process group (None on one device), the process groups
    # of the data axes above 1 and of the sequence ranks (the quantized
    # sites' amax reduce), the sequence ranks' alone (the gradients' sum;
    # None without context parallelism), this rank's CPLayout, and the
    # 'pp' group (the replicated parameters' gradients and the loss are
    # summed over it; None without pipeline parallelism)
    tp_group = None
    data_groups = ()
    seq_group = None
    layout = None
    pp_group = None

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        factory = {"device": resolve_device(device),
                   "dtype": dtype or cfg.param_dtype}
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **factory)
        self.pos_embed = (nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                       **factory)
                          if cfg.pos_emb == "learned" else None)
        self.layers = nn.ModuleList(
            [Block(cfg, i, **factory) for i in range(cfg.num_layers)])
        self.final_norm = Norm(cfg, cfg.hidden_size, **factory)
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=cfg.head_bias, **factory))

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                dropout_seed: Optional[int] = None,
                quant=None, quant_out=None,
                labels: Optional[torch.Tensor] = None,
                hidden: Optional[torch.Tensor] = None,
                layers: Optional[range] = None,
                head_loss: Optional[Callable] = None,
                with_aux: bool = False):
        """``TransformerLM.__call__`` (:853): f32 logits ``[b, s, V]``, or
        with ``return_hidden`` the final-normed hidden in the compute
        dtype, or with ``labels`` the fused linear + CE head's
        ``(loss_sum, valid_count)`` (``ops/fused.py``; vocab-parallel
        under tensor parallelism), computed inside the forward so that a
        sharded head is read while FSDP2 holds it gathered.
        ``positions`` default to ``arange`` (of this rank's chunk of the
        whole sequence under context parallelism); ``segment_ids`` mark
        packed documents.  Under ``cfg.remat`` each block (or, with
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
        None reads the scales and records nothing (evaluation).

        ``layers`` (a pipeline chunk, ``pp_forward_sum_count``): only
        those blocks run, on ``hidden`` (or on the embedding of
        ``input_ids`` where ``hidden`` is None), and the result is the
        chunk's output, or with ``labels`` the final norm, the head and
        the loss's ``(loss_sum, count)``: the fused CE, or
        ``head_loss(hidden, labels)``.
        ``with_aux``: the result is ``(result, aux)``, ``aux`` the f32
        sum over the blocks run of the mixtures of experts' router
        losses (JAX's sown ``moe_aux_loss``, ``_sown_aux_sum`` :1355;
        zero for a dense model).
        Called through the module, so that FSDP2 gathers the embedding
        and the head for it."""
        cfg = self.cfg
        check_training_supported(cfg)
        if layers is not None:
            out, aux = self._chunk(input_ids, hidden, positions,
                                   segment_ids, dropout_seed, layers,
                                   labels, head_loss)
            return (out, aux) if with_aux else out
        scope = None
        if quant_site_names(cfg):
            if quant is None:
                raise ValueError(
                    "quant != 'none' but no amax histories were passed to "
                    "forward(): thread TrainState.quant through it "
                    "(init_quant_state(cfg) makes fresh ones)")
            scope = QuantScope(quant, quant_out, self.data_groups)
        if isinstance(self.layers, StageLayers):
            raise RuntimeError(
                "this model holds one pipeline stage's blocks: run it "
                "through the pipeline (Trainer.step, "
                "models.transformer.pp_forward_sum_count)")
        positions = self._positions(input_ids, positions)
        x = self._embed(input_ids, positions)
        x, aux = self._blocks(x, positions, segment_ids, dropout_seed,
                              scope, range(cfg.num_layers))
        if return_hidden or labels is not None:
            x = final_hidden(cfg, self, x)
        if labels is not None:
            out = self._fused_ce(x, labels)
        elif return_hidden:
            out = x
        else:
            out = head_logits(cfg, self, x, quant=scope)
        return (out, aux) if with_aux else out

    def _positions(self, ids: torch.Tensor,
                   positions: Optional[torch.Tensor]) -> torch.Tensor:
        """``positions``, or ``arange`` over this rank's chunk of the
        sequence."""
        if positions is not None:
            return positions
        b, s = ids.shape
        start = 0 if self.layout is None else self.layout.seq_index * s
        return torch.arange(start, start + s, device=ids.device).expand(b, s)

    def _blocks(self, x, positions, segment_ids, dropout_seed, scope,
                indices) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x, aux)``: blocks ``indices`` (global layer numbers)
        applied in turn, each under remat as ``cfg`` asks, with its
        layer's dropout seed, and the f32 sum of their router losses;
        under longrope each reads the largest position of the global
        batch (:func:`rope_pos_max` over the data and sequence
        ranks)."""
        cfg = self.cfg
        grad = torch.is_grad_enabled()
        sub = _sub_remat(cfg)
        drop = cfg.attn_dropout > 0.0 and dropout_seed is not None
        # longrope's switch reads the whole global batch's positions
        pos_max = (rope_pos_max(positions, self.data_groups)
                   if cfg.rope_longrope is not None else None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in indices:
            layer = self.layers[i]
            remat = grad and _remat_layer(cfg, i)
            kw = dict(dropout_seed=_layer_seed(dropout_seed, i) if drop
                      else None, quant=scope, name=f"layers.{i}",
                      sub_remat=remat and sub, pos_max=pos_max)
            if remat and not sub:
                x = checkpoint_block(functools.partial(layer, **kw),
                                     cfg.remat_policy, x, positions,
                                     segment_ids)
            else:
                x = layer(x, positions, segment_ids, **kw)
            if isinstance(x, tuple):
                x, a = x
                aux = aux + a
        return x, aux

    def _fused_ce(self, x: torch.Tensor, labels: torch.Tensor):
        """The fused linear + CE head on the final-normed ``x`` (which
        has no bias term: a ``head_bias`` model takes the logits, as
        JAX's gate :1507-1509 and the Trainer's send it)."""
        if self.cfg.head_bias:
            raise ValueError(
                "the fused linear + CE head has no bias term: a head_bias "
                "model takes the materialised logits")
        w = to_local(head_weight(self)).t()
        if self.tp_group is None:
            return fused_linear_cross_entropy(
                x, w, labels, logit_softcap=self.cfg.logit_softcap)
        return fused_linear_cross_entropy_tp(
            x, w, labels, group=self.tp_group,
            logit_softcap=self.cfg.logit_softcap)

    def _chunk(self, input_ids, hidden, positions, segment_ids,
               dropout_seed, layers, labels, head_loss):
        """One pipeline chunk (``forward``'s ``layers``) and its router
        losses' sum."""
        ref = input_ids if hidden is None else hidden[..., 0]
        positions = self._positions(ref, positions)
        x = self._embed(input_ids, positions) if hidden is None else hidden
        x, aux = self._blocks(x, positions, segment_ids, dropout_seed, None,
                              layers)
        if labels is None:
            return x, aux
        if head_loss is not None:
            return head_loss(x, labels), aux
        return self._fused_ce(final_hidden(self.cfg, self, x), labels), aux

    def _embed(self, ids: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        """The token embedding in the compute dtype, with the learned
        positions' rows added; vocab-parallel under tensor parallelism:
        each rank looks up the ids of its rows (the rest read as zero)
        and the ranks sum (the position table is whole on every rank)."""
        if self.tp_group is None:
            return embed(self.cfg, self, ids, positions)
        w = to_local(self.embed_tokens.weight)
        off = dist.get_rank(self.tp_group) * w.shape[0]
        mine = (ids >= off) & (ids < off + w.shape[0])
        x = F.embedding(torch.where(mine, ids - off, 0).long(), w)
        x = torch.where(mine[..., None], x, 0.0)
        return embed_extras(self.cfg,
                            _tp_out(x, self.tp_group).to(self.cfg.dtype),
                            positions, self.pos_embed)


def set_model_config(model: nn.Module, cfg: ModelConfig) -> None:
    """Give ``model`` and every submodule holding a config ``cfg`` (the
    weights are untouched)."""
    for mod in model.modules():
        if isinstance(getattr(mod, "cfg", None), ModelConfig):
            mod.cfg = cfg


def scale_hidden(cfg: ModelConfig, xn: torch.Tensor) -> torch.Tensor:
    """Cohere's ``logit_scale`` on the final-normed hidden (``scale_hidden``
    :279; logits * s == (x * s) @ W), so that every head path (the
    module's tail, ``head_logits``, the fused CE's hidden, the 1F1B head,
    ``generate`` and serving) takes it from this one place."""
    if cfg.logit_scale == 1.0:
        return xn
    return xn * torch.tensor(cfg.logit_scale, dtype=xn.dtype,
                             device=xn.device)


def final_hidden(cfg: ModelConfig, model: "TransformerLM",
                 x: torch.Tensor) -> torch.Tensor:
    """The final norm of ``model`` on ``x``, then :func:`scale_hidden`."""
    return scale_hidden(cfg, apply_norm(cfg, x, model.final_norm))


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


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2's final logit soft-capping ``c * tanh(logits / c)``; a cap
    <= 0 is a no-op (``softcap`` of the JAX package)."""
    if cap <= 0.0:
        return logits
    return torch.tanh(logits / cap) * cap


class _TPGather(torch.autograd.Function):
    """The vocab-parallel logits ``[..., V / tp]`` of every 'tp' rank
    joined along the vocab in rank order; the backward keeps this
    rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g[..., r * n:(r + 1) * n].contiguous(), None


def head_logits(cfg: ModelConfig, model: TransformerLM,
                x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                quant: Optional[QuantScope] = None) -> torch.Tensor:
    """Final norm (times ``logit_scale``, :func:`scale_hidden`) -> vocab
    projection (+ ``head_bias``) in the compute
    dtype (or ``dtype``: f32 in JAX's 1F1B head) -> f32 logits ->
    ``logit_softcap`` (``head_logits`` of the JAX package).  With
    ``quant`` and the 'head' site on, the projection is the quantized
    product of the site ``lm_head``, the bias added after it in the
    compute dtype (JAX's materialised quantized head, :1254-1260).
    Under tensor parallelism each rank projects its vocab rows and the
    ranks' logits are joined (the full logits a custom loss or a head
    bias takes, JAX's replicated head); a quantized head's rows are
    column-parallel, each holding the whole hidden dim, so its scales
    need no 'tp' reduce."""
    dt = dtype or cfg.dtype
    xn = _tp_in(final_hidden(cfg, model, x), model.tp_group)
    if quant is not None and quant_site_on(cfg, "head"):
        logits = quant.linear(cfg, "lm_head", xn, model.lm_head)
    else:
        logits = F.linear(xn.to(dt), to_local(head_weight(model)).to(dt))
        if cfg.head_bias:
            logits = logits + to_local(model.lm_head.bias).to(dt)
    if model.tp_group is not None:
        logits = _TPGather.apply(logits, model.tp_group)
    return softcap(logits.float(), cfg.logit_softcap)


def materializer(seed: int, device: torch.device):
    """``make(module, prefix)``: gives the ``meta`` parameters of
    ``module`` (named ``prefix.<name>`` in the whole model) storage on
    ``device`` and the flax initialisers' values, drawn from one
    ``torch.Generator`` seeded with ``seed``: every matrix normal(0.02),
    norm scales their ``Norm.fill`` (one; zero under rmsnorm1p and
    layernorm1p), biases zero.  Called on the model's submodules in the
    order of ``named_parameters``, it makes the weights ``init_params``
    makes, one module at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    @torch.no_grad()
    def make(module: nn.Module, prefix: str = "") -> None:
        module.to_empty(device=device)
        for mname, mod in module.named_modules(prefix=prefix):
            for name, p in mod.named_parameters(prefix=mname,
                                                recurse=False):
                if name.endswith(".bias"):
                    p.zero_()
                elif isinstance(mod, Norm):
                    p.fill_(mod.fill)
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


def pp_block_appliers(cfg: ModelConfig):
    """The layers of each pipeline chunk, ``[stage][chunk] -> range``
    (``pp_block_appliers`` of the JAX package, :796, whose appliers are
    the model's own blocks here: a chunk is ``TransformerLM.forward``
    with ``layers``).  Under a ``layer_pattern`` JAX's slot j of every
    chunk runs ``pattern_cfg(cfg, j)``; here each block takes the
    config of its global index, the same one when the pattern's period
    divides a chunk, which JAX requires (:809) and so does this."""
    if cfg.layer_pattern:
        plen = len(cfg.layer_pattern)
        per_stage = cfg.num_layers // (cfg.pp_size * cfg.pp_virtual)
        if per_stage % plen:
            raise ValueError(
                f"layer_pattern of period {plen} does not divide the "
                f"per-stage chunk of {per_stage} layers (num_layers "
                f"{cfg.num_layers} / pp {cfg.pp_size} / virtual "
                f"{cfg.pp_virtual}): slot kinds would differ across "
                f"stages.  Choose pp_size x virtual_stages so each chunk "
                f"holds whole pattern repeats.")
    from torchacc_tpu_torch.parallel.pp import stage_layers
    return [stage_layers(cfg.num_layers, cfg.pp_size, cfg.pp_virtual, d)
            for d in range(cfg.pp_size)]


class _MicroBatchView(dict):
    """The batch a custom Trainer loss sees in the last stage under 1F1B
    (``_MicroBatchView`` of the JAX package, :1365): the micro-batch's
    labels only, and an actionable error for any other key, through
    ``[]`` and ``get`` alike (``in`` stays plain membership)."""

    def __missing__(self, key):
        raise KeyError(
            f"batch[{key!r}] is not available inside the 1f1b pipeline "
            "region: a custom loss under pp.schedule='1f1b' runs in the "
            "last stage and sees {'labels': ...} only.  Losses needing "
            "other batch leaves should use pp.schedule='gpipe', whose "
            "loss runs outside the region.")

    def get(self, key, default=None):
        if not dict.__contains__(self, key):
            self.__missing__(key)
        return dict.get(self, key, default)


def pp_forward_sum_count(model: TransformerLM, pipeline, batch,
                         labels: torch.Tensor, *,
                         dropout_seed: Optional[int] = None,
                         use_fused_ce: bool = True,
                         custom_loss: Optional[Callable] = None,
                         train: bool = True,
                         scale: Optional[torch.Tensor] = None):
    """``(loss_sum, count)`` of ``batch`` through ``pipeline``
    (``parallel.pp.Pipeline``) over ``model``'s chunks: the GPipe path of
    ``TransformerLM.__call__`` (:1002-1076) and
    ``pp_1f1b_forward_sum_count`` (:1389-1560).  With ``train`` the
    gradients of ``loss_sum * scale`` land on the parameters.

    The batch splits into the pipeline's micro-batches along dim 0; each
    stage reads its micro-batch's ids, positions, segment ids and labels
    from ``batch``, so only the activation travels.  The last virtual
    stage runs the final norm, the head and the loss: the fused CE
    (vocab-parallel under tensor parallelism) when ``use_fused_ce``,
    else the logits (projected in f32 under 1F1B, as JAX's last stage
    does) into ``custom_loss(logits, batch)`` (a micro-batch's slice of
    the batch; under 1F1B training a ``_MicroBatchView`` of its labels,
    as in JAX) or the plain CE.  Attention dropout (``dropout_seed``
    and ``cfg.attn_dropout``): GPipe draws every micro-batch with the
    layer seeds of ``dropout_seed`` alone, 1F1B mixes the micro index in
    first (``_micro_seed``), the JAX package's two conventions; the
    kernels hash each row's place in its micro-batch.  A mixture of
    experts' router losses ride each micro-batch: every chunk adds
    ``router_aux_weight * aux * count_m`` to the loss sum, ``count_m``
    the micro-batch's labels that are not -100 (JAX's weight rider
    under GPipe, :1018-1075, and ``aux_scale`` under 1F1B, :1450-1455),
    and its gradient to the chunk's backward."""
    cfg = model.cfg
    chunks = pp_block_appliers(cfg)
    # the fused CE has no bias term: a head_bias model's last stage
    # takes the logits (JAX :1509)
    use_fused_ce = use_fused_ce and not cfg.head_bias
    ids = batch["input_ids"]
    b, M = ids.shape[0], pipeline.num_micro
    if b % M:
        raise ValueError(f"batch {b} not divisible by num_micro_batches {M}")
    mb = b // M
    drop = cfg.attn_dropout > 0.0 and dropout_seed is not None
    one_f = train and pipeline.schedule == "1f1b"
    w_aux = cfg.router_aux_weight if cfg.num_experts > 0 else 0.0

    def part(t, m):
        return None if t is None or t.ndim == 0 else t[m * mb:(m + 1) * mb]

    def head_for(m):
        if use_fused_ce and custom_loss is None:
            return None

        def head(x, lab):
            # JAX's 1F1B head projects in f32
            logits = head_logits(cfg, model, x,
                                 torch.float32 if one_f else None)
            if custom_loss is None:
                return loss_sum_count(logits, lab)
            view = (_MicroBatchView(labels=lab) if one_f else
                    {k: part(v, m) if torch.is_tensor(v) else v
                     for k, v in batch.items()})
            res = custom_loss(logits, view)
            if isinstance(res, tuple):
                return res
            return res, torch.ones((), dtype=torch.float32,
                                   device=logits.device)
        return head

    def call(d, c, m, x, last):
        seed = None
        if drop:
            seed = _micro_seed(dropout_seed, m) if one_f else dropout_seed
        out = model(part(ids, m), positions=part(batch.get("positions"), m),
                    segment_ids=part(batch.get("segment_ids"), m),
                    dropout_seed=seed, hidden=x, layers=chunks[d][c],
                    labels=part(labels, m) if last else None,
                    head_loss=head_for(m) if last else None,
                    with_aux=bool(w_aux))
        if not w_aux:
            return out
        res, aux = out
        extra = w_aux * aux * (part(labels, m) != -100).sum().float()
        if last:
            return res[0] + extra, res[1]
        return res, extra
    return pipeline.run(call, train=train, scale=scale)
