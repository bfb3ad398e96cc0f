"""Decoder-only transformer LM (the port of torchacc_tpu/models/
transformer.py, Llama subset).

``ModelConfig`` is a copy of the JAX package's config with torch dtypes:
every field is there, so a JAX config maps onto it field by field, but
the port implements only the Llama family — rmsnorm, swiglu, plain RoPE
(``rope_theta``, ``rope_scale``), GQA, ``qkv_bias``, ``tie_embeddings``
and ``attn_logit_softcap``.  The serving forward (serve/scheduler.py)
and the training forward here both reject the rest by name.

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
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchacc_tpu_torch.models.generate import embed
from torchacc_tpu_torch.ops._common import resolve_device
from torchacc_tpu_torch.ops.attn import attention
from torchacc_tpu_torch.utils.remat import checkpoint_block, checkpoint_name


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
    return (y * weight.float()).to(cfg.dtype)


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
# the training forward also implements remat and the attention choice;
# every other field must keep its default
_TRAIN_FIELDS = LLAMA_FIELDS | {"remat", "remat_policy", "attention_impl"}
# fields that pick how the JAX package lays out or shards the step, or
# knobs inert while their feature is off; none changes what one device
# computes
_TRAIN_INERT = frozenset({
    "scan_layers", "cache_len", "quant_sites", "quant_amax_history_len",
    "quant_impl", "pp_num_micro", "pp_virtual", "logical_axis_rules",
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


def dense(cfg: ModelConfig, x: torch.Tensor,
          lin: nn.Linear) -> torch.Tensor:
    """A projection with both operands in the compute dtype (flax
    ``Dense(dtype=cfg.dtype)``); ``.to`` is free when the weight already
    is (the bf16 shadow)."""
    dt = cfg.dtype
    y = F.linear(x.to(dt), lin.weight.to(dt))
    if lin.bias is not None:
        y = y + lin.bias.to(dt)
    return y


class Attention(nn.Module):
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

    def forward(self, x, positions, segment_ids=None):
        """``Attention.__call__`` (:480) without the KV cache: q/k/v
        projections, RoPE, causal attention over ``segment_ids``, o
        projection.  The ``checkpoint_name`` sites are the JAX package's
        names for the selective remat policies."""
        cfg = self.cfg
        b, s = x.shape[:2]
        d = cfg.head_size
        with checkpoint_name("qkv_proj"):
            q = dense(cfg, x, self.q_proj).view(b, s, cfg.num_heads, d)
            k = dense(cfg, x, self.k_proj).view(b, s, cfg.kv_heads, d)
            v = dense(cfg, x, self.v_proj).view(b, s, cfg.kv_heads, d)
        rp = (positions.float() / cfg.rope_scale if cfg.rope_scale != 1.0
              else positions)
        q, k = rope(q, k, rp, cfg)
        out = attention(q, k, v, causal=True, window=cfg.window,
                        scale=cfg.query_scale, q_segment_ids=segment_ids,
                        kv_segment_ids=segment_ids,
                        logit_softcap=cfg.attn_logit_softcap,
                        impl=cfg.attention_impl)
        with checkpoint_name("attn_out"):
            return dense(cfg, out.reshape(b, s, -1), self.o_proj)


class Mlp(nn.Module):
    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.ffn_size
        self.gate_proj = nn.Linear(h, f, bias=False, **factory)
        self.up_proj = nn.Linear(h, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, h, bias=False, **factory)

    def forward(self, x):
        """SwiGLU ``Mlp.__call__`` (:665)."""
        cfg = self.cfg
        with checkpoint_name("mlp_gate_up"):
            gate = dense(cfg, x, self.gate_proj)
            up = dense(cfg, x, self.up_proj)
        with checkpoint_name("mlp_out"):
            return dense(cfg, F.silu(gate) * up, self.down_proj)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.hidden_size, **factory)
        self.attn = Attention(cfg, **factory)
        self.ln2 = RMSNorm(cfg.hidden_size, **factory)
        self.mlp = Mlp(cfg, **factory)

    def forward(self, x, positions, segment_ids=None):
        """Pre-norm ``Block.__call__`` (:722)."""
        cfg = self.cfg
        h = x + self.attn(rms_norm(cfg, x, self.ln1.weight), positions,
                          segment_ids)
        return h + self.mlp(rms_norm(cfg, h, self.ln2.weight))


class TransformerLM(nn.Module):
    """A Llama-family decoder: ``embed_tokens``,
    ``layers[i].{ln1, attn.{q,k,v,o}_proj, ln2, mlp.{gate,up,down}_proj}``,
    ``final_norm`` and ``lm_head`` (absent when ``tie_embeddings``).

    The weights are made on ``device``: the card when it is ``None``
    (raising where there is none), ``"meta"`` for a model whose weights
    are made later (``init_params``, ``Trainer.init``).  Their values are
    ``nn.Linear``'s default init; ``init_params`` gives the flax one."""

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
                return_hidden: bool = False) -> torch.Tensor:
        """``TransformerLM.__call__`` (:853): f32 logits ``[b, s, V]``, or
        with ``return_hidden`` the final-normed hidden in the compute
        dtype (the fused CE head applies the vocab projection itself).
        ``positions`` default to ``arange``; ``segment_ids`` mark packed
        documents.  Under ``cfg.remat`` each block is a checkpoint
        region with the selective policy ``cfg.remat_policy``."""
        cfg = self.cfg
        check_training_supported(cfg)
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        x = embed(cfg, self, input_ids)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint_block(layer, cfg.remat_policy, x, positions,
                                     segment_ids)
            else:
                x = layer(x, positions, segment_ids)
        if return_hidden:
            return rms_norm(cfg, x, self.final_norm.weight)
        logits = head_logits(cfg, self, x)
        if cfg.logit_softcap > 0.0:
            logits = torch.tanh(logits / cfg.logit_softcap) \
                * cfg.logit_softcap
        return logits


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


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype: Optional[torch.dtype] = None) -> TransformerLM:
    """A ``TransformerLM`` with random weights made on ``device`` (the
    card when ``None``) from a ``torch.Generator`` seeded with ``seed``:
    every matrix normal(0.02), norm scales one, biases zero (the flax
    initialisers).  ``dtype`` defaults to ``cfg.param_dtype``; serving
    passes ``cfg.dtype``."""
    device = resolve_device(device)
    model = TransformerLM(cfg, device="meta", dtype=dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("ln1.weight") or name.endswith("ln2.weight") \
                or name == "final_norm.weight":
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model.requires_grad_(False).eval()
