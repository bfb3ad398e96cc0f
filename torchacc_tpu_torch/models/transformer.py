"""Decoder-only transformer LM (the port of torchacc_tpu/models/
transformer.py, serving subset).

``ModelConfig`` is a copy of the JAX package's config with torch dtypes:
every field is there, so a JAX config maps onto it field by field, but
the serving forward (serve/scheduler.py) implements only the Llama
family — rmsnorm, swiglu, plain RoPE (``rope_theta``, ``rope_scale``),
GQA, ``qkv_bias``, ``tie_embeddings`` and ``attn_logit_softcap`` — and
``serve.scheduler._check_supported`` rejects the rest by name.

``TransformerLM`` is an ``nn.Module`` that holds the weights in
``nn.Linear`` layout (``[out, in]``); the forward over the paged cache
lives in ``serve.scheduler.PagedDecoder`` as in the JAX package.
``init_params`` draws every matrix from normal(0.02) with a
``torch.Generator`` (norm scales one, biases zero), as the flax init
does — the numbers differ from JAX's for the same seed; tests that
compare the two packages carry the JAX weights over with
``models.convert.params_from_jax``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchacc_tpu_torch.ops._common import resolve_device


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


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        h, d = cfg.hidden_size, cfg.head_size
        self.q_proj = nn.Linear(h, cfg.num_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.k_proj = nn.Linear(h, cfg.kv_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.v_proj = nn.Linear(h, cfg.kv_heads * d, bias=cfg.qkv_bias,
                                **factory)
        self.o_proj = nn.Linear(cfg.num_heads * d, h, bias=False, **factory)


class Mlp(nn.Module):
    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_size
        self.gate_proj = nn.Linear(h, f, bias=False, **factory)
        self.up_proj = nn.Linear(h, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, h, bias=False, **factory)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, **factory):
        super().__init__()
        self.ln1 = RMSNorm(cfg.hidden_size, **factory)
        self.attn = Attention(cfg, **factory)
        self.ln2 = RMSNorm(cfg.hidden_size, **factory)
        self.mlp = Mlp(cfg, **factory)


class TransformerLM(nn.Module):
    """The weights of a Llama-family decoder: ``embed_tokens``,
    ``layers[i].{ln1, attn.{q,k,v,o}_proj, ln2, mlp.{gate,up,down}_proj}``,
    ``final_norm`` and ``lm_head`` (absent when ``tie_embeddings``)."""

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        factory = {"device": device, "dtype": dtype or cfg.param_dtype}
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


def head_logits(cfg: ModelConfig, model: TransformerLM,
                x: torch.Tensor) -> torch.Tensor:
    """Final norm -> vocab projection in the compute dtype -> f32 logits
    (``head_logits`` of the JAX package)."""
    xn = rms_norm(cfg, x, model.final_norm.weight)
    w = (model.embed_tokens.weight if cfg.tie_embeddings
         else model.lm_head.weight)
    return F.linear(xn.to(cfg.dtype), w.to(cfg.dtype)).float()


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
