"""Hugging Face models into the port (the port of torchacc_tpu/models/
hf.py: ``config_from_hf`` :37, ``params_from_hf_state_dict`` :515 and
``load_hf_model`` :723), for the families whose forward the port runs:
Llama 1/2/3/3.1/3.2 (with ``attention_bias``, ``mlp_bias`` and the
``llama3`` and ``linear`` rope scalings), Qwen2 (qkv bias), Qwen3
(per-head qk-norm), Mistral (a sliding window), Gemma v1 (1 + w
RMSNorm, GeGLU, scaled embeddings), Gemma2 (sandwich norms, the
sliding/global pattern, softcaps), Gemma3 (qk-norm, the 5:1 pattern
with a local rope base, linear scaling on the global layers), GPT-2
(learned positions, biased LayerNorms, gelu_new, Conv1D weights with a
packed q|k|v), StarCoder2 (biased LayerNorms, a non-gated ``c_fc``/
``c_proj`` MLP), GPT-NeoX (the parallel residual with two norms, exact
gelu, q/k/v packed per head, partial rotary), Nemotron (layernorm1p,
relu2, partial rotary), Phi-1/1.5/2 (the parallel residual with one
norm, ``fc1``/``fc2``, partial rotary, a biased head), Phi-3/3.5/4-mini
(packed ``qkv_proj``/``gate_up_proj``, partial rotary, longrope),
Cohere (the parallel residual with one biasless LayerNorm, interleaved
RoPE, ``logit_scale``, a tied head), OLMo2 (post-norms, the qk-norm
over the flat projections) and the mixtures of experts Mixtral
(``block_sparse_moe``) and Qwen3-MoE (``mlp.experts``, per-head
qk-norm, ``norm_topk_prob``); rope scalings linear, llama3, longrope and
yarn.

The other mixtures of experts, every other ``model_type`` and rope
scaling raise ``NotImplementedError`` naming what the port converts,
so nothing converts silently wrong.  HF's weights are ``[out, in]``, the
port's layout: the conversion renames and checks shapes
(``hf_stream.ingestion_plan``) and never goes through the JAX package's
``[in, heads, d]`` layout; GPT-2's ``[in, out]`` Conv1D weights and
GPT-NeoX's per-head packing are unpacked by their own converters, as
in JAX.  An HF model object is read through its ``.config`` and
``.state_dict()`` alone, so neither ``transformers`` nor
``safetensors`` is imported.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from torchacc_tpu_torch.models.hf_stream import (
    Row,
    SafetensorsFile,
    ingestion_plan,
    missing_tensors,
    plan_entry,
    plan_targets,
    read_hf_config,
    resolve_checkpoint_files,
)
from torchacc_tpu_torch.models.transformer import ModelConfig, TransformerLM

#: model types whose forward the port runs
SUPPORTED = ("llama", "qwen2", "qwen3", "mistral", "gemma", "gemma2",
             "gemma3", "gemma3_text", "gpt2", "starcoder2", "gpt_neox",
             "nemotron", "phi", "phi3", "cohere", "olmo2", "mixtral",
             "qwen3_moe")
# the families whose transformers config ties the head by default
# (config.json leaves the key out where it keeps its class's default)
_TIED_BY_DEFAULT = ("gemma", "gemma2", "gemma3", "gemma3_text", "gpt2",
                    "starcoder2", "cohere")
# GPT-2's config.json keeps its own names (transformers' attribute_map)
_GPT2_NAMES = {"hidden_size": "n_embd", "num_attention_heads": "n_head",
               "num_hidden_layers": "n_layer",
               "max_position_embeddings": "n_positions"}
# mixture-of-experts families the port does not convert (their routers,
# shared experts or layer schedules are not Mixtral's or Qwen3-MoE's)
_MOE_TYPES = ("qwen2_moe", "deepseek_v2", "deepseek_v3", "dbrx", "olmoe",
              "jamba")


def config_from_hf(hf_config: Any, **overrides) -> ModelConfig:
    """``ModelConfig`` from a transformers ``PretrainedConfig`` or the
    namespace ``hf_stream.read_hf_config`` makes of ``config.json``
    (``SUPPORTED``), field for field as JAX's (:37); ``overrides``
    (``dtype``, ``param_dtype``, ...) are applied last."""
    mt = getattr(hf_config, "model_type", None)

    def get(n, d=None):
        if mt == "gpt2" and getattr(hf_config, n, None) is None:
            n = _GPT2_NAMES.get(n, n)
        return getattr(hf_config, n, d)
    if mt in _MOE_TYPES:
        raise NotImplementedError(
            f"Hugging Face model_type {mt!r} (mixture of experts) is not a "
            f"family torchacc_tpu_torch converts; of the mixtures of "
            f"experts it converts mixtral and qwen3_moe (all: "
            f"{', '.join(SUPPORTED)})")
    if mt not in SUPPORTED:
        raise NotImplementedError(
            f"Hugging Face model_type {mt!r} is not a family "
            f"torchacc_tpu_torch converts; it converts "
            f"{', '.join(SUPPORTED)}")
    kw = dict(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads", get("num_attention_heads")),
        head_dim=get("head_dim"),
        intermediate_size=get("intermediate_size"),
        max_seq_len=get("max_position_embeddings", 4096),
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        qkv_bias=bool(get("attention_bias", False) or mt == "qwen2"),
        # llama's attention_bias puts a bias on o_proj too (qwen2's qkv
        # bias does not); mlp_bias is llama's own switch
        o_bias=bool(get("attention_bias", False)),
        mlp_bias=bool(get("mlp_bias", False)),
        # config.json leaves tie_word_embeddings out where it is
        # transformers' own default, True, as Gemma's and GPT-2's are
        tie_embeddings=bool(get("tie_word_embeddings",
                                mt in _TIED_BY_DEFAULT)),
    )
    gemma = dict(norm="rmsnorm1p", activation="geglu", embed_scale=True)
    # gemma2/3: query_pre_attn_scalar ** -0.5, not head_dim ** -0.5
    query_scale = lambda: float(get("query_pre_attn_scalar",
                                    kw.get("head_dim") or 256)) ** -0.5
    if mt == "gemma":
        kw.update(gemma)
    elif mt == "gemma2":
        # sandwich norms, sliding/global alternation (HF: even layers
        # slide), attention-score softcap
        kw.update(gemma, sandwich_norms=True,
                  layer_pattern=("sliding", "global"),
                  attn_logit_softcap=float(
                      get("attn_logit_softcapping") or 0.0),
                  query_scale=query_scale())
    elif mt in ("gemma3", "gemma3_text"):
        # gemma2's norms, the layer_types pattern with the local rope base
        # on its sliding layers, qk-norm, no score softcap
        kw.update(gemma, sandwich_norms=True, qk_norm=True,
                  layer_pattern=_pattern_from_layer_types(
                      get("layer_types"),
                      sliding_window_pattern=get("sliding_window_pattern")),
                  rope_local_theta=float(get("rope_local_base_freq",
                                             10000.0)),
                  query_scale=query_scale())
    elif mt == "qwen3":
        # per-head RMSNorm on q and k before rope (cfg.norm stays rmsnorm)
        kw.update(qk_norm=True)
    elif mt == "qwen3_moe":
        # qwen3's attention and per-expert llama FFNs at
        # moe_intermediate_size; norm_topk_prob picks the combine
        # weights; JAX's defaults where transformers' differ (JAX
        # :226-242)
        if int(get("decoder_sparse_step", 1) or 1) != 1 \
                or get("mlp_only_layers"):
            raise NotImplementedError(
                "qwen3_moe mixed dense/sparse layer schedules "
                "(decoder_sparse_step != 1 / mlp_only_layers) are not "
                "implemented")
        kw.update(
            qk_norm=True,
            num_experts=int(get("num_experts")),
            num_experts_per_tok=int(get("num_experts_per_tok", 2)),
            router_aux_weight=float(get("router_aux_loss_coef", 0.001)),
            intermediate_size=int(get("moe_intermediate_size")),
            moe_renorm_topk=bool(get("norm_topk_prob", False)))
    elif mt == "mixtral":
        # llama's attention and a top-k MoE MLP; HF's softmax, top-k,
        # renormalise is the softmax over the selected logits (JAX
        # :243-252)
        kw.update(
            num_experts=int(get("num_local_experts")),
            num_experts_per_tok=int(get("num_experts_per_tok", 2)),
            router_aux_weight=float(get("router_aux_loss_coef", 0.01)))
    elif mt == "phi3":
        # Llama's pre-norm block with packed qkv_proj/gate_up_proj (split
        # at ingestion), Phi-4-mini's partial rotary; longrope below
        prf = float(get("partial_rotary_factor", 1.0) or 1.0)
        if prf != 1.0:
            kw["partial_rotary"] = prf
    elif mt == "olmo2":
        # post-norms (x + norm(f(x)), no pre-norm) and RMSNorm over the
        # flat q/k projections
        kw.update(qk_norm=True, qk_norm_proj=True, norm_placement="post")
    elif mt == "cohere":
        # the parallel residual with one shared biasless LayerNorm, a
        # gated silu MLP, interleaved RoPE and logit_scale on the
        # final-normed hidden
        if get("use_qk_norm", False):
            raise NotImplementedError(
                "cohere use_qk_norm=True (per-head LayerNorm q/k) is "
                "not implemented")
        kw.update(parallel_block=True, norm="layernorm", norm_bias=False,
                  norm_eps=float(get("layer_norm_eps", 1e-5)),
                  logit_scale=float(get("logit_scale", 1.0) or 1.0),
                  rope_interleaved=True)
    else:
        _layernorm_family(mt, get, kw)
    rs = get("rope_scaling")
    if rs:
        rt = rs.get("rope_type", rs.get("type", "default"))
        if mt in ("gemma3", "gemma3_text") and rt != "linear":
            raise NotImplementedError(
                f"gemma3 rope_scaling type {rt!r} is not implemented "
                f"(linear is)")
        if rt == "linear":
            # gemma3: the global layers' only (pattern_cfg sets the
            # sliding layers' back to 1)
            kw["rope_scale"] = float(rs["factor"])
        elif rt == "llama3":
            kw["rope_llama3"] = (
                float(rs["factor"]), float(rs["low_freq_factor"]),
                float(rs["high_freq_factor"]),
                float(rs["original_max_position_embeddings"]))
        elif rt == "longrope":
            kw["rope_longrope"] = _longrope(get, rs, kw["max_seq_len"])
        elif rt == "yarn":
            kw["rope_yarn"] = _yarn(rs, kw["max_seq_len"])
        elif rt != "default":
            raise NotImplementedError(
                f"rope_scaling type {rt!r} is not implemented (linear, "
                f"llama3, longrope and yarn are)")
    if get("final_logit_softcapping"):
        kw["logit_softcap"] = float(get("final_logit_softcapping"))
    if get("sliding_window") and get("use_sliding_window", True):
        # HF attends kv > q - sliding_window (sliding_window keys); the
        # window (left, right) attends kv >= q - left: left is one less
        kw["window"] = (int(get("sliding_window")) - 1, -1)
    kw.update(overrides)
    return ModelConfig(**kw)


def _longrope(get, rs, max_len) -> Tuple:
    """Phi-3.5/4's ``rope_longrope`` (JAX :271-291): the original
    context from the config attribute when there is one (the effective
    factor then max_len / original), else max_len with the scaling's own
    ``factor``; the default attention factor computed here, so that the
    forward never guesses the factor."""
    attr_orig = get("original_max_position_embeddings")
    orig = float(attr_orig or max_len)
    f_eff = (max_len / orig if attr_orig
             else float(rs.get("factor") or 1.0))
    af = rs.get("attention_factor")
    if af is None:
        af = (1.0 if f_eff <= 1.0
              else math.sqrt(1.0 + math.log(f_eff) / math.log(orig)))
    return (tuple(float(x) for x in rs["short_factor"]),
            tuple(float(x) for x in rs["long_factor"]), orig, float(af))


def _yarn(rs, max_len) -> Tuple:
    """Qwen's 128k ``rope_yarn`` (JAX :292-311), with HF's fallbacks: the
    original context from the scaling or max_len (not divided by the
    factor), betas 32 and 1 where absent or null; DeepSeek's mscale
    variants raise."""
    orig = float(rs.get("original_max_position_embeddings") or max_len)
    af = rs.get("attention_factor")
    if rs.get("mscale") or rs.get("mscale_all_dim"):
        raise NotImplementedError(
            "yarn mscale variants (deepseek) are not implemented")
    return (float(rs["factor"]), orig, float(rs.get("beta_fast") or 32.0),
            float(rs.get("beta_slow") or 1.0),
            None if af is None else float(af),
            bool(rs.get("truncate", True)))


def _check_act(mt: str, what: str, act: str, ok: Tuple[str, ...],
               named: str) -> None:
    """Raise as JAX does on an activation its conversion would turn
    silently wrong."""
    if act not in ok:
        raise NotImplementedError(
            f"{mt} {what} {act!r} is not implemented ({named} is)")


def _layernorm_family(mt: str, get, kw: Dict[str, Any]) -> None:
    """The fields of the LayerNorm families (JAX :101-205): GPT-2,
    StarCoder2, GPT-NeoX, Nemotron and Phi; ``kw`` is updated in
    place."""
    if mt == "gpt2":
        # learned positions, biased LayerNorms, gelu_new, biases on every
        # projection, a tied head; gelu here is the tanh approximation,
        # so an erf gelu or a relu would convert silently wrong
        _check_act(mt, "activation_function",
                   get("activation_function", "gelu_new"),
                   ("gelu_new", "gelu_pytorch_tanh"), "gelu_new")
        kw.update(norm="layernorm", activation="gelu", pos_emb="learned",
                  qkv_bias=True, o_bias=True, mlp_bias=True,
                  norm_eps=float(get("layer_norm_epsilon", 1e-5)))
        if get("n_inner"):
            kw["intermediate_size"] = int(get("n_inner"))
    elif mt == "starcoder2":
        # GQA, biased LayerNorms, a non-gated gelu_pytorch_tanh MLP, one
        # use_bias switch for q/k/v/o and the MLP (7B/15B's
        # sliding_window is read after this)
        _check_act(mt, "hidden_act", get("hidden_act", "gelu_pytorch_tanh"),
                   ("gelu_pytorch_tanh", "gelu_new"), "gelu_pytorch_tanh")
        bias = bool(get("use_bias", True))
        kw.update(norm="layernorm", activation="gelu", qkv_bias=bias,
                  o_bias=bias, mlp_bias=bias,
                  norm_eps=float(get("norm_epsilon", 1e-5)))
    elif mt == "gpt_neox":
        # the parallel residual with two norms (use_parallel_residual,
        # Pythia's default), q/k/v packed per head, exact gelu, partial
        # rotary by rotary_pct; attention_bias gates q/k/v and dense,
        # the MLP is always biased
        act = get("hidden_act", "gelu")
        if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh",
                       "gelu_fast"):
            raise NotImplementedError(
                f"gpt_neox hidden_act {act!r} is not implemented")
        bias = bool(get("attention_bias", True))
        kw.update(norm="layernorm",
                  activation="gelu_exact" if act == "gelu" else "gelu",
                  parallel_block=bool(get("use_parallel_residual", True)),
                  parallel_block_shared_norm=False, qkv_bias=bias,
                  o_bias=bias, mlp_bias=True,
                  norm_eps=float(get("layer_norm_eps", 1e-5)),
                  rope_theta=float(get("rotary_emb_base",
                                       get("rope_theta", 10000.0) or
                                       10000.0) or 10000.0))
        prf = float(get("rotary_pct", 1.0) or 1.0)
        if prf != 1.0:
            kw["partial_rotary"] = prf
    elif mt == "nemotron":
        # layernorm1p (scale 1 + w, a bias), a non-gated relu2 MLP with
        # llama's up/down names, partial rotary
        _check_act(mt, "hidden_act", get("hidden_act", "relu2"),
                   ("relu2",), "relu2")
        kw.update(norm="layernorm1p", activation="relu2",
                  norm_eps=float(get("norm_eps", 1e-5)))
        prf = float(get("partial_rotary_factor", 0.5) or 1.0)
        if prf != 1.0:
            kw["partial_rotary"] = prf
    elif mt == "phi":
        # Phi-1/1.5/2: the parallel residual with one shared biased
        # LayerNorm, partial rotary, gelu_new fc1/fc2, biases everywhere
        # and on the head, which cannot be tied
        _check_act(mt, "hidden_act", get("hidden_act", "gelu_new"),
                   ("gelu_new", "gelu_pytorch_tanh"), "gelu_new")
        if kw.get("tie_embeddings"):
            raise NotImplementedError(
                "phi with tie_word_embeddings=True is not supported "
                "(the biased lm_head cannot ride the tied head)")
        kw.update(norm="layernorm", activation="gelu", parallel_block=True,
                  qkv_bias=True, o_bias=True, mlp_bias=True, head_bias=True,
                  norm_eps=float(get("layer_norm_eps", 1e-5)),
                  partial_rotary=float(get("partial_rotary_factor", 0.5)))


def _pattern_from_layer_types(layer_types, sliding_window_pattern=None
                              ) -> Tuple[str, ...]:
    """The shortest cyclic ``layer_pattern`` that gives HF's per-layer
    ``layer_types`` (gemma3: 5 sliding and 1 full); configs of
    transformers before 4.53 give ``sliding_window_pattern=p`` (every
    p-th layer global) instead (JAX :327)."""
    if not layer_types:
        if sliding_window_pattern:
            p = int(sliding_window_pattern)
            return ("sliding",) * (p - 1) + ("global",)
        raise ValueError("layer_types missing from the HF config")
    kinds = tuple("sliding" if t == "sliding_attention" else "global"
                  for t in layer_types)
    n = len(kinds)
    for period in range(1, n):
        if n % period == 0 and kinds == kinds[:period] * (n // period):
            return kinds[:period]
    return kinds


def _getter(state_dict: Mapping[str, torch.Tensor], prefix: str):
    """``get(name)``: the tensor ``name`` with or without ``prefix``."""
    def get(name):
        for key in (prefix + name, name):
            if key in state_dict:
                return state_dict[key].detach()
        raise KeyError(f"missing weight {name!r} in state_dict")
    return get


def _norm_params(out, get, dst: str, src: str) -> None:
    out[f"{dst}.weight"] = get(f"{src}.weight")
    out[f"{dst}.bias"] = get(f"{src}.bias")


def _params_from_gpt2(state_dict, cfg: ModelConfig
                      ) -> Dict[str, torch.Tensor]:
    """GPT-2's tensors (JAX ``_params_from_gpt2`` :354): Conv1D weights
    are ``[in, out]``, so each is transposed; ``c_attn`` packs q|k|v on
    its output dim; biases everywhere; the position table's first
    ``max_seq_len`` rows."""
    get = _getter(state_dict, "transformer.")
    h = cfg.hidden_size
    out = {"embed_tokens.weight": get("wte.weight"),
           "pos_embed.weight": get("wpe.weight")[:cfg.max_seq_len]}
    for i in range(cfg.num_layers):
        p, q = f"layers.{i}.", f"h.{i}."
        w, b = get(q + "attn.c_attn.weight"), get(q + "attn.c_attn.bias")
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{p}attn.{name}.weight"] = w[:, j * h:(j + 1) * h].t()
            out[f"{p}attn.{name}.bias"] = b[j * h:(j + 1) * h]
        for dst, src in (("attn.o_proj", "attn.c_proj"),
                         ("mlp.up_proj", "mlp.c_fc"),
                         ("mlp.down_proj", "mlp.c_proj")):
            out[f"{p}{dst}.weight"] = get(f"{q}{src}.weight").t()
            out[f"{p}{dst}.bias"] = get(f"{q}{src}.bias")
        _norm_params(out, get, p + "ln1", q + "ln_1")
        _norm_params(out, get, p + "ln2", q + "ln_2")
    _norm_params(out, get, "final_norm", "ln_f")
    return out


def _params_from_neox(state_dict, cfg: ModelConfig
                      ) -> Dict[str, torch.Tensor]:
    """GPT-NeoX's tensors (JAX ``_params_from_neox`` :418):
    ``attention.query_key_value`` packs q|k|v per head, its rows
    ``[heads, 3, d]``; ``attention.dense``, ``mlp.dense_h_to_4h`` and
    ``mlp.dense_4h_to_h``; biased LayerNorms; the ``embed_out`` head."""
    get = _getter(state_dict, "gpt_neox.")
    h, nh, d = cfg.hidden_size, cfg.num_heads, cfg.head_size
    out = {"embed_tokens.weight": get("embed_in.weight")}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        w = get(p + "attention.query_key_value.weight").reshape(nh, 3, d, h)
        b = (get(p + "attention.query_key_value.bias").reshape(nh, 3, d)
             if cfg.qkv_bias else None)
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{p}attn.{name}.weight"] = w[:, j].reshape(nh * d, h)
            if b is not None:
                out[f"{p}attn.{name}.bias"] = b[:, j].reshape(nh * d)
        out[p + "attn.o_proj.weight"] = get(p + "attention.dense.weight")
        if cfg.o_bias:
            out[p + "attn.o_proj.bias"] = get(p + "attention.dense.bias")
        for dst, src in (("up_proj", "dense_h_to_4h"),
                         ("down_proj", "dense_4h_to_h")):
            out[f"{p}mlp.{dst}.weight"] = get(f"{p}mlp.{src}.weight")
            out[f"{p}mlp.{dst}.bias"] = get(f"{p}mlp.{src}.bias")
        _norm_params(out, get, p + "ln1", p + "input_layernorm")
        _norm_params(out, get, p + "ln2", p + "post_attention_layernorm")
    _norm_params(out, get, "final_norm", "final_layer_norm")
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = get("embed_out.weight")
    return out


#: GPT-NeoX's attention tensors (JAX ``_NEOX_QKV_RE``): anchored on
#: ``layers.<i>.``, so that Falcon's ``h.<i>.self_attention.
#: query_key_value`` is not taken for NeoX's
_NEOX_QKV_RE = re.compile(
    r"(?:^|\.)layers\.\d+\.attention\.query_key_value\.weight$")


def _is_neox_state_dict(state_dict: Mapping[str, Any]) -> bool:
    """The GPT-NeoX layout (``_is_neox_state_dict`` :508)."""
    return any(_NEOX_QKV_RE.search(k) for k in state_dict)


def _checked(params: Dict[str, torch.Tensor], cfg: ModelConfig,
             dtype) -> Dict[str, torch.Tensor]:
    """``params`` in ``dtype``, each with the name and shape of the
    port's model of ``cfg``, and every parameter given."""
    want = {n: tuple(p.shape) for n, p in
            TransformerLM(cfg, device="meta").named_parameters()}
    if set(params) != set(want):
        raise KeyError(
            f"the converted tensors do not match the model: missing "
            f"{sorted(set(want) - set(params))[:5]}, unexpected "
            f"{sorted(set(params) - set(want))[:5]}")
    for n, t in params.items():
        if tuple(t.shape) != want[n]:
            raise ValueError(f"{n}: shape {list(t.shape)} != expected "
                             f"{list(want[n])}")
    return {n: t.to(dtype).contiguous() for n, t in params.items()}


def params_from_hf_state_dict(state_dict: Mapping[str, torch.Tensor],
                              cfg: ModelConfig,
                              dtype: Optional[torch.dtype] = None
                              ) -> Dict[str, torch.Tensor]:
    """The port's parameters (name -> tensor, in ``dtype``, default
    ``cfg.param_dtype``) of an HF ``state_dict`` (names with or without
    the ``model.`` prefix).  Every tensor must have a place and the
    shape ``cfg`` gives it, and every place must be filled; a tied
    model's ``lm_head.weight`` is dropped.  GPT-2's Conv1D layout and
    GPT-NeoX's packing take their own converters (JAX :515-530)."""
    dtype = dtype or cfg.param_dtype
    if any(k.endswith("attn.c_attn.weight") for k in state_dict):
        return _checked(_params_from_gpt2(state_dict, cfg), cfg, dtype)
    if _is_neox_state_dict(state_dict):
        return _checked(_params_from_neox(state_dict, cfg), cfg, dtype)
    plan = ingestion_plan(cfg, state_dict.keys())
    out: Dict[str, torch.Tensor] = {}
    seen = set()
    for name, t in state_dict.items():
        base, ent = plan_entry(plan, name)
        if ent is None:
            continue
        if base in seen:
            raise ValueError(f"duplicate tensor {name!r}")
        seen.add(base)
        if tuple(t.shape) != ent[1]:
            raise ValueError(f"{name}: shape {list(t.shape)} != expected "
                             f"{list(ent[1])}")
        if ent[0] is not None:
            for dst, part in plan_targets(ent[0], t.detach()):
                if isinstance(dst, Row):
                    # an expert's row of the stacked [e, ...] tensor
                    out.setdefault(dst.name, torch.empty(
                        (dst.count,) + tuple(part.shape),
                        dtype=dtype))[dst.index] = part
                else:
                    out[dst] = part.to(dtype).contiguous()
    missing = missing_tensors(plan, seen)
    if missing:
        raise KeyError(f"state_dict is missing {len(missing)} expected "
                       f"tensors, first: {missing[:5]}")
    return out


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the local checkpoint directory ``path``, on the
    CPU: its safetensors files through the port's reader, else its
    ``pytorch_model*.bin`` files through ``torch.load(weights_only=
    True)`` (where the JAX package falls back to ``from_pretrained``)."""
    files = resolve_checkpoint_files(path)
    out: Dict[str, torch.Tensor] = {}
    if files is not None:
        for fpath in files:
            with SafetensorsFile(fpath) as f:
                out.update((n, f.get_tensor(n)) for n in f.keys())
        return out
    idx = os.path.join(path, "pytorch_model.bin.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            bins = sorted({os.path.join(path, v) for v in
                           json.load(f)["weight_map"].values()})
    else:
        bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(
            f"{path}: no model.safetensors, safetensors index or "
            f"pytorch_model*.bin")
    for fpath in bins:
        out.update(torch.load(fpath, map_location="cpu", weights_only=True))
    return out


def check_local_dir(path: str) -> None:
    """A checkpoint path must be a local directory: the port fetches
    nothing (the JAX package would call ``from_pretrained``)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local directory: torchacc_tpu_torch reads "
            f"Hugging Face checkpoints from local directories only "
            f"(config.json and safetensors or pytorch_model*.bin)")


def load_hf_model(model_or_path: Any, **config_overrides
                  ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """``(ModelConfig, parameters)`` of an HF model object (anything with
    ``.config`` and ``.state_dict()``) or of a local checkpoint
    directory; the parameters are CPU tensors in ``param_dtype`` by the
    port's names, ready for ``Trainer.init_from_params``."""
    if isinstance(model_or_path, (str, os.PathLike)):
        path = os.fspath(model_or_path)
        check_local_dir(path)
        cfg = config_from_hf(read_hf_config(path), **config_overrides)
        sd = read_state_dict(path)
    else:
        cfg = config_from_hf(model_or_path.config, **config_overrides)
        sd = model_or_path.state_dict()
    return cfg, params_from_hf_state_dict(sd, cfg)
