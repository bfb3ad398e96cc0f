"""Hugging Face models into the port (the port of torchacc_tpu/models/
hf.py: ``config_from_hf`` :37, ``params_from_hf_state_dict`` :515 and
``load_hf_model`` :723), for the families whose forward the port runs:
Llama 1/2/3/3.1/3.2 (with ``attention_bias``, ``mlp_bias`` and the
``llama3`` and ``linear`` rope scalings), Qwen2 (qkv bias), Qwen3
(per-head qk-norm), Mistral (a sliding window), Gemma v1 (1 + w
RMSNorm, GeGLU, scaled embeddings), Gemma2 (sandwich norms, the
sliding/global pattern, softcaps) and Gemma3 (qk-norm, the 5:1 pattern
with a local rope base, linear scaling on the global layers).

Every other ``model_type`` and rope scaling raises
``NotImplementedError`` naming it and the ROADMAP item that brings it
(A10b-2: the rest of the dense forward; A10c: mixture of experts), so
nothing converts silently wrong.  HF's weights are ``[out, in]``, the
port's layout: the conversion renames and checks shapes
(``hf_stream.ingestion_plan``) and never goes through the JAX package's
``[in, heads, d]`` layout.  An HF model object is read through its
``.config`` and ``.state_dict()`` alone, so neither ``transformers`` nor
``safetensors`` is imported.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from torchacc_tpu_torch.models.hf_stream import (
    SafetensorsFile,
    ingestion_plan,
    missing_tensors,
    plan_entry,
    read_hf_config,
    resolve_checkpoint_files,
)
from torchacc_tpu_torch.models.transformer import ModelConfig

#: model types whose forward the port runs
SUPPORTED = ("llama", "qwen2", "qwen3", "mistral", "gemma", "gemma2",
             "gemma3", "gemma3_text")
# mixture-of-experts families wait for A10c, every other family for
# A10b-2
_MOE_TYPES = ("mixtral", "qwen2_moe", "qwen3_moe", "deepseek_v2",
              "deepseek_v3", "dbrx", "olmoe", "jamba")


def config_from_hf(hf_config: Any, **overrides) -> ModelConfig:
    """``ModelConfig`` from a transformers ``PretrainedConfig`` or the
    namespace ``hf_stream.read_hf_config`` makes of ``config.json``
    (``SUPPORTED``), field for field as JAX's (:37); ``overrides``
    (``dtype``, ``param_dtype``, ...) are applied last."""
    get = lambda n, d=None: getattr(hf_config, n, d)
    mt = get("model_type")
    if mt in _MOE_TYPES:
        raise NotImplementedError(
            f"Hugging Face model_type {mt!r} (mixture of experts) is not "
            f"ported to torchacc_tpu_torch yet (ROADMAP A10c); it converts "
            f"{', '.join(SUPPORTED)}")
    if mt not in SUPPORTED:
        raise NotImplementedError(
            f"Hugging Face model_type {mt!r} is not ported to "
            f"torchacc_tpu_torch yet (ROADMAP A10b-2); it converts "
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
        # transformers' own default, True, as Gemma's configs are
        tie_embeddings=bool(get("tie_word_embeddings",
                                mt.startswith("gemma"))),
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
        elif rt != "default":
            raise NotImplementedError(
                f"rope_scaling type {rt!r} is not ported to "
                f"torchacc_tpu_torch yet (ROADMAP A10b-2); it implements "
                f"linear and llama3")
    if get("final_logit_softcapping"):
        kw["logit_softcap"] = float(get("final_logit_softcapping"))
    if get("sliding_window") and get("use_sliding_window", True):
        # HF attends kv > q - sliding_window (sliding_window keys); the
        # window (left, right) attends kv >= q - left: left is one less
        kw["window"] = (int(get("sliding_window")) - 1, -1)
    kw.update(overrides)
    return ModelConfig(**kw)


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


def params_from_hf_state_dict(state_dict: Mapping[str, torch.Tensor],
                              cfg: ModelConfig,
                              dtype: Optional[torch.dtype] = None
                              ) -> Dict[str, torch.Tensor]:
    """The port's parameters (name -> tensor, in ``dtype``, default
    ``cfg.param_dtype``) of an HF Llama/Qwen2 ``state_dict`` (names with
    or without the ``model.`` prefix).  Every tensor must have a place
    and the shape ``cfg`` gives it, and every place must be filled; a
    tied model's ``lm_head.weight`` is dropped."""
    dtype = dtype or cfg.param_dtype
    plan = ingestion_plan(cfg)
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
            out[ent[0]] = t.detach().to(dtype)
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
