"""Carry a flax ``TransformerLM`` param tree over into the port's
``TransformerLM``, so that both packages compute the same function.

The tree is the JAX package's stacked ``scan_layers`` layout with numpy
leaves (``jax.tree.map(np.asarray, params)``)::

    embed_tokens.embedding               [V, h]
    layers.block.{ln1,ln2}.scale         [L, h]
    layers.block.attn.{q,k,v}_proj.kernel [L, h, heads, d]  (+ bias [L, heads, d])
    layers.block.attn.o_proj.kernel      [L, heads, d, h]
    layers.block.mlp.{gate,up}_proj.kernel [L, h, F]
    layers.block.mlp.down_proj.kernel    [L, F, h]
    final_norm.scale                     [h]
    lm_head.kernel                       [h, V]   (absent when tied)

flax kernels are ``[in, out]``; ``nn.Linear`` weights are ``[out, in]``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from torchacc_tpu_torch.models.transformer import ModelConfig, TransformerLM
from torchacc_tpu_torch.ops._common import resolve_device


def _t(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, tree: Mapping,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> TransformerLM:
    """A port ``TransformerLM`` holding the weights of ``tree``, on the
    card unless ``device`` says otherwise (``None`` means CUDA and raises
    where there is no card)."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    model = TransformerLM(cfg, device="meta", dtype=dtype)
    model = model.to_empty(device=device)
    blk = tree["layers"]["block"]
    attn, mlp = blk["attn"], blk["mlp"]
    h = cfg.hidden_size
    model.embed_tokens.weight.copy_(
        _t(tree["embed_tokens"]["embedding"], device, dtype))
    for i, layer in enumerate(model.layers):
        layer.ln1.weight.copy_(_t(blk["ln1"]["scale"][i], device, dtype))
        layer.ln2.weight.copy_(_t(blk["ln2"]["scale"][i], device, dtype))
        for name in ("q_proj", "k_proj", "v_proj"):
            lin = getattr(layer.attn, name)
            kern = np.asarray(attn[name]["kernel"][i])       # [h, heads, d]
            lin.weight.copy_(_t(kern.reshape(h, -1).T, device, dtype))
            if lin.bias is not None:
                lin.bias.copy_(_t(np.asarray(attn[name]["bias"][i])
                                  .reshape(-1), device, dtype))
        o = np.asarray(attn["o_proj"]["kernel"][i])          # [heads, d, h]
        layer.attn.o_proj.weight.copy_(_t(o.reshape(-1, h).T, device, dtype))
        for name in ("gate_proj", "up_proj", "down_proj"):
            getattr(layer.mlp, name).weight.copy_(
                _t(np.asarray(mlp[name]["kernel"][i]).T, device, dtype))
    model.final_norm.weight.copy_(
        _t(tree["final_norm"]["scale"], device, dtype))
    if model.lm_head is not None:
        model.lm_head.weight.copy_(
            _t(np.asarray(tree["lm_head"]["kernel"]).T, device, dtype))
    return model.requires_grad_(False).eval()
