"""Carry a flax ``TransformerLM`` param tree over into the port's
``TransformerLM`` (``params_from_jax``), so that both packages compute
the same function, and back (``params_to_jax``: port weights or
gradients in the flax layout, for comparing them leaf by leaf).

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
On a mesh, ``params_from_jax`` gives the full model that
``Trainer.init`` then shards (``parallel/sharding.py``), and
``params_to_jax`` gathers sharded parameters whole.

``quant_from_jax`` / ``quant_to_jax`` carry the delayed-scaling amax
histories of the quantized matmul sites the same way: the flax
``'quant'`` collection, which the JAX model keeps stacked over the
layers whether or not it scans them
(``layers.block.<attn|mlp>.<linear>.amax_history [L, len]``), against the
port's ``TrainState.quant`` (``layers.<i>.<attn|mlp>.<linear>`` ->
``[len]``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    TransformerLM,
    quant_site_names,
)
from torchacc_tpu_torch.ops._common import resolve_device


def _t(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, tree: Mapping,
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None,
                    trainable: bool = False) -> TransformerLM:
    """A port ``TransformerLM`` holding the weights of ``tree``, on the
    card unless ``device`` says otherwise (``None`` means CUDA and raises
    where there is no card).  ``trainable`` gives masters to train: in
    ``cfg.param_dtype`` (f32) unless ``dtype`` says otherwise, with
    ``requires_grad`` on and the module in train mode; otherwise the
    weights are frozen and the module is in eval mode."""
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
    return model.requires_grad_(trainable).train(trainable)


def params_to_jax(cfg: ModelConfig,
                  named: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`params_from_jax`: ``{port parameter name:
    tensor}`` (``model.named_parameters()``, or the same names mapped to
    gradients) as a flax stacked-layout tree of f32 numpy arrays.  A
    sharded ``DTensor`` is gathered whole (``full_tensor``, a collective:
    every rank of its mesh calls this, in the same order)."""
    t = lambda n: _full(named[n]).detach().float().cpu().numpy()
    h, d = cfg.hidden_size, cfg.head_size
    heads = {"q_proj": cfg.num_heads, "k_proj": cfg.kv_heads,
             "v_proj": cfg.kv_heads}
    layers = range(cfg.num_layers)
    stack = lambda f: np.stack([f(i) for i in layers])
    attn = {}
    for name, nh in heads.items():
        attn[name] = {"kernel": stack(lambda i: t(
            f"layers.{i}.attn.{name}.weight").T.reshape(h, nh, d))}
        if cfg.qkv_bias:
            attn[name]["bias"] = stack(lambda i: t(
                f"layers.{i}.attn.{name}.bias").reshape(nh, d))
    attn["o_proj"] = {"kernel": stack(lambda i: t(
        f"layers.{i}.attn.o_proj.weight").T.reshape(cfg.num_heads, d, h))}
    mlp = {name: {"kernel": stack(lambda i: t(f"layers.{i}.mlp.{name}.weight").T)}
           for name in ("gate_proj", "up_proj", "down_proj")}
    tree = {
        "embed_tokens": {"embedding": t("embed_tokens.weight")},
        "layers": {"block": {
            "ln1": {"scale": stack(lambda i: t(f"layers.{i}.ln1.weight"))},
            "ln2": {"scale": stack(lambda i: t(f"layers.{i}.ln2.weight"))},
            "attn": attn, "mlp": mlp}},
        "final_norm": {"scale": t("final_norm.weight")},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": t("lm_head.weight").T}
    return tree


def quant_from_jax(cfg: ModelConfig, tree: Mapping,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """The port's amax histories (``TrainState.quant``) from the flax
    ``'quant'`` collection ``tree`` (numpy leaves), on the card unless
    ``device`` says otherwise; None when ``cfg`` quantizes no site."""
    names = quant_site_names(cfg)
    if not names:
        return None
    device = resolve_device(device)
    blk = tree["layers"]["block"]
    out = {}
    for name in names:
        _, i, site, lin = name.split(".")
        hist = np.asarray(blk[site][lin]["amax_history"])[int(i)]
        if hist.shape != (cfg.quant_amax_history_len,):
            raise ValueError(
                f"{name}: history of shape {hist.shape}, expected "
                f"({cfg.quant_amax_history_len},)")
        out[name] = _t(hist, device, torch.float32)
    return out


def quant_to_jax(cfg: ModelConfig,
                 quant: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`quant_from_jax`: the flax ``'quant'``
    collection (stacked ``[L, len]`` f32 numpy leaves)."""
    blk: Dict = {}
    for name in quant_site_names(cfg):
        _, i, site, lin = name.split(".")
        rows = blk.setdefault(site, {}).setdefault(lin, [])
        assert len(rows) == int(i)
        rows.append(quant[name].detach().float().cpu().numpy())
    return {"layers": {"block": {
        site: {lin: {"amax_history": np.stack(rows)}
               for lin, rows in lins.items()}
        for site, lins in blk.items()}}}
