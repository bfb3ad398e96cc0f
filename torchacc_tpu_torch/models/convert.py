"""Carry a flax ``TransformerLM`` param tree over into the port's
``TransformerLM`` (``params_from_jax``), so that both packages compute
the same function, and back (``params_to_jax``: port weights or
gradients in the flax layout, for comparing them leaf by leaf).

The tree is the JAX package's stacked ``scan_layers`` layout with numpy
leaves (``jax.tree.map(np.asarray, params)``)::

    embed_tokens.embedding               [V, h]
    pos_embed                            [max_seq_len, h]  (pos_emb='learned')
    layers.block.{ln1,ln2}.scale         [L, h]  (+ bias [L, h], LayerNorms;
                                                  no ln2 in a shared
                                                  parallel block)
    layers.block.{ln1_post,ln2_post}.scale [L, h]          (sandwich_norms)
    layers.block.attn.{q,k}_norm.scale   [L, d]            (qk_norm)
    layers.block.attn.{q,k,v}_proj.kernel [L, h, heads, d]  (+ bias [L, heads, d])
    layers.block.attn.o_proj.kernel      [L, heads, d, h]  (+ bias [L, h])
    layers.block.mlp.{gate,up}_proj.kernel [L, h, F]       (+ bias [L, F];
                                                  no gate when non-gated)
    layers.block.mlp.down_proj.kernel    [L, F, h]         (+ bias [L, h])
    layers.block.moe.router.kernel       [L, h, e]  (num_experts > 0, in
                                                   place of the mlp)
    layers.block.moe.experts/{gate,up}   [L, e, h, F]
    layers.block.moe.experts/down        [L, e, F, h]
    final_norm.scale                     [h]     (+ bias [h])
    lm_head.kernel                       [h, V]  (absent when tied; + bias
                                                  [V] under head_bias)

flax kernels are ``[in, out]``; ``nn.Linear`` weights are ``[out, in]``,
and so are the port's experts, per expert (``models/moe.py``
``Experts``: ``gate``/``up`` ``[e, F, h]``, ``down`` ``[e, h, F]``).
On a mesh, ``params_from_jax`` gives the full model that
``Trainer.init`` then shards (``parallel/sharding.py``), and
``params_to_jax`` gathers sharded parameters whole.

``quant_from_jax`` / ``quant_to_jax`` carry the delayed-scaling amax
histories of the quantized matmul sites the same way: the flax
``'quant'`` collection, which the JAX model keeps stacked over the
layers whether or not it scans them
(``layers.block.<attn|mlp>.<linear>.amax_history [L, len]``), and the
'head' site's ``lm_head.amax_history [len]``, against the port's
``TrainState.quant`` (``layers.<i>.<attn|mlp>.<linear>`` and ``lm_head``
-> ``[len]``).

``state_from_jax`` / ``state_to_jax`` carry a whole JAX ``TrainState``
(numpy leaves, as the JAX package restores a checkpoint host-side) into
the port's ``TrainState`` and back: the step, the f32 masters, the
AdamW moments and count out of optax's chain state, the fp16 scaler and
the amax histories.  So a JAX run's state can be saved by the port and
resumed by its Trainer.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from torchacc_tpu_torch.models.transformer import (
    ModelConfig,
    TransformerLM,
    norm_has_bias,
    has_ln2,
    mlp_linears,
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
    attn = blk["attn"]
    h = cfg.hidden_size
    model.embed_tokens.weight.copy_(
        _t(tree["embed_tokens"]["embedding"], device, dtype))
    if model.pos_embed is not None:
        model.pos_embed.weight.copy_(_t(tree["pos_embed"], device, dtype))
    for i, layer in enumerate(model.layers):
        for name in _block_norms(cfg):
            _norm_from(layer.get_submodule(name), blk[name],
                       lambda a: a[i], device, dtype)
        for name in _attn_norms(cfg):
            getattr(layer.attn, name).weight.copy_(
                _t(attn[name]["scale"][i], device, dtype))
        for name in ("q_proj", "k_proj", "v_proj"):
            lin = getattr(layer.attn, name)
            kern = np.asarray(attn[name]["kernel"][i])       # [h, heads, d]
            lin.weight.copy_(_t(kern.reshape(h, -1).T, device, dtype))
            if lin.bias is not None:
                lin.bias.copy_(_t(np.asarray(attn[name]["bias"][i])
                                  .reshape(-1), device, dtype))
        o = np.asarray(attn["o_proj"]["kernel"][i])          # [heads, d, h]
        layer.attn.o_proj.weight.copy_(_t(o.reshape(-1, h).T, device, dtype))
        if layer.attn.o_proj.bias is not None:
            layer.attn.o_proj.bias.copy_(
                _t(attn["o_proj"]["bias"][i], device, dtype))
        if cfg.num_experts > 0:
            moe = blk["moe"]
            layer.moe.router.weight.copy_(_t(
                np.asarray(moe["router"]["kernel"][i]).T, device, dtype))
            for name in _EXPERTS:
                getattr(layer.moe.experts, name).copy_(_t(np.swapaxes(
                    np.asarray(moe[f"experts/{name}"][i]), 1, 2), device,
                    dtype))
            continue
        mlp = blk["mlp"]
        for name in mlp_linears(cfg):
            lin = getattr(layer.mlp, name)
            lin.weight.copy_(
                _t(np.asarray(mlp[name]["kernel"][i]).T, device, dtype))
            if lin.bias is not None:
                lin.bias.copy_(_t(mlp[name]["bias"][i], device, dtype))
    _norm_from(model.final_norm, tree["final_norm"], lambda a: a, device,
               dtype)
    if model.lm_head is not None:
        model.lm_head.weight.copy_(
            _t(np.asarray(tree["lm_head"]["kernel"]).T, device, dtype))
        if model.lm_head.bias is not None:
            model.lm_head.bias.copy_(
                _t(tree["lm_head"]["bias"], device, dtype))
    return model.requires_grad_(trainable).train(trainable)


# the experts' leaves, JAX's experts/<name>
_EXPERTS = ("gate", "up", "down")


def _norm_from(mod, node, pick, device, dtype) -> None:
    """A norm module's scale (and LayerNorm bias) from the flax node
    ``{scale, bias}``, ``pick`` choosing the layer's row."""
    mod.weight.copy_(_t(pick(np.asarray(node["scale"])), device, dtype))
    if mod.bias is not None:
        mod.bias.copy_(_t(pick(np.asarray(node["bias"])), device, dtype))


def _block_norms(cfg: ModelConfig):
    """The norms of a block: no ``ln2`` in a parallel block sharing
    ``ln1``; Gemma2/3's sandwich adds two."""
    return (("ln1", "ln2") if has_ln2(cfg) else ("ln1",)) + (
        ("ln1_post", "ln2_post") if cfg.sandwich_norms else ())


def _attn_norms(cfg: ModelConfig):
    """The attention's per-head q and k norms (Qwen3, Gemma3)."""
    return ("q_norm", "k_norm") if cfg.qk_norm else ()


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
    for name in _attn_norms(cfg):
        attn[name] = {"scale": stack(
            lambda i: t(f"layers.{i}.attn.{name}.weight"))}
    if cfg.o_bias:
        attn["o_proj"]["bias"] = stack(
            lambda i: t(f"layers.{i}.attn.o_proj.bias"))
    if cfg.num_experts > 0:
        ffn = ("moe", {"router": {"kernel": stack(
            lambda i: t(f"layers.{i}.moe.router.weight").T)}})
        for name in _EXPERTS:
            ffn[1][f"experts/{name}"] = stack(lambda i: np.swapaxes(
                t(f"layers.{i}.moe.experts.{name}"), 1, 2))
    else:
        mlp = {name: {"kernel": stack(
            lambda i: t(f"layers.{i}.mlp.{name}.weight").T)}
            for name in mlp_linears(cfg)}
        if cfg.mlp_bias:
            for name in mlp:
                mlp[name]["bias"] = stack(
                    lambda i: t(f"layers.{i}.mlp.{name}.bias"))
        ffn = ("mlp", mlp)

    def norm_node(f):
        node = {"scale": f("weight")}
        if norm_has_bias(cfg):
            node["bias"] = f("bias")
        return node
    tree = {
        "embed_tokens": {"embedding": t("embed_tokens.weight")},
        "layers": {"block": {
            **{name: norm_node(lambda leaf, name=name: stack(
                lambda i: t(f"layers.{i}.{name}.{leaf}")))
               for name in _block_norms(cfg)},
            "attn": attn, ffn[0]: ffn[1]}},
        "final_norm": norm_node(lambda leaf: t(f"final_norm.{leaf}")),
    }
    if cfg.pos_emb == "learned":
        tree["pos_embed"] = t("pos_embed.weight")
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": t("lm_head.weight").T}
        if cfg.head_bias:
            tree["lm_head"]["bias"] = t("lm_head.bias")
    return tree


def quant_from_jax(cfg: ModelConfig, tree: Mapping,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """The port's amax histories (``TrainState.quant``) from the flax
    ``'quant'`` collection ``tree`` (numpy leaves): the blocks' stacked
    ``layers/block/<site>/<linear>`` and the head's
    ``lm_head/amax_history``, on the card unless ``device`` says
    otherwise; None when ``cfg`` quantizes no site."""
    names = quant_site_names(cfg)
    if not names:
        return None
    device = resolve_device(device)
    out = {}
    for name in names:
        if name == "lm_head":
            hist = np.asarray(tree["lm_head"]["amax_history"])
        else:
            _, i, site, lin = name.split(".")
            hist = np.asarray(
                tree["layers"]["block"][site][lin]["amax_history"])[int(i)]
        if hist.shape != (cfg.quant_amax_history_len,):
            raise ValueError(
                f"{name}: history of shape {hist.shape}, expected "
                f"({cfg.quant_amax_history_len},)")
        out[name] = _t(hist, device, torch.float32)
    return out


def quant_to_jax(cfg: ModelConfig,
                 quant: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`quant_from_jax`: the flax ``'quant'``
    collection (the blocks' stacked ``[L, len]`` and the head's
    ``[len]`` f32 numpy leaves; a collection holds only the parts that
    quantize, as JAX's does)."""
    blk: Dict = {}
    out: Dict = {}
    for name in quant_site_names(cfg):
        hist = quant[name].detach().float().cpu().numpy()
        if name == "lm_head":
            out["lm_head"] = {"amax_history": hist}
            continue
        _, i, site, lin = name.split(".")
        rows = blk.setdefault(site, {}).setdefault(lin, [])
        assert len(rows) == int(i)
        rows.append(hist)
    if blk:
        out["layers"] = {"block": {
            site: {lin: {"amax_history": np.stack(rows)}
                   for lin, rows in lins.items()}
            for site, lins in blk.items()}}
    return out


def _field(node: Any, key: str) -> Any:
    return node[key] if isinstance(node, Mapping) else getattr(node, key)


def _find_adam(node: Any) -> Optional[Any]:
    """The node of optax's chain state that holds ``mu`` and ``nu``
    (``ScaleByAdamState``, or the dict a host-side restore makes of
    it)."""
    if isinstance(node, Mapping):
        if "mu" in node and "nu" in node:
            return node
        children = node.values()
    elif hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    elif isinstance(node, (list, tuple)):
        children = node
    else:
        return None
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def state_from_jax(cfg: ModelConfig, tree: Any,
                   device: Optional[Union[str, torch.device]] = None):
    """The port's ``TrainState`` of a JAX ``TrainState`` ``tree`` with
    numpy leaves (a host-side restore of a JAX checkpoint, or
    ``jax.device_get`` of a live state), on the card unless ``device``
    says otherwise: f32 masters and moments by the port's parameter
    names, the AdamW count, the step, the fp16 scaler and the amax
    histories."""
    from torchacc_tpu_torch.train.schedules import AdamWState
    from torchacc_tpu_torch.train.state import TrainState
    device = resolve_device(device)

    def named(params):
        model = params_from_jax(cfg, params, device=device,
                                dtype=torch.float32)
        return {n: p.detach() for n, p in model.named_parameters()}

    adam = _find_adam(_field(tree, "opt_state"))
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments "
                         "(mu, nu): the port's optimizer is AdamW")
    scaler = _field(tree, "scaler")
    if scaler is not None:
        scaler = {"scale": _t(_field(scaler, "scale"), device, torch.float32),
                  "growth_count": _t(_field(scaler, "growth_count"), device,
                                     torch.int32)}
    quant = _field(tree, "quant")
    return TrainState(
        step=int(np.asarray(_field(tree, "step"))),
        params=named(_field(tree, "params")),
        opt_state=AdamWState(mu=named(_field(adam, "mu")),
                             nu=named(_field(adam, "nu")),
                             count=int(np.asarray(_field(adam, "count")))),
        scaler=scaler,
        quant=None if quant is None else quant_from_jax(cfg, quant, device))


def state_to_jax(cfg: ModelConfig, state) -> Dict:
    """The inverse of :func:`state_from_jax`, for comparing leaf by leaf:
    ``{step, params, opt_state: {count, mu, nu}, scaler, quant}`` with
    the flax stacked layout and numpy leaves."""
    from torchacc_tpu_torch.train.state import adam_state
    opt = adam_state(state.opt_state)
    scaler = state.scaler
    return {
        "step": np.asarray(state.step, np.int32),
        "params": params_to_jax(cfg, state.params),
        "opt_state": {"count": np.asarray(opt.count, np.int32),
                      "mu": params_to_jax(cfg, opt.mu),
                      "nu": params_to_jax(cfg, opt.nu)},
        "scaler": None if scaler is None else {
            k: v.detach().cpu().numpy() for k, v in scaler.items()},
        "quant": (None if state.quant is None
                  else quant_to_jax(cfg, state.quant)),
    }
