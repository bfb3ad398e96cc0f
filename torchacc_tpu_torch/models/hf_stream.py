"""Hugging Face checkpoints read from disk (the port of torchacc_tpu/
models/hf_stream.py: ``resolve_checkpoint_files`` :292,
``checkpoint_tensor_names`` :307, ``stream_params`` :370), with the
port's own readers of the two files a checkpoint directory holds.

The JAX package reads ``config.json`` through ``transformers`` and the
weights through ``safetensors``; the port imports neither (ROADMAP.md
C2):

- ``read_hf_config`` reads ``config.json`` into an attribute namespace,
  which ``models.hf.config_from_hf`` reads with ``getattr`` as it reads
  a ``PretrainedConfig``;
- ``SafetensorsFile`` reads the safetensors format: an 8-byte
  little-endian header length, a JSON header naming each tensor's
  dtype, shape and ``data_offsets`` (from the end of the header), then
  the raw little-endian bytes.  The file is memory-mapped (copy on
  write, so a tensor over it is writable and the file is never
  written), and a tensor is a view of its bytes until it is copied.
  BF16, F16 and F32 are read; any other dtype raises by name.

HF's tensors are ``nn.Linear``'s ``[out, in]``, the port's layout, so
the plan (``ingestion_plan``) is a renaming with shape checks, a split
of Phi-3's packed ``qkv_proj`` and ``gate_up_proj`` into row ranges,
one parameter each, and for a mixture of experts each expert's tensor
into its row of the stacked ``[e, ...]`` parameter (a :class:`Row`).  GPT-2's
Conv1D checkpoints, GPT-NeoX's packed attention and Phi's are not in
the plan's layout (``streamable_names``): as in JAX they go through the
materialising converter (``models.hf.load_hf_model``).
``stream_params`` copies one checkpoint tensor at a time straight into
the tensor the trainer made for it: the parameter itself on one device,
or this rank's shard of it on a mesh (``parallel/sharding.py``'s plan;
each rank reads only its slice).  Host memory stays bounded by the
page cache of the mapped files, not by the model.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct
import types
from typing import (Any, Dict, Iterable, List, Mapping, NamedTuple,
                    Optional, Tuple)

import torch
from torch.distributed.tensor import DTensor

from torchacc_tpu_torch.models.transformer import (
    GATED,
    ModelConfig,
    has_ln2,
    norm_has_bias,
    post_norm,
)

#: safetensors dtype names the port reads
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}

# non-parameter buffers some exporters leave in state dicts
_IGNORE = re.compile(
    r"(rotary_emb\.inv_freq|masked_bias|attn\.bias|\.num_batches_tracked)$")


class Row(NamedTuple):
    """A plan destination: row ``index`` of the parameter ``name``,
    which stacks ``count`` such rows (a mixture of experts' expert)."""
    name: str
    index: int
    count: int


def _detect_moe_style(names) -> str:
    """'qwen' (``mlp.experts.N.gate_proj``) or 'mixtral'
    (``block_sparse_moe.experts.N.w1``), from the checkpoint's tensor
    names (JAX :284-289)."""
    return ("qwen" if any(".mlp.experts." in n for n in names)
            else "mixtral")


def read_hf_config(path: str) -> types.SimpleNamespace:
    """``<path>/config.json`` as an attribute namespace (nested objects,
    such as ``rope_scaling``, stay dicts)."""
    with open(os.path.join(path, "config.json")) as f:
        return types.SimpleNamespace(**json.load(f))


class SafetensorsFile:
    """One ``.safetensors`` file, memory-mapped: ``keys()`` in the
    header's order, ``shape(name)`` from the header, ``view(name)``
    a tensor over the mapped bytes (valid until :meth:`close`; copy it
    to keep it) and ``get_tensor(name)`` an owned copy."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (no "
                                 f"header length)")
            (n,) = struct.unpack("<Q", head)
            size = os.fstat(f.fileno()).st_size
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} exceeds the "
                                 f"file ({size} bytes)")
            header = json.loads(f.read(n))
            self._mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                        if size > 8 + n else None)
        self._base = 8 + n
        header.pop("__metadata__", None)
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int,
                                       int]] = {}
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(
                    f"{path}: tensor {name!r} has dtype {e['dtype']}; "
                    f"torchacc_tpu_torch reads {sorted(DTYPES)}")
            dtype = DTYPES[e["dtype"]]
            shape = tuple(int(s) for s in e["shape"])
            begin, end = (int(o) for o in e["data_offsets"])
            numel = 1
            for s in shape:
                numel *= s
            if end - begin != numel * dtype.itemsize or begin < 0 \
                    or self._base + end > size:
                raise ValueError(
                    f"{path}: tensor {name!r} ({e['dtype']} {list(shape)}) "
                    f"has data_offsets {[begin, end]} that do not fit it or "
                    f"the file")
            self._entries[name] = (dtype, shape, begin, numel)

    def keys(self) -> List[str]:
        return list(self._entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._entries[name][1]

    def view(self, name: str) -> torch.Tensor:
        dtype, shape, begin, numel = self._entries[name]
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._mm, dtype=dtype, count=numel,
                                offset=self._base + begin).view(shape)

    def get_tensor(self, name: str) -> torch.Tensor:
        return self.view(name).clone()

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def resolve_checkpoint_files(path: str) -> Optional[List[str]]:
    """The safetensors files under ``path`` (the shards an index names,
    or ``model.safetensors``), or None when it holds none."""
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(path, v) for v in weight_map.values()})
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return [single]
    return None


def checkpoint_tensor_names(path: str) -> Optional[List[str]]:
    """Every tensor name of the checkpoint: the index's ``weight_map``
    keys when there is one, else the files' headers."""
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            return sorted(json.load(f)["weight_map"])
    files = resolve_checkpoint_files(path)
    if files is None:
        return None
    names: List[str] = []
    for fpath in files:
        with SafetensorsFile(fpath) as f:
            names.extend(f.keys())
    return names


def ingestion_plan(cfg: ModelConfig, names: Iterable[str] = ()
                   ) -> Dict[str, Tuple[Any, Tuple[int, ...]]]:
    """HF tensor name (without the ``model.`` prefix) -> (the port's
    parameter name, or None for a tensor read and dropped, or for a
    packed tensor a tuple of ``(name, first row, end row)`` parts; the
    shape in the checkpoint) for the Llama, Qwen2/3, Mistral, Gemma,
    StarCoder2, Nemotron, Phi, Phi-3, Cohere and OLMo2 layouts: Phi-3's
    packed ``qkv_proj`` ([q | k | v] rows) and ``gate_up_proj`` ([gate |
    up] rows), chosen by the checkpoint's names as JAX's
    ``_detect_packed`` chooses them; Qwen3's and Gemma3's per-head
    ``q_norm``/``k_norm`` (OLMo2's over the flat projection, ``heads *
    d``); under OLMo2's post-norms ``post_attention_layernorm`` as
    ``ln1`` and ``post_feedforward_layernorm`` as ``ln2``, with no
    ``input_layernorm``; under Gemma2/3's sandwich norms
    ``post_attention_layernorm`` as the post-attention norm
    (``ln1_post``), ``pre_feedforward_layernorm`` as ``ln2`` and
    ``post_feedforward_layernorm`` as ``ln2_post``; a LayerNorm's
    ``.bias`` beside its ``.weight``; a non-gated MLP's ``up_proj``/
    ``down_proj`` (Nemotron), ``c_fc``/``c_proj`` (StarCoder2) or
    ``fc1``/``fc2`` (Phi, with ``self_attn.dense`` and
    ``final_layernorm``), chosen by the checkpoint's tensor ``names``
    as JAX's plan chooses them (``_detect_nongated``); a mixture of
    experts' router (``gate``) and experts, Mixtral's
    ``block_sparse_moe.experts.<j>.w1/w3/w2`` or Qwen3-MoE's
    ``mlp.experts.<j>.gate_proj/up_proj/down_proj`` as
    ``_detect_moe_style`` tells them apart, each expert's tensor a
    :class:`Row` of the stacked ``moe.experts.gate/up/down``.  A tied
    model's ``lm_head.weight``, which some exporters ship as a copy, is
    dropped."""
    h, L = cfg.hidden_size, cfg.num_layers
    nh, nk, d = cfg.num_heads, cfg.kv_heads, cfg.head_size
    f, v = cfg.ffn_size, cfg.vocab_size
    names = list(names)
    has = lambda suffix: any(n.endswith(suffix) for n in names)
    packed_qkv = has("self_attn.qkv_proj.weight")
    packed_mlp = has("mlp.gate_up_proj.weight")
    mlp_names = (("c_fc", "c_proj") if has("mlp.c_fc.weight")
                 else ("fc1", "fc2") if has("mlp.fc1.weight")
                 else ("up_proj", "down_proj"))
    o_name = "dense" if has("self_attn.dense.weight") else "o_proj"
    moe_src = (("mlp", ("gate_proj", "up_proj", "down_proj"))
               if _detect_moe_style(names) == "qwen"
               else ("block_sparse_moe", ("w1", "w3", "w2")))
    final = "final_layernorm" if has("final_layernorm.weight") else "norm"
    nb = norm_has_bias(cfg)
    plan: Dict[str, Tuple[Any, Tuple[int, ...]]] = {
        "embed_tokens.weight": ("embed_tokens.weight", (v, h)),
        "lm_head.weight": (None if cfg.tie_embeddings else "lm_head.weight",
                           (v, h)),
    }
    if cfg.head_bias:
        plan["lm_head.bias"] = ("lm_head.bias", (v,))

    def norm(src, dst):
        plan[src + ".weight"] = (dst + ".weight", (h,))
        if nb:
            plan[src + ".bias"] = (dst + ".bias", (h,))
    norm(final, "final_norm")
    for i in range(L):
        p = f"layers.{i}."                 # the same prefix in both names
        if post_norm(cfg):
            norm(p + "post_attention_layernorm", p + "ln1")
            norm(p + "post_feedforward_layernorm", p + "ln2")
        elif cfg.sandwich_norms:
            norm(p + "input_layernorm", p + "ln1")
            plan[p + "post_attention_layernorm.weight"] = (
                p + "ln1_post.weight", (h,))
            plan[p + "pre_feedforward_layernorm.weight"] = (p + "ln2.weight",
                                                            (h,))
            plan[p + "post_feedforward_layernorm.weight"] = (
                p + "ln2_post.weight", (h,))
        else:
            norm(p + "input_layernorm", p + "ln1")
            if has_ln2(cfg):
                norm(p + "post_attention_layernorm", p + "ln2")
        if cfg.qk_norm:
            for name, heads in (("q_norm", nh), ("k_norm", nk)):
                plan[f"{p}self_attn.{name}.weight"] = (
                    f"{p}attn.{name}.weight",
                    (heads * d if cfg.qk_norm_proj else d,))
        attn = [("q_proj", "q_proj", nh * d, h),
                ("k_proj", "k_proj", nk * d, h),
                ("v_proj", "v_proj", nk * d, h),
                (o_name, "o_proj", h, nh * d)]
        if packed_qkv:
            qr, kr = nh * d, nk * d
            plan[f"{p}self_attn.qkv_proj.weight"] = (
                _parts(p + "attn.", ("q_proj", "k_proj", "v_proj"),
                       (qr, kr, kr)), (qr + 2 * kr, h))
            attn = attn[3:]
        for src, name, rows, cols in attn:
            plan[f"{p}self_attn.{src}.weight"] = (
                f"{p}attn.{name}.weight", (rows, cols))
            if cfg.o_bias if name == "o_proj" else cfg.qkv_bias:
                plan[f"{p}self_attn.{src}.bias"] = (
                    f"{p}attn.{name}.bias", (rows,))
        if cfg.num_experts > 0:
            _plan_experts(plan, p, moe_src, cfg.num_experts, h, f)
            continue
        mlp = [(mlp_names[0], "up_proj", f, h),
               (mlp_names[1], "down_proj", h, f)]
        if cfg.activation in GATED:
            mlp.insert(0, ("gate_proj", "gate_proj", f, h))
        if packed_mlp:
            plan[f"{p}mlp.gate_up_proj.weight"] = (
                _parts(p + "mlp.", ("gate_proj", "up_proj"), (f, f)),
                (2 * f, h))
            mlp = mlp[-1:]
        for src, name, rows, cols in mlp:
            plan[f"{p}mlp.{src}.weight"] = (f"{p}mlp.{name}.weight",
                                            (rows, cols))
            if cfg.mlp_bias:
                plan[f"{p}mlp.{src}.bias"] = (f"{p}mlp.{name}.bias", (rows,))
    return plan


def _plan_experts(plan, p: str, src, e: int, h: int, f: int) -> None:
    """Layer ``p``'s router and experts in ``plan`` (``src``: the
    module's name and its gate, up and down names)."""
    mod, names = src
    plan[f"{p}{mod}.gate.weight"] = (f"{p}moe.router.weight", (e, h))
    for j in range(e):
        for name, dst, shape in zip(names, ("gate", "up", "down"),
                                    ((f, h), (f, h), (h, f))):
            plan[f"{p}{mod}.experts.{j}.{name}.weight"] = (
                Row(f"{p}moe.experts.{dst}", j, e), shape)


def _parts(prefix: str, names, rows) -> Tuple[Tuple[str, int, int], ...]:
    """The row ranges of a packed tensor: ``(prefix + name + ".weight",
    first row, end row)`` for each part, in order."""
    out, r = [], 0
    for name, n in zip(names, rows):
        out.append((f"{prefix}{name}.weight", r, r + n))
        r += n
    return tuple(out)


def plan_targets(dst, t: torch.Tensor):
    """``(destination, tensor)`` of each place the checkpoint tensor
    ``t`` fills under the plan destination ``dst``: a parameter name or
    a :class:`Row` of one, with ``t`` itself, or each part's name with
    its row range of a packed tensor."""
    if isinstance(dst, tuple) and not isinstance(dst, Row):
        return [(name, t[lo:hi]) for name, lo, hi in dst]
    return [(dst, t)]


def streamable_names(names: Iterable[str]) -> bool:
    """Whether a checkpoint is in the plan's layout, so that it streams
    (``streamable_names`` of the JAX package, :270): separate or Phi-3's
    packed q/k/v projections and not Phi's ``self_attn.dense``.  GPT-2's
    Conv1D ``c_attn`` and GPT-NeoX's ``query_key_value`` are not; they,
    and Phi, go through the materialising converter."""
    names = list(names)
    if any(n.endswith("self_attn.dense.weight") for n in names):
        return False
    return any(n.endswith(("self_attn.q_proj.weight",
                           "self_attn.qkv_proj.weight")) for n in names)


def plan_entry(plan, name: str):
    """(base name, plan entry) of a checkpoint tensor name, or (base,
    None) for a buffer that is skipped; an unmapped name raises."""
    base = name[6:] if name.startswith("model.") else name
    if _IGNORE.search(base):
        return base, None
    if base not in plan:
        raise KeyError(
            f"checkpoint tensor {name!r} has no place in this ModelConfig "
            f"(a family or layout torchacc_tpu_torch does not convert)")
    return base, plan[base]


def missing_tensors(plan, seen) -> List[str]:
    """The plan's tensors a checkpoint did not give (a tied model's
    ``lm_head.weight`` is never missing)."""
    return sorted(n for n, (dst, _) in plan.items()
                  if n not in seen and dst is not None)


def _box(dst: DTensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(offsets, sizes)`` of this rank's shard of ``dst``."""
    chunks = dst.__create_chunk_list__()
    if len(chunks) != 1:
        raise NotImplementedError(
            f"a DTensor whose shard is not one box ({len(chunks)} "
            f"chunks) cannot be filled from a full tensor")
    return tuple(chunks[0].offsets), tuple(chunks[0].sizes)


@torch.no_grad()
def copy_to(dest: Mapping[str, torch.Tensor], dst,
            src: torch.Tensor) -> None:
    """Write ``src`` into the plan destination ``dst`` of ``dest``: a
    parameter whole (:func:`copy_full`), or a :class:`Row` of one (on a
    mesh, where this rank's shard holds that row, its slice)."""
    if not isinstance(dst, Row):
        copy_full(dest[dst], src)
        return
    t = dest[dst.name]
    if not isinstance(t, DTensor):
        t[dst.index].copy_(src)
        return
    offs, sizes = _box(t)
    if offs[0] <= dst.index < offs[0] + sizes[0]:
        box = tuple(slice(o, o + n) for o, n in zip(offs[1:], sizes[1:]))
        t.to_local()[dst.index - offs[0]].copy_(src[box])


@torch.no_grad()
def copy_full(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write the full tensor ``src`` into ``dst``: a plain tensor takes
    all of it, a ``DTensor`` its local shard (the slice DCP would read
    for it), converted to ``dst``'s dtype and device."""
    if isinstance(dst, DTensor):
        offs, sizes = _box(dst)
        box = tuple(slice(o, o + n) for o, n in zip(offs, sizes))
        dst.to_local().copy_(src[box])
        return
    dst.copy_(src)


def stream_params(files: List[str], cfg: ModelConfig,
                  dest: Mapping[str, torch.Tensor]
                  ) -> Mapping[str, torch.Tensor]:
    """Fill ``dest`` (the port's parameter name -> the trainer's tensor,
    a ``DTensor`` on a mesh) from the safetensors ``files``, one tensor
    at a time in the files' order, each copied from the mapped file
    straight into its place (a shard reads only its slice).  Every
    checkpoint tensor must have a place in the plan of ``cfg`` and the
    shape it names, appear once, and every place must be filled; a
    packed tensor fills each of its parts (a shard reads its slice of
    each part's rows).  Under
    pipeline parallelism ``dest`` holds this stage's blocks and the
    parameters every stage holds; the other blocks' tensors are checked
    and skipped.  Returns ``dest``."""
    names = []
    for fpath in files:
        with SafetensorsFile(fpath) as f:
            names.extend(f.keys())
    plan = ingestion_plan(cfg, names)
    seen = set()
    for fpath in files:
        with SafetensorsFile(fpath) as f:
            for name in f.keys():
                base, ent = plan_entry(plan, name)
                if ent is None:
                    continue
                if base in seen:
                    raise ValueError(f"duplicate tensor {name!r}")
                seen.add(base)
                if f.shape(name) != ent[1]:
                    raise ValueError(
                        f"{name}: checkpoint shape {list(f.shape(name))} != "
                        f"expected {list(ent[1])}")
                if ent[0] is None:
                    continue
                view = f.view(name)
                for dst, part in plan_targets(ent[0], view):
                    name = dst.name if isinstance(dst, Row) else dst
                    if name not in dest and name.startswith("layers."):
                        continue        # a block another stage holds
                    copy_to(dest, dst, part)
                del view, part
    missing = missing_tensors(plan, seen)
    if missing:
        raise ValueError(f"checkpoint is missing {len(missing)} expected "
                         f"tensors, first: {missing[:5]}")
    return dest
