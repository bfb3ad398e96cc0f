"""Token embedding, the sampling rules of the serving path and
``generate`` (the port of torchacc_tpu/models/generate.py ``_zoo_embed``,
``_sample``, in the per-slot form of ``serve/scheduler.py::
_sample_slots``, and ``generate`` :135).

``generate`` decodes over a dense KV cache, ``[b, prompt + new, kv
heads, d]`` a layer: one forward over the prompt banks every layer's
rotated k and raw v, then one loop takes a token at a time.  Each layer
takes its own window and rope base under a ``layer_pattern`` (JAX's
``_generate_cached_pattern``, :431), so Gemma2/3's sliding and global
layers decode through the cache on the attention kernels; ALiBi's
slopes, the parallel residual, the non-gated MLPs, learned positions,
the head bias, post-norms, the flat qk-norm, ``logit_scale``, the rope
scalings and the mixtures of experts decode the same way; under longrope a decode that
crosses the original context rebuilds the cache (JAX :260-303).  It shares
no code with the paged serving path (``serve/scheduler.py``), so it is
the port's own request-level reference for serving.  A ragged batch
of left-padded prompts (``prompt_mask``) decodes each row at its own
positions, its pads masked by the attention's segment ids; the
recompute path (``use_cache=False``), ``param_dtype`` and the pipelined
decode (``parallel/pp.py`` ``pp_forward_with_cache``: the cache of each
stage's blocks stays on that stage) are JAX's too.

Greedy decoding (temperature <= 0) is ``argmax`` — the first maximum,
as in JAX — and token-identical to the JAX package given the same
logits.  Sampling cannot reproduce JAX's PRNG keys, so it draws its own
noise: a counter-based hash of ``(request seed, token position, vocab
index)`` feeds Gumbel-max, on the device.  A sampled token is therefore
a function of the request's seed, its prompt and the weights only —
never of its batch-mates or of the slot it landed in.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from torchacc_tpu_torch.ops._common import to_local

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_B_PRIME = 0x85EBCA6B


def _mulmod32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for uint32 values held in int64, in two
    16-bit halves of ``m`` so that no product leaves 48 bits."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``[S, vocab]`` f32 Gumbel(0, 1) noise, a pure function of each
    row's (seed, counter) and the vocab index."""
    seeds = seeds.to(torch.int64) & _MASK32
    counters = counters.to(torch.int64) & _MASK32
    row = _mix32((_mix32(seeds) + _mulmod32(counters, _GOLDEN)) & _MASK32)
    col = _mulmod32(torch.arange(vocab, dtype=torch.int64,
                                 device=seeds.device), _B_PRIME)
    bits = _mix32(row[:, None] ^ col[None, :])
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))      # (0, 1)
    return -torch.log(-torch.log(u))


def embed_extras(cfg, x: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 table=None) -> torch.Tensor:
    """``_embed_extras`` (:1296) on the embedding ``x`` in the compute
    dtype: under Gemma's ``embed_scale`` times sqrt(hidden), rounded to
    the compute dtype first, as JAX and HF do; under learned positions
    the rows ``positions`` of ``table`` (the model's ``pos_embed``, an
    ``nn.Embedding``) in the compute dtype added."""
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    if cfg.pos_emb == "learned":
        x = x + to_local(table.weight).to(cfg.dtype)[positions.long()]
    return x


def embed(cfg, model, ids: torch.Tensor,
          positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding in the compute dtype with :func:`embed_extras`
    (``_zoo_embed``) at ``positions`` (read only under learned
    positions).  int32 ids (the packed batches' dtype) are read as they
    are."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.long()
    return embed_extras(
        cfg, F.embedding(ids, to_local(model.embed_tokens.weight))
        .to(cfg.dtype),
        positions, model.pos_embed)


def sample_slots(logits: torch.Tensor, temp: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 seeds: torch.Tensor, counters: torch.Tensor
                 ) -> torch.Tensor:
    """Per-slot sampling of ``logits [S, V]`` with per-slot temperature,
    top-k and top-p (``_sample_slots``): temperature <= 0 is exact
    greedy; top-k keeps logits >= the k-th largest (k <= 0 or >= V is
    off); top-p keeps the smallest descending prefix whose probability
    reaches top_p, always keeping the argmax, and is off at top_p >= 1.
    Returns int32 ``[S]``."""
    v = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    l = logits / temp.clamp_min(1e-6)[:, None]
    sorted_l = l.sort(dim=-1, descending=True).values
    kidx = (torch.where((top_k <= 0) | (top_k >= v), v, top_k) - 1
            ).clamp(0, v - 1)
    kth = sorted_l.gather(1, kidx[:, None].long())
    l = torch.where(l < kth, -torch.inf, l)
    sorted2 = l.sort(dim=-1, descending=True).values
    probs = torch.softmax(sorted2, dim=-1)
    cum = probs.cumsum(dim=-1)
    keep = cum - probs < top_p[:, None]
    keep[:, 0] = True
    pth = torch.where(keep, sorted2, torch.inf).amin(dim=-1, keepdim=True)
    l = torch.where((l < pth) & (top_p[:, None] < 1.0), -torch.inf, l)
    sampled = (l + gumbel_noise(seeds, counters, v)).argmax(dim=-1)
    return torch.where(temp <= 0, greedy, sampled).to(torch.int32)


def check_prompt_mask(prompt_mask, b: int, p: int,
                      device) -> Optional[torch.Tensor]:
    """``prompt_mask`` as int32 ``[b, p]`` on ``device`` after JAX's
    checks (:187-201): the shape, and a left-padded mask (no 0 after a
    1 in a row, the last column real)."""
    if prompt_mask is None:
        return None
    m = torch.as_tensor(prompt_mask).to(torch.int32)
    if tuple(m.shape) != (b, p):
        raise ValueError(f"prompt_mask shape {tuple(m.shape)} != {(b, p)}")
    host = m.cpu()
    if not bool((host.diff(dim=1) >= 0).all()):
        raise ValueError(
            "prompt_mask must be LEFT-padded (real tokens right-aligned): "
            "found a 0 after a 1")
    if not bool(host[:, -1].all()):
        raise ValueError("prompt_mask: last column must be real "
                         "(left-padding)")
    return m.to(device)


def prompt_geometry(ids: torch.Tensor, mask: Optional[torch.Tensor]):
    """``(positions [b, p], row_len [b], seg)`` of a left-padded prompt
    batch (``_prompt_geometry`` :55): row i's real tokens sit at
    positions ``0..row_len_i - 1`` (``cumsum(mask) - 1``, pads clipped
    to 0) and ``seg`` is the mask itself (pad 0, real 1; None without a
    mask)."""
    b, p = ids.shape
    if mask is None:
        return (torch.arange(p, device=ids.device).expand(b, p),
                torch.full((b,), p, dtype=torch.int64, device=ids.device),
                None)
    return ((mask.cumsum(dim=1) - 1).clamp_min(0), mask.sum(dim=1).long(),
            mask)


class KVCache:
    """The dense KV cache of the layers one process runs: ``k[i]`` and
    ``v[i]`` ``[b, total, kv heads, d]`` for each global layer index i
    it holds, and for a ragged batch ``seg [b, total]`` int32, the
    slots' segment ids (the prompt mask, then 1 for every generated
    slot: JAX's banked 'seg' cache)."""

    def __init__(self, cfg, layers, b: int, total: int, device,
                 seg: Optional[torch.Tensor] = None):
        shape = (b, total, cfg.kv_heads, cfg.head_size)
        self.k = {i: torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for i in layers}
        self.v = {i: torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for i in layers}
        self.seg = None
        if seg is not None:
            self.seg = torch.ones((b, total), dtype=torch.int32,
                                  device=device)
            self.seg[:, :seg.shape[1]] = seg


def _cached_forward(model, ids: torch.Tensor, start: int, cache: KVCache,
                    impl: str, positions: torch.Tensor, layers=None,
                    hidden: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hidden after the blocks ``layers`` (global indices; all of
    them when None) of the tokens at cache slots ``start..start + t``,
    from the embedding of ``ids [b, t]`` at ``positions [b, t]`` or
    from ``hidden`` (a pipeline stage's input).  Each layer's rotated
    k and raw v are written into its cache at those slots and
    attention reads the cache up to them (causal, aligned to the
    cache's end, where ALiBi and the window read their distances too);
    a ragged batch's pads are masked by the cache's segment ids, the
    queries' taken from the same slots.  Longrope's switch reads these
    positions alone, as JAX's cached forward does.  Each layer runs
    with its own config (``pattern_cfg``: its window and rope base), as
    JAX's ``_pattern_layers_with_cache`` does.  A mixture of experts'
    MLP routes the call's tokens alone: under capacity dispatch the cap
    is that of ``b * t`` tokens, as in JAX's cached forward."""
    from torchacc_tpu_torch.models.transformer import (
        apply_norm,
        block_mlp,
        dense,
        has_ln2,
        layer_slopes,
        pattern_cfg,
        post_norm,
        qk_rope,
    )
    from torchacc_tpu_torch.ops.attn import attention
    base = model.cfg
    b, t = positions.shape
    d, end = base.head_size, start + t
    x = embed(base, model, ids, positions) if hidden is None else hidden
    qseg = kseg = None
    if cache.seg is not None:
        qseg = cache.seg[:, start:end].contiguous()
        kseg = cache.seg[:, :end].contiguous()
    for i in range(base.num_layers) if layers is None else layers:
        layer = model.layers[i]
        cfg = pattern_cfg(base, i)
        post = post_norm(cfg)
        h = x if post else apply_norm(cfg, x, layer.ln1)
        a = layer.attn
        q = dense(cfg, h, a.q_proj).view(b, t, -1, d)
        k = dense(cfg, h, a.k_proj).view(b, t, -1, d)
        v = dense(cfg, h, a.v_proj).view(b, t, -1, d)
        q, k = qk_rope(cfg, a, q, k, positions)
        cache.k[i][:, start:end] = k
        cache.v[i][:, start:end] = v
        out = attention(q, cache.k[i][:, :end].contiguous(),
                        cache.v[i][:, :end].contiguous(), causal=True,
                        window=cfg.window, scale=cfg.query_scale,
                        q_segment_ids=qseg, kv_segment_ids=kseg,
                        alibi_slopes=layer_slopes(cfg, q),
                        logit_softcap=cfg.attn_logit_softcap, impl=impl)
        o = dense(cfg, out.reshape(b, t, -1), a.o_proj)
        if cfg.parallel_block:
            m_in = apply_norm(cfg, x, layer.ln2) if has_ln2(cfg) else h
            x = x + o + block_mlp(cfg, layer, m_in)
            continue
        if cfg.sandwich_norms:
            o = apply_norm(cfg, o, layer.ln1_post)
        if post:
            o = apply_norm(cfg, o, layer.ln1)
        x = x + o
        f = block_mlp(cfg, layer, x if post else
                      apply_norm(cfg, x, layer.ln2))
        if cfg.sandwich_norms:
            f = apply_norm(cfg, f, layer.ln2_post)
        if post:
            f = apply_norm(cfg, f, layer.ln2)
        x = x + f
    return x


class _Decoder:
    """The forward of one decode: on one device every layer in turn;
    over a pipeline (``parallel.pp.pp_forward_with_cache``) this
    process's stages' chunks, the activation handed from stage to stage
    and the last stage's output shared with every stage.  ``cache``
    holds the layers this process runs, and no other."""

    def __init__(self, model, ring, b: int, total: int, device,
                 seg: Optional[torch.Tensor], impl: str):
        from torchacc_tpu_torch.parallel.pp import stage_layers
        cfg = model.cfg
        self.model, self.ring, self.impl = model, ring, impl
        if ring is None:
            self.chunks = None
            held = range(cfg.num_layers)
        else:
            self.chunks = {d: stage_layers(cfg.num_layers, ring.pp_size,
                                           ring.virtual, d)
                           for d in ring.stages}
            held = sorted(i for ch in self.chunks.values() for r in ch
                          for i in r)
        self.cache = KVCache(cfg, held, b, total, device, seg)

    def __call__(self, ids, positions, start: int) -> torch.Tensor:
        if self.ring is None:
            return _cached_forward(self.model, ids, start, self.cache,
                                   self.impl, positions)
        from torchacc_tpu_torch.parallel.pp import pp_forward_with_cache
        b, t = positions.shape
        cfg = self.model.cfg
        like = torch.empty((b, t, cfg.hidden_size), dtype=cfg.dtype,
                           device=positions.device)

        def chunk(d, c, x):
            return _cached_forward(self.model, ids, start, self.cache,
                                   self.impl, positions,
                                   layers=self.chunks[d][c], hidden=x)
        return pp_forward_with_cache(chunk, self.ring, like)


def _decode_ring(model, pipeline):
    """The pipeline a decode runs over: ``pipeline`` as given, else None
    (one device), which a model that holds one stage's blocks refuses."""
    from torchacc_tpu_torch.models.transformer import StageLayers
    if pipeline is None and isinstance(model.layers, StageLayers):
        raise ValueError(
            "this model holds one pipeline stage's blocks: pass the "
            "pipeline of its stages (generate(..., pipeline="
            "parallel.pp.decode_pipeline(trainer.mesh, cfg.pp_virtual, "
            "device)))")
    # a 'pp' config with no pipeline decodes as one device, as JAX
    # demotes it (:234-248): the blocks are the same either way
    return pipeline


@contextlib.contextmanager
def _decode_weights(model, param_dtype):
    """The model a decode reads: FSDP2's units (the root and the blocks
    held) unsharded once around the decode, since the cached forward
    reads the weights without FSDP2's hooks; a weight still sharded
    after that (over 'tp' or 'ep') raises by name, so that no kernel is
    fed a shard.  With ``param_dtype`` a copy of the weights in that
    dtype, cast once (JAX returns a new tree; the caller's model is
    never cast)."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor
    units = [m for m in (model, *model.layers) if isinstance(m, FSDPModule)]
    for m in units:
        m.unshard()
    try:
        for name, p in model.named_parameters():
            if isinstance(p, DTensor) and p.to_local().shape != p.shape:
                raise NotImplementedError(
                    f"generate() reads whole weights, but {name} is "
                    f"sharded over {p.device_mesh.mesh_dim_names} on this "
                    f"mesh ('tp' or 'ep'): decoding under tensor or expert "
                    f"parallelism is not ported to torchacc_tpu_torch yet "
                    f"(ROADMAP.md A2b-2)")
        yield model if param_dtype is None else _cast_copy(model,
                                                           param_dtype)
    finally:
        for m in units:
            m.reshard()


def _cast_copy(model, dtype: torch.dtype):
    """A new ``TransformerLM`` of ``model``'s config, blocks and process
    groups whose weights are ``model``'s cast to ``dtype``."""
    from torchacc_tpu_torch.models.transformer import (
        StageLayers,
        TransformerLM,
    )
    twin = TransformerLM(model.cfg, device="meta", dtype=dtype)
    if isinstance(model.layers, StageLayers):
        twin.layers = StageLayers({i: twin.layers[i]
                                   for i, _ in model.layers.items()})
    twin = twin.to_empty(device=model.device)
    src = dict(model.named_parameters())
    for name, p in twin.named_parameters():
        p.detach().copy_(to_local(src[name]))
    for attr in ("tp_group", "data_groups", "seq_group", "layout",
                 "pp_group"):
        setattr(twin, attr, getattr(model, attr))
    return twin.requires_grad_(False).eval()


@torch.no_grad()
def generate(model, prompt_ids, *, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             eos_id: Optional[int] = None, seed: int = 0,
             use_cache: bool = True, prompt_mask=None,
             param_dtype: Optional[torch.dtype] = None, pipeline=None,
             attention_impl: Optional[str] = None) -> torch.Tensor:
    """Decode ``max_new_tokens`` after ``prompt_ids [b, p]`` with a port
    ``TransformerLM`` (computing in ``cfg.dtype``); returns ``[b, p +
    max_new_tokens]`` on the model's device.  Temperature 0 is greedy
    (the first maximum, as JAX's ``argmax``); otherwise each token is
    drawn as the serving path draws it (``sample_slots``: top-k, top-p,
    the counter hash of ``(seed, position)``, the position being the
    row's own), so a row's tokens depend on its seed and prompt only.
    After ``eos_id`` a row repeats it.  ``attention_impl`` defaults to
    the model config's.  Prompt and new tokens must fit a learned
    position table (JAX :253-260).

    ``prompt_mask [b, p]`` (1 = real) decodes a ragged batch of
    left-padded prompts (JAX's checks and geometry): row i's tokens sit
    at its own positions and its pads are masked in the prefill and in
    every decode step by the attention's segment ids.
    ``use_cache=False`` recomputes the whole prefix for every token
    (JAX's ``_generate_recompute``) through the same forward.
    ``param_dtype`` decodes from a copy of the weights cast to it once.

    Under pipeline parallelism ``pipeline`` (a ``parallel.pp.Pipeline``:
    ``parallel.pp.decode_pipeline`` of the trainer's mesh, or every
    stage in one process) runs each token as one pass over the
    stages (``parallel.pp.pp_forward_with_cache``): each process keeps
    the KV cache of its own blocks only, the activation goes stage to
    stage, and every stage samples the same token from the last
    stage's output.  A model whose config has ``pp_size > 1`` but
    holds every block decodes as one device without them, as JAX
    demotes it.  FSDP2's shards are gathered once around the decode.

    Under longrope a decode that crosses the original context rebuilds
    the cache there (JAX :260-303, Phi-3's intended semantics): it
    decodes up to ``original + 1`` tokens, then runs the whole sequence
    so far again as a prompt, whose keys take the long factors, and
    continues from that cache; a row frozen at ``eos_id`` before the
    crossing stays frozen."""
    from torchacc_tpu_torch.models.transformer import check_composition
    cfg = model.cfg
    check_composition(cfg)
    dev = model.device
    ids = torch.as_tensor(prompt_ids, device=dev).long()
    if ids.ndim != 2 or ids.shape[1] < 1:
        raise ValueError(f"prompt_ids must be [b, p] with p >= 1, got "
                         f"{tuple(ids.shape)}")
    b, p = ids.shape
    mask = check_prompt_mask(prompt_mask, b, p, dev)
    if max_new_tokens <= 0:
        return ids
    total = p + max_new_tokens
    if cfg.pos_emb == "learned" and total > cfg.max_seq_len:
        raise ValueError(
            f"prompt + max_new_tokens = {total} exceeds the learned "
            f"position table max_seq_len {cfg.max_seq_len}")
    ring = _decode_ring(model, pipeline)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              eos_id=eos_id, seed=seed,
              impl=attention_impl or cfg.attention_impl)
    with _decode_weights(model, param_dtype) as m:
        if not use_cache:
            return _generate_recompute(m, ring, ids, mask, max_new_tokens,
                                       **kw)
        return _generate_cached(m, ring, ids, mask, max_new_tokens, **kw)


def _picker(model, b: int, temperature, top_k, top_p, seed):
    """``pick(x, counters)``: the next token of each row from the hidden
    ``x [b, t, h]``'s last column; ``counters [b]`` are the rows' true
    positions of the token drawn."""
    from torchacc_tpu_torch.models.transformer import head_logits
    cfg, dev = model.cfg, model.device
    vec = lambda x, dt: torch.full((b,), x, dtype=dt, device=dev)
    knobs = (vec(temperature, torch.float32), vec(top_k, torch.int32),
             vec(top_p, torch.float32), vec(seed, torch.int64))

    def pick(x, counters):
        logits = head_logits(cfg, model, x[:, -1:])[:, 0]
        if temperature <= 0:
            return logits.argmax(dim=-1)
        return sample_slots(logits, *knobs, counters).long()
    return pick


def _frozen(nxt, done, eos_id):
    """``nxt`` with the rows already at ``eos_id`` kept there, and the
    rows done after it."""
    if done is None:
        return nxt, None
    nxt = torch.where(done, eos_id, nxt)
    return nxt, done | (nxt == eos_id)


def _generate_cached(model, ring, ids, mask, max_new_tokens, *,
                     temperature, top_k, top_p, eos_id, seed, impl):
    cfg = model.cfg
    b, p = ids.shape
    lr = cfg.rope_longrope
    if lr is not None and p <= int(lr[2]) < p + max_new_tokens - 1:
        n1 = int(lr[2]) + 1 - p
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  eos_id=eos_id, seed=seed, impl=impl)
        first = _generate_cached(model, ring, ids, mask, n1, **kw)
        mask2 = None if mask is None else torch.cat(
            [mask, torch.ones((b, n1), dtype=mask.dtype,
                              device=mask.device)], dim=1)
        out = _generate_cached(model, ring, first, mask2,
                               max_new_tokens - n1, **kw)
        if eos_id is not None:
            # phase 2 has no done-state: rows frozen in phase 1 stay so
            done1 = first[:, -1] == eos_id
            out[:, p + n1:] = torch.where(done1[:, None], eos_id,
                                          out[:, p + n1:])
        return out
    positions, row_len, seg = prompt_geometry(ids, mask)
    forward = _Decoder(model, ring, b, p + max_new_tokens, ids.device, seg,
                       impl)
    pick = _picker(model, b, temperature, top_k, top_p, seed)
    # each row's first new token sits at its own position row_len
    tok = pick(forward(ids, positions, 0), row_len)
    done = (tok == eos_id) if eos_id is not None else None
    out = [tok]
    for slot in range(p, p + max_new_tokens - 1):
        # the token at cache slot ``slot`` is at row i's true position
        # row_len_i + (slot - p)
        pos1 = row_len + (slot - p)
        x = forward(tok[:, None], pos1[:, None], slot)
        tok, done = _frozen(pick(x, pos1 + 1), done, eos_id)
        out.append(tok)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


def _generate_recompute(model, ring, ids, mask, max_new_tokens, *,
                        temperature, top_k, top_p, eos_id, seed, impl):
    """JAX's ``_generate_recompute`` (:505): every token from one
    forward over the whole prefix so far (a fresh cache each time), the
    generated tokens real in the mask; a batch whose rows are all done
    stops early, its remaining tokens left 0 as JAX's buffer leaves
    them."""
    b, p = ids.shape
    pick = _picker(model, b, temperature, top_k, top_p, seed)
    tokens = ids
    done = torch.zeros(b, dtype=torch.bool, device=ids.device) \
        if eos_id is not None else None
    for i in range(max_new_tokens):
        m = None if mask is None else torch.cat(
            [mask, torch.ones((b, i), dtype=mask.dtype,
                              device=mask.device)], dim=1)
        positions, row_len, seg = prompt_geometry(tokens, m)
        forward = _Decoder(model, ring, b, p + i, ids.device, seg, impl)
        tok, done = _frozen(pick(forward(tokens, positions, 0), row_len),
                            done, eos_id)
        tokens = torch.cat([tokens, tok[:, None]], dim=1)
        if done is not None and bool(done.all()):
            rest = max_new_tokens - 1 - i
            return torch.cat([tokens, tokens.new_zeros((b, rest))], dim=1)
    return tokens
