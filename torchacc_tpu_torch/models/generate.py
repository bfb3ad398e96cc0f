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
the port's own request-level reference for serving.  Prompts of one
call have one length (JAX's left-padded ragged batches, ``prompt_mask``,
are not ported).

Greedy decoding (temperature <= 0) is ``argmax`` — the first maximum,
as in JAX — and token-identical to the JAX package given the same
logits.  Sampling cannot reproduce JAX's PRNG keys, so it draws its own
noise: a counter-based hash of ``(request seed, token position, vocab
index)`` feeds Gumbel-max, on the device.  A sampled token is therefore
a function of the request's seed, its prompt and the weights only —
never of its batch-mates or of the slot it landed in.
"""

from __future__ import annotations

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


def _cached_forward(model, ids: torch.Tensor, start: int, cache_k, cache_v,
                    impl: str) -> torch.Tensor:
    """The hidden after every layer of the tokens ``ids [b, t]`` at
    positions ``start..start + t``; each layer's k/v are written into
    its cache at those positions and attention reads the cache up to
    them (causal, aligned to the cache's end, where ALiBi reads its
    distances too).  Longrope's switch reads these positions alone, as
    JAX's cached forward does: a prefill past the original context, or
    a decode step beyond it, takes the long factors.  Each layer runs with its own config
    (``pattern_cfg``: its window and rope base), as JAX's
    ``_pattern_layers_with_cache`` does.  A mixture of experts' MLP routes
the call's tokens alone: under capacity dispatch the cap is that of
``b * t`` tokens, as in JAX's cached forward."""
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
    b, t = ids.shape
    d, end = base.head_size, start + t
    pos = torch.arange(start, end, device=ids.device).expand(b, t)
    x = embed(base, model, ids, pos)
    for i, layer in enumerate(model.layers):
        cfg = pattern_cfg(base, i)
        post = post_norm(cfg)
        h = x if post else apply_norm(cfg, x, layer.ln1)
        a = layer.attn
        q = dense(cfg, h, a.q_proj).view(b, t, -1, d)
        k = dense(cfg, h, a.k_proj).view(b, t, -1, d)
        v = dense(cfg, h, a.v_proj).view(b, t, -1, d)
        q, k = qk_rope(cfg, a, q, k, pos)
        cache_k[i][:, start:end] = k
        cache_v[i][:, start:end] = v
        out = attention(q, cache_k[i][:, :end].contiguous(),
                        cache_v[i][:, :end].contiguous(), causal=True,
                        window=cfg.window, scale=cfg.query_scale,
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


@torch.no_grad()
def generate(model, prompt_ids, *, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             eos_id: Optional[int] = None, seed: int = 0,
             attention_impl: Optional[str] = None) -> torch.Tensor:
    """Decode ``max_new_tokens`` after ``prompt_ids [b, p]`` with a port
    ``TransformerLM`` (its weights as they are, computing in
    ``cfg.dtype``); returns ``[b, p + max_new_tokens]`` on the model's
    device.  Temperature 0 is greedy (the first maximum, as JAX's
    ``argmax``); otherwise each token is drawn as the serving path draws
    it (``sample_slots``: top-k, top-p, the counter hash of ``(seed,
    position)``), so a row's tokens depend on its seed and prompt only.
    After ``eos_id`` a row repeats it.  ``attention_impl`` defaults to
    the model config's.  Prompt and new tokens must fit a learned
    position table (JAX :253-260).

    Under longrope a decode that crosses the original context rebuilds
    the cache there (JAX :260-303, Phi-3's intended semantics): it
    decodes up to ``original + 1`` tokens, then runs the whole sequence
    so far again as a prompt, whose keys take the long factors, and
    continues from that cache; a row frozen at ``eos_id`` before the
    crossing stays frozen."""
    from torchacc_tpu_torch.models.transformer import (
        check_composition,
        head_logits,
    )
    cfg = model.cfg
    check_composition(cfg)
    dev = model.device
    ids = torch.as_tensor(prompt_ids, device=dev).long()
    if ids.ndim != 2 or ids.shape[1] < 1:
        raise ValueError(f"prompt_ids must be [b, p] with p >= 1, got "
                         f"{tuple(ids.shape)}")
    if max_new_tokens <= 0:
        return ids
    b, p = ids.shape
    total = p + max_new_tokens
    if cfg.pos_emb == "learned" and total > cfg.max_seq_len:
        raise ValueError(
            f"prompt + max_new_tokens = {total} exceeds the learned "
            f"position table max_seq_len {cfg.max_seq_len}")
    lr = cfg.rope_longrope
    if lr is not None and p <= int(lr[2]) < p + max_new_tokens - 1:
        n1 = int(lr[2]) + 1 - p
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  eos_id=eos_id, seed=seed, attention_impl=attention_impl)
        first = generate(model, ids, max_new_tokens=n1, **kw)
        out = generate(model, first, max_new_tokens=max_new_tokens - n1,
                       **kw)
        if eos_id is not None:
            # phase 2 has no done-state: rows frozen in phase 1 stay so
            done1 = first[:, -1] == eos_id
            out[:, p + n1:] = torch.where(done1[:, None], eos_id,
                                          out[:, p + n1:])
        return out
    impl = attention_impl or cfg.attention_impl
    shape = (cfg.num_layers, b, p + max_new_tokens, cfg.kv_heads,
             cfg.head_size)
    cache_k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    cache_v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    vec = lambda x, dt: torch.full((b,), x, dtype=dt, device=dev)
    knobs = (vec(temperature, torch.float32), vec(top_k, torch.int32),
             vec(top_p, torch.float32), vec(seed, torch.int64))

    def pick(x, pos):
        logits = head_logits(cfg, model, x[:, -1:])[:, 0]
        if temperature <= 0:
            return logits.argmax(dim=-1)
        return sample_slots(logits, *knobs, vec(pos, torch.int64)).long()

    tok = pick(_cached_forward(model, ids, 0, cache_k, cache_v, impl), p)
    done = (tok == eos_id) if eos_id is not None else None
    out = [tok]
    for pos in range(p, p + max_new_tokens - 1):
        x = _cached_forward(model, tok[:, None], pos, cache_k, cache_v, impl)
        nxt = pick(x, pos + 1)
        if done is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
