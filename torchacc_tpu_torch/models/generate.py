"""Token embedding and the sampling rules of the serving path (the port
of torchacc_tpu/models/generate.py ``_zoo_embed`` and ``_sample``, in
the per-slot form of ``serve/scheduler.py::_sample_slots``).

Greedy decoding (temperature <= 0) is ``argmax`` — the first maximum,
as in JAX — and token-identical to the JAX package given the same
logits.  Sampling cannot reproduce JAX's PRNG keys, so it draws its own
noise: a counter-based hash of ``(request seed, token position, vocab
index)`` feeds Gumbel-max, on the device.  A sampled token is therefore
a function of the request's seed, its prompt and the weights only —
never of its batch-mates or of the slot it landed in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def embed(cfg, model, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding in the compute dtype (``_zoo_embed``; the Gemma
    scale and learned positions are outside the serving surface).  int32
    ids (the packed batches' dtype) are read as they are."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.long()
    return F.embedding(ids, model.embed_tokens.weight).to(cfg.dtype)


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
