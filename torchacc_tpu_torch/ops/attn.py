"""Attention front door (the port of torchacc_tpu/ops/attn.py:23).

``impl``:
  - 'auto'  : the flash-attention kernels for CUDA tensors, the plain
              attention for CPU tensors
  - 'cuda'  : force the kernels (raises on CPU tensors)
  - 'torch' : force the plain attention

Every path goes through ``ops.flash_attention``, whose gradient is the
backward kernels' (or the plain backward formula's for 'torch').  There
is no fallback: where the JAX dispatcher warns and falls back to plain
attention when the Pallas kernel cannot be imported (:64-69), a kernel
that cannot be built or launched raises here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchacc_tpu_torch.ops.flash_attention import flash_attention


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Tuple[int, int] = (-1, -1),
    scale: Optional[float] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed=None,
    impl: str = "auto",
    return_lse: bool = False,
    logit_softcap: float = 0.0,
    q_offset: int = 0,
    k_offset: int = 0,
    h_offset: int = 0,
    b_offset: int = 0,
):
    """``[b, s, h, d]`` attention with optional LSE output; the offsets
    are the global position of the local rows, heads and batch rows
    (``ops.flash_attention``)."""
    return flash_attention(
        q, k, v, causal=causal, window=window, scale=scale,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        alibi_slopes=alibi_slopes, dropout_p=dropout_p,
        dropout_seed=dropout_seed, q_offset=q_offset, k_offset=k_offset,
        h_offset=h_offset, b_offset=b_offset, return_lse=return_lse,
        logit_softcap=logit_softcap, impl=impl)
