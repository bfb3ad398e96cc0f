"""Merge of two attention partials through their log-sum-exps (the port
of torchacc_tpu/ops/context_parallel/merge.py ``merge_attention``, :18).

Two partials over disjoint key sets combine exactly: with weights
``w = exp(lse - max)`` the merged output is the weighted mean of the
two and the merged lse is ``max + log(w_a + w_b)``.  Plain torch in
f32, as in the JAX package, where it is no Pallas kernel either.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchacc_tpu_torch.ops._common import NEG_INF


def merge_attention(out_a: torch.Tensor, lse_a: torch.Tensor,
                    out_b: torch.Tensor, lse_b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine partials (out ``[b, s, h, d]`` f32, lse ``[b, h, s]`` f32)
    into the merged ``(out, lse)``.  A row that saw no key carries
    ``lse == NEG_INF`` and contributes nothing; a row that saw none in
    either stays ``out = 0``, ``lse = NEG_INF``."""
    lse_max = torch.maximum(lse_a, lse_b)
    # both NEG_INF: the row attended to nothing anywhere
    lse_max_safe = torch.where(lse_max <= NEG_INF, 0.0, lse_max)
    wa = torch.where(lse_a <= NEG_INF, 0.0, torch.exp(lse_a - lse_max_safe))
    wb = torch.where(lse_b <= NEG_INF, 0.0, torch.exp(lse_b - lse_max_safe))
    denom = wa + wb
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    # [b, h, s] weights broadcast over [b, s, h, d]
    wa_ = (wa / denom_safe).transpose(1, 2)[..., None]
    wb_ = (wb / denom_safe).transpose(1, 2)[..., None]
    out = out_a * wa_ + out_b * wb_
    lse = torch.where(denom == 0.0, NEG_INF,
                      lse_max_safe + torch.log(denom_safe))
    return out, lse
