"""Rematerialisation (gradient checkpointing) policies: the port of
torchacc_tpu/utils/remat.py ``remat_policy`` (:45) on
``torch.utils.checkpoint``.

JAX names values inside a block (``checkpoint_name``) and its policies
save the named ones; everything else is recomputed from them in the
backward, by data flow.  Torch's selective checkpointing works per op
instead: the backward re-runs the block's forward, and an op whose
outputs the policy saved returns them from the cache instead of
computing again.  So the port names *sites*: the model wraps its
projections in :func:`checkpoint_name`, and a policy saves the matmul
outputs made inside the named sites (a quantized site's matmul is the
quantized-matmul forward op, so its kernel does not re-run), plus the
flash-attention forward op whole (``o`` and ``lse``, JAX's ``attn_ctx``/``attn_lse``):

=================  ==========================================================
'nothing'          save nothing: the block's whole forward re-runs,
                   the flash-attention forward kernel included
'save_attn'        q/k/v projections, o and lse of the attention,
                   the o projection (``attn_out``), the mlp output
                   (``mlp_out``); the ffn-width gate/up projections and
                   every norm and elementwise op are recomputed
'save_attn_mlp'    'save_attn' + the gate/up projections: the recompute
                   is elementwise only
=================  ==========================================================

Where JAX saves the q/k after RoPE, the port saves the projections and
recomputes RoPE (elementwise).  The JAX policies 'dots',
'dots_with_no_batch_dims' and 'offload_dots' are not ported.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

import torchacc_tpu_torch.ops.flash_attention  # noqa: F401  (the op below)
import torchacc_tpu_torch.ops.quantized_matmul  # noqa: F401  (the op below)

_POLICY_NAMES = {
    "save_attn": ("qkv_proj", "attn_out", "mlp_out"),
    "save_attn_mlp": ("qkv_proj", "attn_out", "mlp_out", "mlp_gate_up"),
}
_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default}
_FLASH_FWD = torch.ops.torchacc_tpu_torch.flash_fwd.default
# the quantized forward product of a site counts as its matmul
_MATMULS.add(torch.ops.torchacc_tpu_torch.qmm_fwd.default)

# the innermost site of each thread (the recompute of a checkpoint
# region runs in autograd's thread)
_local = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Mark the ops made inside as the site ``name`` (the JAX
    ``checkpoint_name`` of the same value)."""
    outer = getattr(_local, "site", None)
    _local.site = name
    try:
        yield
    finally:
        _local.site = outer


def remat_policy(name: str = "nothing") -> Optional[Callable]:
    """The selective-checkpoint policy function of ``name`` (None for
    'nothing': plain checkpointing, which recomputes every op)."""
    if name == "nothing":
        return None
    if name not in _POLICY_NAMES:
        if name in ("dots", "dots_with_no_batch_dims", "offload_dots"):
            raise NotImplementedError(
                f"remat policy {name!r} is not ported to torchacc_tpu_torch "
                "yet (ROADMAP.md)")
        raise ValueError(f"unknown remat policy {name!r}")
    saved = frozenset(_POLICY_NAMES[name])

    def policy(ctx, op, *args, **kwargs):
        if op is _FLASH_FWD or (op in _MATMULS and getattr(
                _local, "site", None) in saved):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def checkpoint_block(fn: Callable, policy_name: str, *args):
    """``fn(*args)`` as a checkpoint region under ``policy_name``."""
    policy = remat_policy(policy_name)
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
