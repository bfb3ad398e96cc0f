"""Parameter name -> logical axes (the port of torchacc_tpu/models/
axes.py, ``TRANSFORMER_AXES`` :22 and ``param_axes`` :42).

The same regex table over the port's parameter names
(``layers.<i>.attn.q_proj.weight``, ``embed_tokens.weight``, ...).  An
``nn.Linear`` weight is ``[out, in]``, so its axes are the flax
kernel's reversed, and the flax kernel's ``[heads, kv]`` dims, which
the port holds flattened into one dim, name that dim with the tuple
``("heads", "kv")`` (major first).  The port's layers are not stacked,
so no leading 'layers' axis is added.  The mixture of experts' router
``[e, h]`` and experts (``gate``/``up`` ``[e, f, h]``, ``down`` ``[e,
h, f]``: each expert ``[out, in]``, models/moe.py) take JAX's logical
axes, 'expert' and 'expert_mlp', in that order.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple, Union

import torch

# one logical name per dim, or a tuple of names for a dim that holds
# several flax dims flattened (major first)
Axis = Union[None, str, Tuple[str, ...]]
AxesRule = Tuple[str, Tuple[Axis, ...]]

_HEADS = ("heads", "kv")

# first match wins
TRANSFORMER_AXES: Tuple[AxesRule, ...] = (
    (r"embed_tokens\.weight$", ("vocab", "embed")),
    (r"pos_embed\.weight$", (None, "embed")),
    (r"(q_proj|k_proj|v_proj)\.weight$", (_HEADS, "embed")),
    (r"(q_proj|k_proj|v_proj)\.bias$", (_HEADS,)),
    (r"o_proj\.weight$", ("embed", _HEADS)),
    (r"o_proj\.bias$", ("embed",)),
    (r"(gate_proj|up_proj)\.weight$", ("mlp", "embed")),
    (r"(gate_proj|up_proj)\.bias$", ("mlp",)),
    (r"down_proj\.weight$", ("embed", "mlp")),
    (r"down_proj\.bias$", ("embed",)),
    (r"moe\.router\.weight$", ("expert", "embed")),
    (r"experts\.(gate|up)$", ("expert", "expert_mlp", "embed")),
    (r"experts\.down$", ("expert", "embed", "expert_mlp")),
    (r"(ln1|ln2|ln1_post|ln2_post|final_norm|q_norm|k_norm)\.(weight|bias)$",
     ("norm",)),
    (r"lm_head\.weight$", ("vocab", "embed")),
    (r"lm_head\.bias$", ("vocab",)),
)


def param_axes(named: Iterable[Tuple[str, torch.Tensor]],
               rules: Tuple[AxesRule, ...] = TRANSFORMER_AXES
               ) -> Dict[str, Tuple[Axis, ...]]:
    """The logical axes of every ``(name, tensor)`` (e.g.
    ``model.named_parameters()``).  An unmatched name, or a rule whose
    length is not the tensor's rank, raises: silent replication of a
    large tensor is a memory bug, not a default."""
    compiled = [(re.compile(pat), axes) for pat, axes in rules]
    out: Dict[str, Tuple[Axis, ...]] = {}
    for name, t in named:
        axes: Optional[Tuple[Axis, ...]] = next(
            (a for pat, a in compiled if pat.search(name)), None)
        if axes is None:
            raise ValueError(
                f"no logical-axes rule matches param {name!r} (shape "
                f"{tuple(t.shape)}); extend the rules table")
        if len(axes) != t.ndim:
            raise ValueError(f"axes rule {axes} does not fit param {name} "
                             f"with shape {tuple(t.shape)}")
        out[name] = axes
    return out
