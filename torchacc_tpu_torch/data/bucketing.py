"""Sequence-length bucketing (the port of torchacc_tpu/data/bucketing.py):
every batch's trailing dimension is padded up to the nearest bucket
length, so a step sees only a few distinct shapes."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from torchacc_tpu_torch.utils.logger import logger


def closest_bucket(buckets: Sequence[int], length: int) -> int:
    """Smallest bucket >= length; the largest bucket if none fits."""
    for b in buckets:
        if b >= length:
            return b
    logger.debug(f"sequence length {length} exceeds largest bucket "
                 f"{buckets[-1]}; truncating")
    return buckets[-1]


def _to_numpy(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def pad_batch(
    batch: Dict[str, Any],
    buckets: Optional[Sequence[int]],
    pad_value_dict: Optional[Dict[str, Any]] = None,
    seq_axis: int = -1,
) -> Dict[str, np.ndarray]:
    """Pad (or truncate) every array's sequence axis to the common bucket,
    chosen from the longest feature so all features stay aligned.  Pad
    values default to 0, except ``labels`` (-100, ignored by the loss)
    and ``segment_ids`` (-1, matches nothing in the attention mask).
    0-D and 1-D features are per-example values and pass as they are."""
    arrs = {k: _to_numpy(v) for k, v in batch.items()}
    if not buckets:
        return arrs
    pad_values = {"labels": -100, "segment_ids": -1}
    if pad_value_dict:
        pad_values.update(pad_value_dict)
    seq_lens = [a.shape[seq_axis] for a in arrs.values() if a.ndim >= 2]
    if not seq_lens:
        return arrs
    bucket = closest_bucket(buckets, max(seq_lens))
    out = {}
    for k, a in arrs.items():
        if a.ndim < 2:
            out[k] = a
            continue
        axis = seq_axis % a.ndim
        cur = a.shape[axis]
        if cur == bucket:
            out[k] = a
        elif cur > bucket:
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(0, bucket)
            out[k] = a[tuple(sl)]
        else:
            width = [(0, 0)] * a.ndim
            width[axis] = (0, bucket - cur)
            out[k] = np.pad(a, width, constant_values=pad_values.get(k, 0))
    return out
