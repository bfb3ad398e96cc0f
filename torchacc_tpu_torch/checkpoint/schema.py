"""Checkpoint schema manifests and topology-compatibility checks (the
port of torchacc_tpu/checkpoint/schema.py).

At save time a checkpoint records what a restore needs to judge
compatibility before it reads any tensor:

- the device mesh (axis names and sizes) the state was sharded over: the
  axes of the state's DTensors' device meshes, or None without one;
- the process count (the process group's world size, or 1);
- the state's structure digest (leaf count and sha256 over the sorted
  ``path:shape:dtype`` lines: the flat leaf names of
  ``train.state.flat_state``, *global* shapes);
- each leaf's shape and dtype.

:func:`check_compatibility` classifies a change with the JAX package's
table:

==========================  ===============================================
change                      verdict
==========================  ===============================================
nothing                     ok
dp / fsdp / process count   ok iff ``resilience.elastic_resume``: the data
                            layout changes, the computation does not
tp / pp / sp / spu / ep     :class:`TopologyMismatchError`, always
leaf shapes/dtypes/paths    :class:`StateSchemaError` with a per-leaf diff
==========================  ===============================================
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from torchacc_tpu_torch.errors import StateSchemaError, TopologyMismatchError

SCHEMA_FORMAT = 1

#: Axes whose extent may change between save and elastic restore.
ELASTIC_AXES: Tuple[str, ...] = ("dp", "fsdp")

#: Axes that alter the program: never elastically resumable.
SENSITIVE_AXES: Tuple[str, ...] = ("tp", "pp", "sp", "spu", "ep")


def _dtype_name(t: Any) -> str:
    return str(getattr(t, "dtype", "?")).replace("torch.", "")


def _leaf_specs(flat: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``{path: {"shape": [...], "dtype": str}}`` for every leaf (global
    shapes), the other pipeline stages' too (``FlatState.other_leaves``):
    the whole model's on every rank."""
    out = {p: {"shape": [int(s) for s in getattr(x, "shape", ())],
               "dtype": _dtype_name(x)} for p, x in flat.items()}
    for p, (shape, dtype) in getattr(flat, "other_leaves", {}).items():
        out[p] = {"shape": [int(s) for s in shape],
                  "dtype": str(dtype).replace("torch.", "")}
    return out


def tree_digest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Structure summary of a flat state: leaf count and sha256 over the
    sorted ``path:shape:dtype`` lines."""
    lines = sorted(f"{p}:{tuple(s['shape'])}:{s['dtype']}"
                   for p, s in _leaf_specs(flat).items())
    h = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    return {"leaves": len(lines), "digest": h}


def mesh_axes(flat: Mapping[str, Any]) -> Optional[Dict[str, int]]:
    """Axis name -> size over the device meshes of the state's DTensors
    (an SPMD state shares one mesh; FSDP2 and tensor parallelism place
    parameters on sub-meshes of it), or None when no leaf is a DTensor:
    the topology check is then skipped."""
    axes: Dict[str, int] = {}
    for x in flat.values():
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            axes.update(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if axes and getattr(flat, "pp_size", 1) > 1:
        # the stages over 'pp' (no DTensor spans them)
        axes["pp"] = flat.pp_size
    return {str(k): int(v) for k, v in axes.items()} or None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def state_schema(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The schema manifest recorded with every checkpoint."""
    return {
        "format": SCHEMA_FORMAT,
        "mesh": mesh_axes(flat),
        "process_count": process_count(),
        "tree": tree_digest(flat),
        "leaf_specs": _leaf_specs(flat),
    }


def schema_diff(saved: Dict[str, Any],
                current: Dict[str, Any]) -> List[str]:
    """Human-readable per-line diff between two schema manifests (mesh
    axes, process count, then per-leaf shape/dtype drift)."""
    out: List[str] = []
    sm = saved.get("mesh") or {}
    cm = current.get("mesh") or {}
    for ax in sorted(set(sm) | set(cm)):
        a, b = sm.get(ax, 1), cm.get(ax, 1)
        if a != b:
            out.append(f"mesh axis '{ax}': saved {a} -> current {b}")
    sp = saved.get("process_count")
    cp = current.get("process_count")
    if sp is not None and cp is not None and sp != cp:
        out.append(f"process count: saved {sp} -> current {cp}")
    sl = saved.get("leaf_specs") or {}
    cl = current.get("leaf_specs") or {}
    for path in sorted(set(sl) - set(cl)):
        out.append(f"leaf only in checkpoint: {path} "
                   f"{tuple(sl[path]['shape'])}:{sl[path]['dtype']}")
    for path in sorted(set(cl) - set(sl)):
        out.append(f"leaf only in target: {path} "
                   f"{tuple(cl[path]['shape'])}:{cl[path]['dtype']}")
    for path in sorted(set(sl) & set(cl)):
        a, b = sl[path], cl[path]
        if a["shape"] != b["shape"] or a["dtype"] != b["dtype"]:
            out.append(
                f"leaf {path}: saved {tuple(a['shape'])}:{a['dtype']} -> "
                f"target {tuple(b['shape'])}:{b['dtype']}")
    return out


def changed_axes(saved: Dict[str, Any],
                 current: Dict[str, Any]) -> List[str]:
    """Mesh axes whose extent differs (missing axes count as size 1); a
    process-count change is reported as the pseudo-axis 'hosts'."""
    sm = saved.get("mesh") or {}
    cm = current.get("mesh") or {}
    axes = [ax for ax in sorted(set(sm) | set(cm))
            if sm.get(ax, 1) != cm.get(ax, 1)]
    sp, cp = saved.get("process_count"), current.get("process_count")
    if sp is not None and cp is not None and sp != cp:
        axes.append("hosts")
    return axes


def tree_drift(saved: Dict[str, Any],
               current: Dict[str, Any]) -> Optional[List[str]]:
    """Per-leaf diff lines when the two schemas' trees drifted (digest or
    leaf count), else None."""
    st, ct = saved.get("tree") or {}, current.get("tree") or {}
    if not st.get("digest") or not ct.get("digest"):
        return None
    if st["digest"] == ct["digest"] and st.get("leaves") == ct.get("leaves"):
        return None
    diff = schema_diff(saved, current)
    leaf_diff = [d for d in diff if d.startswith("leaf")]
    return leaf_diff or diff


def drift_error(saved: Dict[str, Any], current: Dict[str, Any],
                *, where: str,
                hint: str = "") -> Optional[StateSchemaError]:
    """The one constructor of state-drift errors: a
    :class:`StateSchemaError` carrying the per-leaf diff when the trees
    drifted, else None."""
    drift = tree_drift(saved, current)
    if drift is None:
        return None
    st, ct = saved.get("tree") or {}, current.get("tree") or {}
    return StateSchemaError(
        f"{where}: state-tree schema mismatch ({st.get('leaves')} saved "
        f"leaves vs {ct.get('leaves')} target):\n  " + "\n  ".join(drift)
        + (f"\n  {hint}" if hint else ""),
        diff=drift)


def check_compatibility(saved: Dict[str, Any], current: Dict[str, Any],
                        *, elastic: bool = False,
                        where: str = "checkpoint") -> str:
    """Judge a restore before any tensor is read.  Returns ``"ok"``
    (identical layout) or ``"elastic"`` (a data-axis or process-count
    change that the load reshards); raises :class:`StateSchemaError` on
    state drift and :class:`TopologyMismatchError` on a topology change
    that is not (or may not be) resumed elastically."""
    err = drift_error(saved, current, where=where)
    if err is not None:
        raise err
    diff = schema_diff(saved, current)
    if saved.get("mesh") is None or current.get("mesh") is None:
        return "ok"  # no topology recorded on one side: nothing to judge
    axes = changed_axes(saved, current)
    if not axes:
        return "ok"
    bad = [ax for ax in axes if ax in SENSITIVE_AXES]
    if bad:
        raise TopologyMismatchError(
            f"{where}: topology change on non-elastic axis(es) "
            f"{bad} — tp/pp/sp/spu/ep reshapes change the program and "
            f"cannot be resumed elastically (use the offline reshard "
            f"CLI deliberately):\n  " + "\n  ".join(diff),
            axes=bad, diff=diff)
    if not elastic:
        raise TopologyMismatchError(
            f"{where}: topology changed on axis(es) {axes} and "
            f"resilience.elastic_resume is off — set it to resume a "
            f"run saved on a different data-parallel layout/host "
            f"count:\n  " + "\n  ".join(diff),
            axes=axes, diff=diff)
    return "elastic"


def as_flat(state: Any) -> Dict[str, torch.Tensor]:
    """A state as the flat mapping a checkpoint holds: a
    ``train.state.TrainState`` through ``flat_state``, a mapping of
    tensors as it is."""
    from torchacc_tpu_torch.train.state import (
        FlatState,
        TrainState,
        flat_state,
    )
    if isinstance(state, FlatState):
        return state
    if isinstance(state, Mapping):
        return dict(state)
    if isinstance(state, TrainState):
        return flat_state(state)
    raise TypeError(f"a checkpoint holds a TrainState or a mapping of "
                    f"tensors, not {type(state).__name__}")
