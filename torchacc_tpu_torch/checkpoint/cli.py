"""The checkpoint console tool (the port of the checkpoint part of
torchacc_tpu/checkpoint/cli.py)::

    python -m torchacc_tpu_torch.checkpoint.cli inspect <dir> [--leaves]
    python -m torchacc_tpu_torch.checkpoint.cli --ckpt_dir SRC --save_dir DST
        [--reshard_num N] [--mesh_axis fsdp] [--dry-run]

- ``inspect``: the schema manifest (mesh axes and sizes, process count,
  digest, with ``--leaves`` every leaf's shape and dtype) of a checkpoint,
  or of every marked step of a ``CheckpointManager`` directory.
- ``--reshard_num 1`` (the default) consolidates ``SRC`` into ``DST``;
  ``--reshard_num N`` re-saves it laid out over N ranks along
  ``--mesh_axis`` (each leaf whose first dim N divides is sharded on it,
  the rest replicated), by N local gloo processes on the CPU.
- ``--dry-run`` prints the plan (and, for a reshard, the schema diff
  against the source) without reading tensors or writing.

``replay``, ``supervise``, ``fleet-history`` and ``inspect --mirror``
belong to the operations plane (ROADMAP A13) and exit with code 2.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys

_A13 = ("is not ported to torchacc_tpu_torch yet (ROADMAP.md A13: the "
        "resilience and operations plane)")


def _load_schema(ckpt_dir: str):
    """Schema manifest of ``ckpt_dir``: the ``_MANIFEST`` of a manager
    step directory, the ``<dir>.schema.json`` sidecar of a standalone
    save, or None."""
    from torchacc_tpu_torch.checkpoint.io import MANIFEST, _schema_sidecar
    manifest = os.path.join(ckpt_dir, MANIFEST)
    if os.path.exists(manifest):
        try:
            with open(manifest) as f:
                m = json.load(f)
            return m.get("schema") or {"tree": m.get("tree")}
        except (OSError, ValueError):
            return None
    sidecar = _schema_sidecar(os.path.abspath(ckpt_dir))
    if os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None
    return None


def _payload(ckpt_dir: str) -> str:
    """The DCP payload of a checkpoint or of a manager step directory."""
    from torchacc_tpu_torch.checkpoint.io import PAYLOAD
    item = os.path.join(ckpt_dir, PAYLOAD)
    return item if os.path.isdir(item) else ckpt_dir


def _metadata_leaves(ckpt_dir: str):
    """``{leaf: (shape, dtype)}`` from DCP's metadata, no tensor read."""
    from torch.distributed.checkpoint import FileSystemReader
    md = FileSystemReader(_payload(ckpt_dir)).read_metadata()
    return {k: (tuple(m.size), m.properties.dtype)
            for k, m in md.state_dict_metadata.items()}


def _schema_from_metadata(ckpt_dir: str):
    """For a checkpoint without a schema manifest: leaf shapes and dtypes
    from DCP's metadata (no mesh or process count: never recorded)."""
    import torch
    from torchacc_tpu_torch.checkpoint.schema import state_schema
    leaves = {k: torch.empty(shape, dtype=dtype, device="meta")
              for k, (shape, dtype) in _metadata_leaves(ckpt_dir).items()}
    schema = state_schema(leaves)
    schema["mesh"] = None
    schema["process_count"] = None
    return schema


def _print_schema(label: str, schema, *, leaves: bool, out=None):
    out = out if out is not None else sys.stdout
    mesh = schema.get("mesh")
    tree = schema.get("tree") or {}
    print(f"{label}:", file=out)
    print("  mesh: "
          + (" ".join(f"{k}={v}" for k, v in mesh.items()) if mesh
             else "<not recorded>"), file=out)
    if schema.get("process_count") is not None:
        print(f"  processes: {schema['process_count']}", file=out)
    print(f"  leaves: {tree.get('leaves', '?')}  "
          f"digest: {str(tree.get('digest', '?'))[:16]}", file=out)
    specs = schema.get("leaf_specs") or {}
    if leaves and specs:
        for path in sorted(specs):
            s = specs[path]
            print(f"    {path}: {tuple(s['shape'])} {s['dtype']}", file=out)


def _cmd_inspect(args) -> int:
    from torchacc_tpu_torch.checkpoint.io import MANIFEST
    if args.mirror is not None:
        print(f"error: inspect --mirror (tier-2 mirrors) {_A13}",
              file=sys.stderr)
        return 2
    d = args.ckpt_dir
    if not os.path.isdir(d):
        print(f"error: {d} is not a directory", file=sys.stderr)
        return 2
    steps = sorted(
        int(n) for n in os.listdir(d)
        if n.isdigit() and os.path.exists(os.path.join(d, n, MANIFEST)))
    if steps:
        for step in steps:
            try:
                with open(os.path.join(d, str(step), MANIFEST)) as f:
                    manifest = json.load(f)
            except (OSError, ValueError) as e:
                print(f"step {step}: unreadable {MANIFEST} ({e})",
                      file=sys.stderr)
                continue
            schema = manifest.get("schema") or {"tree": manifest.get("tree")}
            _print_schema(f"step {step}", schema, leaves=args.leaves)
        return 0
    schema = _load_schema(d)
    if schema is None:
        try:
            schema = _schema_from_metadata(d)
        except Exception as e:  # noqa: BLE001 - operator-facing tool
            print(f"error: no schema manifest and DCP metadata unreadable "
                  f"for {d}: {e!r}", file=sys.stderr)
            return 2
    _print_schema(d, schema, leaves=args.leaves)
    return 0


def _reshard_target(leaves, mesh, axis: str, n: int):
    """Empty DTensors of every leaf over ``mesh``: sharded on dim 0 where
    ``n`` divides it, replicated otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import empty as dt_empty
    out = {}
    for k, (shape, dtype) in leaves.items():
        shard = len(shape) >= 1 and shape[0] and shape[0] % n == 0
        out[k] = dt_empty(shape, dtype=dtype, device_mesh=mesh,
                          placements=[Shard(0) if shard else Replicate()])
    return out


def _reshard_rank(rank: int, n: int, url: str, src: str, dst: str,
                  axis: str) -> None:
    """One of the ``n`` gloo processes of an offline reshard."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torchacc_tpu_torch.checkpoint.reshard import reshard_checkpoint
    dist.init_process_group("gloo", init_method=url, world_size=n, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (n,), mesh_dim_names=(axis,))
        target = _reshard_target(_metadata_leaves(src), mesh, axis, n)
        reshard_checkpoint(_payload(src), dst, target)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _reshard(src: str, dst: str, n: int, axis: str) -> None:
    """Re-save ``src`` over ``n`` local gloo ranks along ``axis``."""
    import torch.multiprocessing as mp
    # by the module's import name, which the spawned processes import
    # (not __main__'s under python -m)
    from torchacc_tpu_torch.checkpoint import cli
    url = f"tcp://127.0.0.1:{_free_port()}"
    mp.start_processes(cli._reshard_rank, args=(n, url, src, dst, axis),
                       nprocs=n, join=True, start_method="spawn")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("replay", "supervise", "fleet-history"):
        print(f"error: '{argv[0]}' {_A13}", file=sys.stderr)
        return 2
    if argv and argv[0] == "inspect":
        p = argparse.ArgumentParser(
            prog="torchacc_tpu_torch.checkpoint.cli inspect",
            description="Print a checkpoint's schema manifest (mesh, "
                        "step, leaf shapes/dtypes).")
        p.add_argument("ckpt_dir", help="checkpoint (or manager) directory")
        p.add_argument("--leaves", action="store_true",
                       help="also list per-leaf shapes/dtypes")
        p.add_argument("--mirror", default=None,
                       help="tier-2 mirror directory (ROADMAP A13)")
        return _cmd_inspect(p.parse_args(argv[1:]))

    p = argparse.ArgumentParser(
        prog="torchacc_tpu_torch.checkpoint.cli",
        description="Consolidate or reshard torchacc_tpu_torch checkpoints "
                    "('inspect <dir>' prints the schema manifest).")
    p.add_argument("--ckpt_dir", required=True, help="source checkpoint")
    p.add_argument("--save_dir", required=True, help="destination")
    p.add_argument("--reshard_num", type=int, default=1,
                   help="target shard count (1 = consolidate only)")
    p.add_argument("--mesh_axis", default="fsdp",
                   help="mesh axis to reshard over (default fsdp)")
    p.add_argument("--dry-run", action="store_true", dest="dry_run",
                   help="print the plan (and the schema diff for "
                        "reshard) without reading tensors or writing")
    args = p.parse_args(argv)
    src = os.path.abspath(args.ckpt_dir)
    if args.reshard_num <= 1:
        if args.dry_run:
            schema = _load_schema(src)
            if schema is None:
                try:
                    schema = _schema_from_metadata(src)
                except Exception as e:  # noqa: BLE001
                    print(f"error: cannot read {args.ckpt_dir}: {e!r}",
                          file=sys.stderr)
                    return 2
            _print_schema(f"would consolidate {args.ckpt_dir} -> "
                          f"{args.save_dir}", schema, leaves=False)
            return 0
        from torchacc_tpu_torch.checkpoint.reshard import (
            consolidate_checkpoint,
        )
        consolidate_checkpoint(_payload(src), args.save_dir)
        return 0
    try:
        leaves = _metadata_leaves(src)
    except Exception as e:  # noqa: BLE001 - operator-facing tool
        print(f"error: cannot read {args.ckpt_dir}: {e!r}", file=sys.stderr)
        return 2
    if args.dry_run:
        from torchacc_tpu_torch.checkpoint.schema import schema_diff
        n = args.reshard_num
        specs = {k: {"shape": list(shape),
                     "dtype": str(dtype).replace("torch.", "")}
                 for k, (shape, dtype) in leaves.items()}
        _print_schema(f"would reshard {args.ckpt_dir} -> {args.save_dir}",
                      {"mesh": {args.mesh_axis: n}, "process_count": n,
                       "leaf_specs": specs}, leaves=False)
        saved = _load_schema(src)
        if saved is not None:
            diff = schema_diff(saved, {"mesh": {args.mesh_axis: n},
                                       "process_count": n,
                                       "leaf_specs": specs})
            print("  changes vs source:"
                  + ("".join(f"\n    {d}" for d in diff) if diff
                     else " none"))
        for k, (shape, _) in sorted(leaves.items()):
            split = len(shape) >= 1 and shape[0] and shape[0] % n == 0
            print(f"    {k}: {shape} -> "
                  + (f"Shard(0) over {args.mesh_axis}={n}" if split
                     else "replicated"))
        return 0
    _reshard(src, os.path.abspath(args.save_dir), args.reshard_num,
             args.mesh_axis)
    return 0


if __name__ == "__main__":
    sys.exit(main())
