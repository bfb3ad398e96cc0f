"""The device mesh of the parallel composition (the port of
torchacc_tpu/parallel/mesh.py: ``build_mesh`` :30, ``mesh_axis_size``
:96, ``describe_mesh`` :100).

A ``torch.distributed.device_mesh.DeviceMesh`` over the default process
group takes the place of the ``jax.sharding.Mesh``: one named dim per
axis of ``dist.topology``, every axis kept even at size 1 (as JAX keeps
them), so the sharding plan can name any axis.  ``init_device_mesh``
lays the ranks out row-major, so the topology's last axes (the fastest
network) join consecutive ranks, which torchrun puts on one node.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from torchacc_tpu_torch.config import DATA_AXES, DistConfig


def build_mesh(dist_cfg: DistConfig, device_type: str = "cuda") -> DeviceMesh:
    """The mesh of ``dist_cfg`` over every rank of the process group
    (:func:`mesh_shape` of its world size)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs a process group: call "
            "parallel.initialize_distributed() first")
    names, shape = mesh_shape(dist_cfg, dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_shape(dist_cfg: DistConfig, world: int
               ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The axis names (``dist_cfg.topology``) and sizes of the mesh of
    ``world`` ranks.  Raises where the port does not lay the composition
    out: ``num_slices`` above 1 (after the JAX package's axis-order
    check), and 'fsdp' before 'dp' in the topology (FSDP2 replicates
    over the first dim of its data mesh and shards over the second)."""
    dist_cfg.validate()
    sizes = dist_cfg.axis_sizes(world)
    names = tuple(dist_cfg.topology)
    shape = tuple(sizes[a] for a in names)
    if dist_cfg.num_slices > 1:
        _split_shape_for_dcn(shape, dist_cfg.num_slices,
                             world // dist_cfg.num_slices)
        raise NotImplementedError(
            "dist.num_slices > 1 (a hybrid mesh across slices) is not "
            "ported to torchacc_tpu_torch yet (ROADMAP.md A8b)")
    if names.index("fsdp") < names.index("dp"):
        raise NotImplementedError(
            "a dist.topology with 'fsdp' before 'dp' is not ported to "
            "torchacc_tpu_torch yet (ROADMAP.md A8b)")
    return names, shape


def _split_shape_for_dcn(shape: Tuple[int, ...], num_slices: int,
                         per_slice: int
                         ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Factor the mesh shape into a DCN part (leading axes, product ==
    num_slices) and an ICI part (product == per_slice)."""
    dcn = []
    remaining = num_slices
    for s in shape:
        if remaining > 1:
            if remaining % s == 0:
                dcn.append(s)
                remaining //= s
            elif s % remaining == 0:
                raise ValueError(
                    f"axis of size {s} straddles the slice boundary "
                    f"(num_slices={num_slices}); reorder dist.topology so "
                    "DCN-spanning axes come first and divide num_slices")
            else:
                dcn.append(1)
        else:
            dcn.append(1)
    if remaining != 1:
        raise ValueError(f"cannot place num_slices={num_slices} on leading "
                         f"mesh axes {shape}")
    ici = tuple(s // d for s, d in zip(shape, dcn))
    return tuple(dcn), ici


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    return describe_mesh(mesh).get(axis, 1)


def describe_mesh(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """FSDP2's mesh: ('dp', 'fsdp'), over which it replicates on 'dp'
    and shards on 'fsdp' (HSDP), or 'fsdp' alone where 'dp' is 1, so that
    no unit all-reduces over a replicate group of one rank.  'pp' between
    them in ``MESH_AXES`` is left out: the two dims of the sub-mesh are
    this rank's stage's data ranks."""
    return mesh["fsdp"] if describe_mesh(mesh)["dp"] == 1 else \
        mesh[DATA_AXES]


def data_shard(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(num_shards, shard_index)`` of this rank's rows of each global
    batch: the batch splits over 'dp' (major) and 'fsdp' (minor), as the
    JAX package's ``batch_spec`` splits it; the 'tp' ranks of one data
    group read the same rows.  Give them to ``PackedDataset``."""
    sizes = describe_mesh(mesh)
    return (sizes["dp"] * sizes["fsdp"],
            mesh.get_local_rank("dp") * sizes["fsdp"]
            + mesh.get_local_rank("fsdp"))


def pp_stage(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(num_stages, stage_index)`` of this rank over 'pp'
    (``parallel/pp.py``): the ranks of one data shard and sequence chunk
    at every stage take the same rows (:func:`data_shard` leaves 'pp'
    out), and each holds its stage's blocks."""
    sizes = describe_mesh(mesh)
    n = sizes.get("pp", 1)
    return n, (mesh.get_local_rank("pp") if n > 1 else 0)


def pp_ranks(mesh: DeviceMesh) -> List[int]:
    """The global rank of each stage of this rank's pipeline, the other
    coordinates this rank's: stage d's previous stage is ``(d - 1) % P``
    and its next ``(d + 1) % P`` (a ring: the interleaved schedule laps
    from the last stage to the first)."""
    return mesh["pp"].mesh.tolist()


def seq_shard(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(num_chunks, chunk_index)`` of this rank's part of each row's
    sequence under context parallelism: the sequence splits in
    contiguous chunks over 'sp' (major) and 'spu' (minor), as the JAX
    package's ``seq`` spec ``("sp", "spu")`` splits it, so that the
    ring's chunk ``sp_idx`` covers the 'spu' ranks' chunks after the
    all-to-all.  The sequence ranks of one data shard read the same
    rows (:func:`data_shard`) and each keeps its chunk."""
    sizes = describe_mesh(mesh)
    return (sizes["sp"] * sizes["spu"],
            mesh.get_local_rank("sp") * sizes["spu"]
            + mesh.get_local_rank("spu"))
