"""What the multi-device steps (``mining.distributed``,
``serving.sharded``) share about a ``DeviceMesh`` built by
``launch.mesh``: a rank's device and place in the mesh, the groups of
the ranks that share a set of axes, a rank's block of a global axis,
and the all_gather they exchange tables and blocks with.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# (id of a mesh, axes) -> this rank's group over those axes; an entry
# goes with its mesh
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], object] = {}


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_coords(mesh: DeviceMesh) -> Dict[int, Tuple[int, ...]]:
    """Global rank -> its coordinate in ``mesh``."""
    shape = tuple(mesh.mesh.shape)
    return {rank: tuple(int(i) for i in np.unravel_index(pos, shape))
            for pos, rank in enumerate(mesh.mesh.flatten().tolist())}


def axes_index(mesh: DeviceMesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's row-major index over ``axes``, the number of such
    indices): the shard a block belongs to when ``axes`` split it."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    index, size = 0, 1
    for a in axes:
        d = names.index(a)
        index = index * mesh.size(d) + coord[d]
        size *= mesh.size(d)
    return index, size


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinate
    on every axis but ``axes``.  One axis is the mesh's own group.  For
    several, the first call for a mesh and ``axes`` creates every such
    group, in the same order on every rank, and keeps this rank's for
    the mesh's lifetime - so every rank must make its first call with
    the same arguments at the same point."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = mesh.mesh_dim_names
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        ids = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.size(d) for d in dims))
        for ranks in ids.tolist():
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                _GROUPS[key] = group
        weakref.finalize(mesh, _GROUPS.pop, key, None)
    return _GROUPS[key]


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on all ranks), in the group's rank
    order.  NCCL and gloo both take CUDA tensors here: gloo copies them
    through the host inside its own collective."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


def shard_block(n: int, parts: int, index: int, what: str) -> slice:
    """Block ``index`` of ``parts`` equal blocks of an axis of ``n``;
    raises where ``parts`` does not divide ``n``, as ``shard_map``
    does."""
    if n % parts:
        raise ValueError(f"{what} ({n}) does not divide into {parts} "
                         f"shards")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def check_device(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device``, the device this
    rank of a mesh computes on."""
    for name, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}; this rank of the "
                             f"mesh computes on {device}")
