"""Device meshes over an initialized ``torch.distributed`` world.

The caller starts the processes and initializes the process group (its
address, world size and rank); a function here only lays the world's
ranks out as a named ``DeviceMesh``, as ``jax.make_mesh`` lays out
devices.  Rank ``r`` sits at the row-major coordinate of ``r`` in the
mesh's shape, which is the device order of ``jax.make_mesh``.

The mesh's device type follows ``kernels.resolve_device``: ``cuda``
unless the caller passes ``"cpu"``.  On ``cuda`` each rank computes on
``cuda:{local_rank % device_count}``, so several ranks may share one
card (a gloo world on one GPU; NCCL takes one rank per card).  What
the multi-device steps do with a mesh (a rank's place and device, its
groups, the gathers) is in ``repro_torch.collectives``.
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels import DeviceLike, resolve_device


def _world(device: DeviceLike) -> Tuple[int, str]:
    if not dist.is_initialized():
        raise RuntimeError("initialize torch.distributed (its address, "
                           "world size and rank) before building a mesh")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return dist.get_world_size(), dev.type


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``.  Raises unless the world has exactly
    that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, dev_type = _world(device)
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {n}")
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """Every rank of the world, data x model (for tests/examples)."""
    n, dev_type = _world(device)
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the world's "
                         f"{n} ranks")
    return init_device_mesh(dev_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
