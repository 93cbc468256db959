"""The device mesh of a multi-process run.

Counterpart of the JAX package's `parallel/mesh.py`. A JAX `Mesh` names the
devices one program drives; here every device has a process of its own
(parallel.distributed), so the mesh is the world of the process group, laid
out along named axes. Each process holds its own view of it: the size of
every axis, the process group of every axis (the ranks that share this
rank's coordinates on the other axes), this rank's coordinate on every axis,
and the device this rank computes on. With a process group up it is built on
`torch.distributed.device_mesh.init_device_mesh`; without one it is a mesh
of one rank and no group.

One difference from the JAX package: `make_mesh(n)` takes the whole world
(n must be the world size). The JAX package can take the first n of a host's
devices; a process cannot leave the world it joined.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from curdleproofs_tpu_torch.parallel.distributed import local_device
from curdleproofs_tpu_torch.utils.device import DeviceArg


class Mesh:
    """axis_names, shape (axis -> size), and for this rank: groups (axis ->
    process group, None in a world of one process), coords (axis -> this
    rank's index along it) and device."""

    def __init__(
        self,
        axis_names: Tuple[str, ...],
        shape: Dict[str, int],
        groups: Dict[str, Optional[dist.ProcessGroup]],
        coords: Dict[str, int],
        device: torch.device,
    ) -> None:
        self.axis_names = axis_names
        self.shape = shape
        self.groups = groups
        self.coords = coords
        self.device = device


def _build(shape: Tuple[int, ...], axis_names: Tuple[str, ...], device: DeviceArg) -> Mesh:
    dev = local_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"requested a mesh of {size} devices, the world has {world} processes")
    if not dist.is_initialized():
        return Mesh(axis_names, dict(zip(axis_names, shape)), {a: None for a in axis_names}, {a: 0 for a in axis_names}, dev)
    from torch.distributed.device_mesh import init_device_mesh

    # the device type of the mesh is the backend's: a gloo world whose ranks
    # share a card moves host tensors
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(kind, shape, mesh_dim_names=axis_names)
    return Mesh(
        axis_names,
        dict(zip(axis_names, shape)),
        {a: dm.get_group(a) for a in axis_names},
        {a: dm.get_local_rank(a) for a in axis_names},
        dev,
    )


def make_mesh(
    n_devices: Optional[int] = None, axis_names: Sequence[str] = ("shard",), device: DeviceArg = None
) -> Mesh:
    """1D mesh over the whole world (n_devices: None or the world size).
    device: this rank's device (default `cuda:LOCAL_RANK`)."""
    axis_names = tuple(axis_names)
    if len(axis_names) != 1:
        raise ValueError("use make_mesh_2d for multi-axis meshes")
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _build((n_devices or world,), axis_names, device)


def make_mesh_2d(shape, axis_names=("batch", "points"), device: DeviceArg = None) -> Mesh:
    """2D mesh over the whole world: data-parallel batch axis x point-sharding
    axis, ranks in row-major order."""
    return _build(tuple(shape), tuple(axis_names), device)
