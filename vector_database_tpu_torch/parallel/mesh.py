"""Meshes over ``torch.distributed`` ranks (port of
``vector_database_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, the counterpart of a named ``jax.sharding.Mesh``: one process
per device, each holding its own shard. Building a mesh is collective:
every rank calls it with the same arguments.

The process group behind it comes from the caller's
``init_process_group``, else from torchrun's environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), else it is a
world of one rank from a local store. NCCL serves ``cuda`` meshes (each
rank on ``cuda:LOCAL_RANK``), Gloo ``cpu`` meshes; a ``cuda`` mesh
without a card raises, and a failed NCCL start is not retried on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vector_database_tpu_torch.ops import collectives


def _init_world(device_type: str) -> None:
    """Start the default process group if none exists (see the module
    docstring); check that a ``cuda`` mesh has a card."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a cuda mesh needs an NVIDIA GPU (torch.cuda.is_available() is "
            "False); pass device_type='cpu' for a Gloo mesh on the host")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type: {device_type}")
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:  # torchrun
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = "data",
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all)."""
    _init_world(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices requested of a world of {world}")
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis,))


def make_mesh_2d(
    data: int,
    model: int,
    axes: Sequence[str] = ("data", "model"),
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A 2-D mesh: rows sharded over ``data``, vector dims over ``model``.
    ``mesh[axes[0]]`` is this rank's 1-D submesh along ``data``."""
    _init_world(device_type)
    world = dist.get_world_size()
    if data * model > world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the world has {world}")
    return DeviceMesh(device_type,
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """``mesh.shape[axis]`` of a JAX mesh."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """``lax.axis_index(axis)``: this rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def psum(t: torch.Tensor, mesh: DeviceMesh, axis: str,
         op: str = "sum") -> torch.Tensor:
    """``lax.psum`` (``op="max"``/``"min"``: ``pmax``/``pmin``) over
    ``mesh[axis]``."""
    return collectives.all_reduce(t, mesh.get_group(axis), op)


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.all_gather`` over ``mesh[axis]``: ``[P, *t.shape]``."""
    return collectives.all_gather(t, mesh.get_group(axis))


def shard_bounds(n: int, shards: int, p: int):
    """``(lo, hi, n_loc)``: shard ``p`` of ``n`` rows cut into ``shards``
    contiguous blocks of ``n_loc = ceil(n / shards)`` (the last ones short
    or empty)."""
    n_loc = -(-n // shards)
    lo = min(p * n_loc, n)
    return lo, min(lo + n_loc, n), n_loc


def shard_rows(array, mesh: DeviceMesh, axis: str = "data"):
    """This rank's block of ``array`` (every rank passes the whole array)
    along its leading dim, cut into ``mesh[axis]`` contiguous blocks of
    ``ceil(n / P)`` rows, on the mesh's device; the last blocks may be
    short or empty. JAX places one global array; here each rank keeps its
    block."""
    lo, hi, _ = shard_bounds(array.shape[0], axis_size(mesh, axis),
                             axis_rank(mesh, axis))
    dev = mesh_device(mesh)
    if isinstance(array, torch.Tensor):
        return array[lo:hi].to(dev)
    return torch.as_tensor(np.ascontiguousarray(array[lo:hi]), device=dev)
