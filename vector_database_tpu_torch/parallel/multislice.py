"""Multi-process entry, slices of ranks and the cross-slice index (port of
``vector_database_tpu/parallel/multislice.py``).

The design rule of the JAX module holds: collectives that touch per-row
data stay inside a slice (a group of ranks on one fast fabric: the GPUs of
one host over NVLink, say); only ``[Q, k]``-sized results cross slices.
Rows are partitioned across slices, each slice builds its own sharded
global tree (``build_index_sharded`` over the slice's ranks), and serving
merges the per-slice top-k lists across every rank.

Slices here are always "virtual": the world's ranks partitioned evenly in
rank order, which is how the JAX tests drive it too. One 2-D
``("slice", axis)`` device mesh holds them; its ``axis`` submesh is this
rank's slice.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vector_database_tpu_torch.ops import collectives
from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d
from vector_database_tpu_torch.parallel.global_tree import (
    ShardedBSPIndex,
    _as_reader,
    _knn_global_async,
    build_index_sharded,
    make_sharded_rows,
    search_global,
)
from vector_database_tpu_torch.parallel.mesh import _init_world


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: str = "cuda",
    **kwargs,
) -> bool:
    """Start the multi-process world: one process per device (NCCL on
    ``cuda``, each process on ``cuda:LOCAL_RANK``; Gloo on ``cpu``).

    Arguments default to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
    ``coordinator_address`` is ``host:port``. ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``init_method``,
    ``timeout``, ...). Returns True when a multi-process world is (or
    already was) running, False for the single-process no-op, so that
    single-process callers and tests call it unconditionally."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes is None and coordinator_address is not None:
        raise ValueError("coordinator_address needs num_processes (or "
                         "WORLD_SIZE)")
    if num_processes is None or num_processes <= 1:
        return False
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device_type='cuda') needs "
                               "an NVIDIA GPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if coordinator_address is not None:
        kwargs.setdefault("init_method", f"tcp://{coordinator_address}")
    else:
        kwargs.setdefault("init_method", "env://")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return True


def slice_groups(ranks=None, n_slices: Optional[int] = None) -> List[List]:
    """The world's ranks (or ``ranks``) partitioned evenly, in order, into
    ``n_slices`` virtual slices (default 1)."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n_slices = n_slices or 1
    if len(ranks) % n_slices:
        raise ValueError(
            f"{len(ranks)} devices do not split into {n_slices} slices"
        )
    per = len(ranks) // n_slices
    return [ranks[i * per:(i + 1) * per] for i in range(n_slices)]


def make_slice_meshes(
    n_slices: Optional[int] = None,
    axis: str = "data",
    *,
    device_type: str = "cuda",
) -> List[Optional[DeviceMesh]]:
    """One 1-D mesh per slice, as JAX returns; a collective over the
    world. A rank holds only its own slice's mesh: the other entries are
    None."""
    _init_world(device_type)
    groups = slice_groups(n_slices=n_slices)
    mesh2 = DeviceMesh(device_type, torch.tensor(groups),
                       mesh_dim_names=("slice", axis))
    mine = mesh2.get_local_rank("slice")
    return [mesh2[axis] if s == mine else None for s in range(len(groups))]


@dataclasses.dataclass
class MultiSliceIndex:
    """Rows partitioned across slices; one sharded global tree per slice.
    ``slices[s]`` is this rank's part of slice ``s``'s tree, None for the
    slices it is not in; slice ``s`` maps its rows to global ids by
    ``offsets[s]``."""

    slices: List[Optional[ShardedBSPIndex]]
    offsets: List[int]  # global row id of each slice's row 0
    n: int

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def device(self) -> torch.device:
        return next(s for s in self.slices if s is not None).device


def build_index_multislice(
    source,
    *,
    n: Optional[int] = None,
    n_slices: Optional[int] = None,
    axis: str = "data",
    leaf_size: int = 1,
    device_type: str = "cuda",
    **build_kwargs,
) -> MultiSliceIndex:
    """Partition rows across slices (numpy ``linspace`` bounds) and build
    one ``build_index_sharded`` tree per slice over that slice's ranks;
    every rank calls it with the same source description and reads only
    its own rows (``make_sharded_rows``).

    ``source``: a matrix, a store with ``.rows(start, count)``, or a
    callable ``(lo, hi) -> rows`` with ``n=``."""
    reader, n = _as_reader(source, n)
    meshes = make_slice_meshes(n_slices, axis=axis, device_type=device_type)
    s = len(meshes)
    if n < s:
        raise ValueError(f"need at least {s} rows for {s} slices")
    bounds = np.linspace(0, n, s + 1).astype(np.int64).tolist()
    slices, offsets = [], []
    for mesh, lo, hi in zip(meshes, bounds[:-1], bounds[1:]):
        offsets.append(lo)
        if mesh is None:
            slices.append(None)
            continue
        rows = make_sharded_rows(
            lambda a, b, lo=lo: reader(lo + a, lo + b), mesh,
            axis=axis, n=hi - lo,
        )
        slices.append(build_index_sharded(rows, mesh, axis=axis,
                                          leaf_size=leaf_size,
                                          **build_kwargs))
    return MultiSliceIndex(slices=slices, offsets=offsets, n=n)


def _cross_process_concat(rows, d2):
    """All-gather the ``[Q, C]`` merge inputs over every rank and drop
    duplicate row ids per query (the ranks of one slice report the same
    results), keeping each id's first occurrence in gathered order."""
    if dist.get_world_size() == 1:
        return rows, d2
    g_rows = collectives.all_gather(rows, dist.group.WORLD)  # [P, Q, C]
    g_d2 = collectives.all_gather(d2, dist.group.WORLD)
    p, q, c = g_rows.shape
    rows = g_rows.transpose(0, 1).reshape(q, p * c)
    d2 = g_d2.transpose(0, 1).reshape(q, p * c)
    width = rows.shape[1]
    col = torch.arange(width, device=rows.device).expand(q, width)
    # a stable sort by row id keeps first occurrences first within ties
    order = torch.argsort(rows, dim=1, stable=True)
    sr, sc, sd = (t.gather(1, order) for t in (rows, col, d2))
    first = torch.ones_like(sr, dtype=torch.bool)
    first[:, 1:] = sr[:, 1:] != sr[:, :-1]
    keep = first & (sr >= 0)
    # back into candidate order, the dropped entries last
    back = torch.argsort(torch.where(keep, sc, width + sc), dim=1,
                         stable=True)
    out_rows = torch.where(keep, sr, -1).gather(1, back)
    out_d2 = torch.where(keep, sd, float("inf")).gather(1, back)
    return out_rows, out_d2


def _pad_width(rows, d2, want):
    pad = want - rows.shape[1]
    if pad > 0:
        rows = torch.nn.functional.pad(rows, (0, pad), value=-1)
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
    return rows, d2


def knn_multislice(
    index: MultiSliceIndex,
    queries,
    k: int,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """k nearest within ``radius`` across all slices: per-slice sharded
    search and top-k merge inside each slice, then the ``[Q, k]``-sized
    merge across every rank; a collective over the world. Returns
    ``(rows [Q, k], sq_dists)`` with global row ids, the same on every
    rank. Equal distances keep the lower slice first (a stable sort; JAX
    picks with an unstable ``argsort``)."""
    dev = index.device
    queries = atleast_2d(as_f32(queries, dev))
    q = queries.shape[0]
    parts_r, parts_d = [], []
    overflowed = 0
    for sl, off in zip(index.slices, index.offsets):
        if sl is None:
            continue
        r, d, ov = _knn_global_async(sl, queries, k, radius,
                                     max_leaves=max_leaves)
        parts_r.append(torch.where(r >= 0, r.to(torch.int64) + off, -1))
        parts_d.append(d)
        overflowed += int(ov.any())
    if overflowed:
        warnings.warn(
            f"knn_multislice: the per-shard leaf buffer overflowed in "
            f"{overflowed} slice(s); results may miss neighbors — raise "
            "max_leaves or use the sharded scan for non-selective "
            "queries.",
            RuntimeWarning,
            stacklevel=2,
        )
    rows = torch.cat(parts_r, dim=1)
    d2 = torch.cat(parts_d, dim=1)
    # a uniform width on every rank for the gather
    rows, d2 = _pad_width(rows, d2, k * index.num_slices)
    rows, d2 = _cross_process_concat(rows, d2)
    d2, pick = torch.sort(d2, dim=1, stable=True)
    d2 = d2[:, :k]
    rows = rows.gather(1, pick[:, :k])
    return torch.where(torch.isfinite(d2), rows, -1), d2


def search_multislice(
    index: MultiSliceIndex,
    queries,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """Exact ε-ball across slices: per-slice ``search_global`` results with
    global row ids, gathered over every rank and deduplicated; the same
    on every rank, a collective over the world. Returns ``(rows [Q, C],
    sq_dists [Q, C], count [Q], overflow [Q])``."""
    dev = index.device
    queries = atleast_2d(as_f32(queries, dev))
    all_rows, all_d2, ovs = [], [], []
    for sl, off in zip(index.slices, index.offsets):
        if sl is None:
            continue
        rows, d2, _, ov = search_global(sl, queries, radius,
                                        max_leaves=max_leaves)
        all_rows.append(torch.where(rows >= 0, rows.to(torch.int64) + off,
                                    -1))
        all_d2.append(d2)
        ovs.append(ov)
    rows = torch.cat(all_rows, dim=1)
    d2 = torch.cat(all_d2, dim=1)
    ov = torch.stack(ovs).any(dim=0)
    if dist.get_world_size() > 1:
        # agree on one candidate width before the gather
        width = torch.tensor([rows.shape[1]], device=dev)
        want = int(collectives.all_reduce(width, dist.group.WORLD, "max")[0])
        rows, d2 = _pad_width(rows, d2, want)
        rows, d2 = _cross_process_concat(rows, d2)
        ov = collectives.all_gather(ov, dist.group.WORLD).any(dim=0)
    return rows, d2, (rows >= 0).sum(dim=1), ov
