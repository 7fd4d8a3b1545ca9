"""Level-synchronous BSP index builder (port of
``vector_database_tpu/builder.py``).

The build is the set-oriented formulation of the reference's
``dbo.BuildIndex``: one pass over the device-resident ``[N, D]`` matrix per
tree level, doing the stats and the partition for every live range at
once. Two forms:

- ``build_index_fused``, the production build (``ops/sorted_build.py``):
  rows kept segment-contiguous, one host sync a level;
- ``build_index``, the host-loop build (``ops/level.py``): rows stay in
  place, each level's node block comes to the host (and to ``emit``) as
  it is made, and one stable sort lays the rows out leaf-major at the end.
  It also runs over a mesh: rows sharded over one axis, and optionally
  the vector dimensions over another (the tensor-parallel build).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.exact import as_f32
from vector_database_tpu_torch.ops.level import level_step, next_pow2
from vector_database_tpu_torch.ops.sorted_build import (
    check_mean_id_rows,
    segment_capacity,
    sorted_build,
)
from vector_database_tpu_torch.utils.profiling import spanned


def _mesh_block(vectors, mesh, axis: str, dim_axis: Optional[str]):
    """This rank's block of the whole matrix ``vectors`` (the same on every
    rank) on the mesh's device: rows ``shard_bounds`` of ``mesh[axis]``
    (the last blocks short or empty), and under ``dim_axis`` the rank's
    ``d / mesh[dim_axis]`` columns. Returns ``(block, global row ids, n,
    d)``; raises where ``d`` does not divide over ``dim_axis``."""
    from vector_database_tpu_torch.parallel.mesh import (
        axis_rank,
        axis_size,
        mesh_device,
        shard_bounds,
    )

    if not isinstance(vectors, torch.Tensor):
        vectors = np.asarray(vectors, np.float32)
    n, d = vectors.shape
    c0, c1 = 0, d
    if dim_axis is not None:
        shards = axis_size(mesh, dim_axis)
        if d % shards:
            raise ValueError(
                "vector dim must divide evenly across the dim_axis shards")
        c0 = axis_rank(mesh, dim_axis) * (d // shards)
        c1 = c0 + d // shards
    lo, hi, _ = shard_bounds(n, axis_size(mesh, axis), axis_rank(mesh, axis))
    dev = mesh_device(mesh)
    block = as_f32(vectors[lo:hi, c0:c1], dev)
    return block, torch.arange(lo, hi, device=dev), n, d


def _gather_whole(block, leaf_of_point, n, mesh, axis, dim_axis):
    """The whole ``[n, d]`` matrix and ``[n]`` leaf ids on every rank, from
    every rank's block: an all-gather of the row blocks (each padded to
    ``ceil(n / P)`` rows: the real rows are the first ``n`` of the
    concatenation) over ``axis``, then of the columns over ``dim_axis``."""
    from vector_database_tpu_torch.parallel.mesh import all_gather, axis_size

    n_loc = -(-n // axis_size(mesh, axis))
    pad = n_loc - block.shape[0]
    rows = all_gather(torch.nn.functional.pad(block, (0, 0, 0, pad)), mesh,
                      axis).reshape(-1, block.shape[1])[:n]
    leaf = all_gather(torch.nn.functional.pad(leaf_of_point, (0, pad)), mesh,
                      axis).reshape(-1)[:n]
    if dim_axis is not None:
        rows = all_gather(rows, mesh, dim_axis).permute(1, 0, 2).reshape(n, -1)
    return rows, leaf


def _level_to_host(out, s_live: int):
    """``cnt``, ``split_dim``, ``mid`` and ``dual`` of the live segments in
    one device-to-host copy."""
    packed = torch.cat([
        out["cnt"][:s_live], out["split_dim"][:s_live],
        out["mid"][:s_live].view(torch.int32),
        out["dual"][:s_live].to(torch.int32),
    ]).cpu().numpy().reshape(4, s_live)
    return packed[0], packed[1], packed[2].view(np.float32), \
        packed[3].astype(bool)


def build_index(
    vectors,
    *,
    leaf_size: int = 1,
    max_levels: Optional[int] = None,
    progress: Optional[Callable[[int, int, int], None]] = None,
    emit: Optional[Callable] = None,
    mesh=None,
    axis: str = "data",
    dim_axis: Optional[str] = None,
    device=None,
) -> BSPIndex:
    """Build a variance-split BSP index over ``vectors`` with the host
    loop: one ``ops/level.level_step`` a tree level.

    Args:
      vectors: ``[N, D]`` (cast to float32), on ``device``, else where a
        tensor lies, else the card (``cuda``).
      leaf_size: stop splitting ranges at this size; 1 = the reference's
        singleton leaves.
      max_levels: optional cap on depth; remaining ranges become
        (oversized) leaves.
      progress: optional ``(level, live_segments, active_rows)`` callback
        after each level (``utils/profiling.BuildStats``,
        ``ProgressLogger``).
      emit: optional ``(node_base, dim, mid, low, high)`` callback with
        each level's numpy node block as soon as it is made; node ids are
        ``node_base + i``, ``dim == -1`` rows are leaves, ``-2`` dual
        (id-partitioned) nodes. The blocks concatenate to the node table.
      mesh: optional ``DeviceMesh`` (``parallel.make_mesh``/
        ``make_mesh_2d``); every rank of it calls with the same arguments
        and the whole matrix. Each rank keeps its block of rows along
        ``mesh[axis]`` (and, with ``dim_axis``, its ``D / P`` columns along
        ``mesh[dim_axis]``; ``D`` must divide), each level's statistics are
        all-reduced, and the one global tree is the single-device tree
        (bit for bit on integer-valued data, and at one rank). Every rank
        returns the whole index, so the leaf-major matrix is gathered onto
        every rank at the end: it costs the whole ``[N, D]`` matrix on each.
        ``parallel.build_index_sharded`` is the form that keeps each rank's
        rows on its shard.
      axis, dim_axis: the mesh axes holding row shards and, optionally,
        column shards.
      device: where the rows go without a mesh (a mesh uses its own).

    Returns:
      A ``BSPIndex`` with dense node ids in level-major order (root 0).
    """
    if mesh is None:
        block = as_f32(vectors, device)
        n, d = block.shape
        row_ids = torch.arange(n, device=block.device)
        mesh_kw = {}
    else:
        block, row_ids, n, d = _mesh_block(vectors, mesh, axis, dim_axis)
        mesh_kw = dict(mesh=mesh, axis_name=axis, dim_axis_name=dim_axis)
    if n == 0:
        raise ValueError("cannot build an index over zero vectors")
    if leaf_size < 1:
        raise ValueError("leaf_size must be >= 1")
    # JAX's exact mean-id limbs bound the rows (int32 ids)
    check_mean_id_rows(n)
    dev = block.device
    seg = torch.zeros(block.shape[0], dtype=torch.int32, device=dev)
    leaf_of_point = torch.full_like(seg, -1)

    levels = []  # per level: the numpy node block (dim, mid, low, high)
    s_live, node_base, use_max, level, num_leaves = 1, 0, True, 0, 0
    # forced progress shrinks every internal segment each level, but
    # skewed data can still be deep: a generous bound by default
    hard_cap = max_levels if max_levels is not None else n + 64
    while True:
        out = level_step(block, row_ids, seg, leaf_of_point, use_max,
                         node_base, num_segments=next_pow2(s_live),
                         leaf_size=leaf_size, **mesh_kw)
        # the level's one device-to-host transfer (the same on every rank)
        cnt, split_dim, mid, dual = _level_to_host(out, s_live)
        # dual (id-partitioned) nodes have no separating plane: dim = -2
        split_dim = np.where(dual, -2, split_dim)
        mid = np.where(dual, 0.0, mid).astype(np.float32)

        is_int = cnt > leaf_size
        num_internal = int(is_int.sum())
        at_cap = level + 1 >= hard_cap and num_internal > 0
        if progress is not None:
            progress(level, s_live, int(cnt.sum()))
        if at_cap:
            # retire every remaining segment as an oversized leaf
            is_int = np.zeros_like(is_int)
            num_internal = 0
            leaf_of_point = torch.where(seg >= 0, node_base + seg,
                                        leaf_of_point)
        else:
            seg, leaf_of_point = out["new_seg"], out["new_leaf"]

        rank = np.cumsum(is_int) - is_int
        next_base = node_base + s_live
        num_leaves += s_live - num_internal
        levels.append((
            np.where(is_int, split_dim, -1).astype(np.int32),
            np.where(is_int, mid, 0.0).astype(np.float32),
            np.where(is_int, next_base + 2 * rank, -1).astype(np.int32),
            np.where(is_int, next_base + 2 * rank + 1, -1).astype(np.int32),
        ))
        if emit is not None:
            emit(node_base, *levels[-1])
        if num_internal == 0:
            break
        node_base = next_base
        s_live = 2 * num_internal
        use_max = not use_max
        level += 1

    num_nodes = next_base
    node = [torch.as_tensor(np.concatenate(col), device=dev)
            for col in zip(*levels)]
    if mesh is not None:
        block, leaf_of_point = _gather_whole(block, leaf_of_point, n, mesh,
                                             axis, dim_axis)
    leaf_start, leaf_count, sorted_vectors, orig_row = _finalize(
        block, leaf_of_point, num_nodes)
    return BSPIndex(
        dim=node[0],
        mid=node[1],
        low=node[2],
        high=node[3],
        leaf_start=leaf_start,
        leaf_count=leaf_count,
        vectors=sorted_vectors,
        orig_row=orig_row,
        depth=level + 1,
        leaf_cap=int(leaf_count.max()),
        num_leaves=num_leaves,
    )


def _finalize(vectors, leaf_of_point, num_nodes: int):
    """Lay the rows out leaf-major: ``(leaf_start, leaf_count, vectors,
    orig_row)`` from a stable sort by leaf (rows of one leaf keep their
    input order) and the leaf sizes (0 for internal nodes)."""
    leaf = leaf_of_point.to(torch.int64)
    order = torch.argsort(leaf, stable=True)
    counts = torch.bincount(leaf, minlength=num_nodes)
    starts = torch.cumsum(counts, dim=0) - counts
    return (starts.to(torch.int32), counts.to(torch.int32), vectors[order],
            order.to(torch.int32))


@spanned("vdb_torch.build")
def build_index_fused(
    vectors,
    *,
    leaf_size: int = 1,
    max_levels: Optional[int] = None,
    stats_subsample: Optional[int] = None,
    donate: bool = False,
    tie_break: str = "positional",
    progress: Optional[Callable[[int, int, int], None]] = None,
    split: str = "alternate",
    device=None,
) -> BSPIndex:
    """Build a variance-split BSP index over ``vectors`` (``[N, D]``, cast
    to float32, on ``device``, else where a tensor lies, else the card).

    ``leaf_size``: stop splitting ranges at this size (1 = the reference's
    singleton leaves). ``max_levels``: optional depth cap; remaining ranges
    become oversized leaves. ``stats_subsample``: rank split dimensions
    from every k-th row (default 4 above 500k rows, else 1); the split
    planes stay exact. ``donate``: accepted for the JAX signature. The
    build reads the rows in place and writes the leaf-major matrix as a
    new tensor; the input lives on while the caller holds it (``del`` it
    to free it). ``tie_break``:
    ``"positional"`` halves rows on the plane (and zero-variance
    segments) by rank; ``"mean_id"`` is the
    reference rule ``id > floor(mean(ids))`` with exact id sums, for
    reference tree-shape parity (at most 2^30 - 1 rows, as in the JAX
    package). ``progress``: host callback ``(level, live_segments,
    active_rows)`` once per level.
    ``split``: ``"alternate"`` (the reference's max/min-variance parity
    rule) or ``"max"`` (max variance every level).
    """
    del donate
    vectors = as_f32(vectors, device)
    n, d = vectors.shape
    if n == 0:
        raise ValueError("cannot build an index over zero vectors")
    if leaf_size < 1:
        raise ValueError("leaf_size must be >= 1")
    if tie_break not in ("positional", "mean_id"):
        raise ValueError("tie_break must be 'positional' or 'mean_id'")
    if split not in ("alternate", "max"):
        raise ValueError("split must be 'alternate' or 'max'")
    if tie_break == "mean_id":
        check_mean_id_rows(n)
    hard_cap = max_levels if max_levels is not None else n + 64
    if stats_subsample is None:
        # above ~500k rows, subsample the variance ranking pass
        stats_subsample = 4 if n > 500_000 else 1

    nd, nm, nl, nh, nls, nlc, pid, pvec, total_nodes, level = sorted_build(
        vectors,
        torch.arange(n, dtype=torch.int32, device=vectors.device),
        n,
        s_max=segment_capacity(n, leaf_size),
        m_max=2 * n,
        leaf_size=leaf_size,
        max_levels=hard_cap,
        stats_subsample=stats_subsample,
        tie_break=tie_break,
        progress_cb=progress,
        split=split,
    )
    return BSPIndex(
        dim=nd,
        mid=nm,
        low=nl,
        high=nh,
        leaf_start=nls,
        leaf_count=nlc,
        vectors=pvec,
        orig_row=pid,
        depth=level,
        leaf_cap=int(nlc.max()),
        num_leaves=int((nd == -1).sum()),  # -2 = dual internal, not leaf
    )
