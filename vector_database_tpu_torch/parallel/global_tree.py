"""Sharded fused build: ONE global tree over row-sharded data (port of
``vector_database_tpu/parallel/global_tree.py``).

Every rank of ``mesh[axis]`` holds a contiguous block of the rows and runs
the production builder (``ops/sorted_build.py`` with ``group=``) on it:
each level's segment statistics are all-reduced over the group, and the
partition moves rows only within their own rank. The result is a single
global BSP tree with no rank ever holding more than its own rows.

Layout: the node table is replicated (identical on every rank); each rank
keeps its rows in local leaf-major order and each leaf owns one
contiguous ``(start, count)`` run per rank. Search runs the replicated
traversal on every rank and reranks rank-locally; the results meet in one
all-gather. Exactness holds because every in-radius row lies in some
rank's run of a reached leaf.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d
from vector_database_tpu_torch.ops.sorted_build import (
    check_mean_id_rows,
    segment_capacity,
    sorted_build,
)
from vector_database_tpu_torch.parallel.mesh import (
    all_gather,
    axis_rank,
    axis_size,
    mesh_device,
    psum,
    shard_bounds,
)
from vector_database_tpu_torch.search import _rerank, _traverse_bfs

_NODE_FIELDS = ("dim", "mid", "low", "high")


@dataclasses.dataclass
class ShardedBSPIndex:
    """A global BSP tree whose rows are sharded over ``mesh[axis]``; the
    part of it one rank holds.

    Node table (replicated, ``[num_nodes]``): as ``BSPIndex``. Leaf runs
    are this rank's: leaf ``m`` holds rows ``[leaf_start[m],
    +leaf_count[m])`` of the rank's ``vectors``/``orig_row`` (``[n_loc,
    D]``/``[n_loc]``, local leaf-major order; rows past the rank's real
    ones are padding with ids >= ``n``). JAX stacks these per-shard arrays
    into ``[P, ...]``; rank ``p`` holds row ``p``. ``leaf_cap`` is the
    longest run on any rank.
    """

    dim: torch.Tensor
    mid: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor
    leaf_start: torch.Tensor  # [M] this rank's run starts
    leaf_count: torch.Tensor  # [M] this rank's run lengths
    vectors: torch.Tensor  # [n_loc, D]
    orig_row: torch.Tensor  # [n_loc] global row ids
    n: int
    depth: int
    leaf_cap: int  # max LOCAL run length over all ranks
    num_leaves: int
    mesh: DeviceMesh
    axis: str

    @property
    def num_nodes(self) -> int:
        return self.dim.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_shards(self) -> int:
        return axis_size(self.mesh, self.axis)

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def leaf_count_global(self) -> torch.Tensor:
        """Global per-node leaf sizes (the sum of every rank's runs): a
        collective, every rank of ``mesh[axis]`` calls it."""
        return psum(self.leaf_count, self.mesh, self.axis)

    @classmethod
    def from_numpy(cls, arrays, meta, mesh: DeviceMesh, *,
                   axis: str = "data") -> "ShardedBSPIndex":
        """This rank's part of a JAX ``ShardedBSPIndex`` from its arrays as
        numpy (``dim``/``mid``/``low``/``high`` ``[M]``,
        ``leaf_start``/``leaf_count`` ``[P, M]``, ``vectors`` ``[P *
        n_loc, D]``, ``orig_row`` ``[P * n_loc]``) and ``meta`` (``n``,
        ``depth``, ``leaf_cap``, ``num_leaves``): rank ``p`` takes shard
        ``p`` and the replicated node table, on the mesh's device."""
        p, shards = axis_rank(mesh, axis), axis_size(mesh, axis)
        dev = mesh_device(mesh)
        if np.asarray(arrays["leaf_start"]).shape[0] != shards:
            raise ValueError("the arrays were sharded over another number "
                             "of devices")
        vec = np.asarray(arrays["vectors"], np.float32)
        n_loc = vec.shape[0] // shards
        sl = slice(p * n_loc, (p + 1) * n_loc)
        t = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
        return cls(
            **{f: t(arrays[f]) for f in _NODE_FIELDS},
            leaf_start=t(np.asarray(arrays["leaf_start"])[p]),
            leaf_count=t(np.asarray(arrays["leaf_count"])[p]),
            vectors=t(vec[sl]),
            orig_row=t(np.asarray(arrays["orig_row"])[sl]),
            n=int(meta["n"]), depth=int(meta["depth"]),
            leaf_cap=int(meta["leaf_cap"]),
            num_leaves=int(meta["num_leaves"]), mesh=mesh, axis=axis,
        )


@dataclasses.dataclass
class ShardedRows:
    """Pre-sharded build inputs: this rank's rows, read by
    :func:`make_sharded_rows` without any rank loading another's. Pass to
    ``build_index_sharded`` in place of a matrix."""

    vectors: torch.Tensor  # [n_loc, D] this rank's rows, zero padded
    row_ids: torch.Tensor  # [n_loc] their global ids
    n_valid: int  # real rows on this rank
    n: int  # global row count
    mesh: DeviceMesh
    axis: str


def _as_reader(source, n):
    """Normalize a row source to ``(reader(lo, hi) -> np.ndarray, n)``:
    a full array, a ``NativeVectorStore``-like object (``.rows(start,
    count)`` + ``len``), or a callable row-range reader with ``n``."""
    if callable(source):
        if n is None:
            raise ValueError("a callable row source needs n=")
        return source, n
    if hasattr(source, "rows"):
        return (lambda lo, hi: source.rows(lo, hi - lo)), len(source)
    if isinstance(source, torch.Tensor):
        return (lambda lo, hi: source[lo:hi]), source.shape[0]
    arr = np.asarray(source, np.float32)
    return (lambda lo, hi: arr[lo:hi]), arr.shape[0]


def make_sharded_rows(
    source,
    mesh: DeviceMesh,
    *,
    axis: str = "data",
    n: Optional[int] = None,
) -> ShardedRows:
    """Read this rank's rows for ``build_index_sharded`` and nothing else.

    ``source``: a matrix, a store with ``.rows(start, count)``, or a
    callable ``(lo, hi) -> rows`` (then ``n`` is required). Rank ``p`` of
    ``mesh[axis]`` owns global rows ``[p * ceil(n/P), ...)``; the reader
    is asked for those and for one probe row, ``[0, 1)``, that gives the
    dimensionality. Every rank calls this with the same source
    description."""
    reader, n = _as_reader(source, n)
    p = axis_rank(mesh, axis)
    lo, hi, n_loc = shard_bounds(n, axis_size(mesh, axis), p)
    dev = mesh_device(mesh)
    d = as_f32(reader(0, 1), "cpu").shape[1]
    if hi - lo == n_loc:
        rows = as_f32(reader(lo, hi), dev)
    else:  # a short or empty last block, zero padded
        rows = torch.zeros((n_loc, d), dtype=torch.float32, device=dev)
        if hi > lo:
            rows[: hi - lo] = as_f32(reader(lo, hi), dev)
    ids = torch.arange(p * n_loc, (p + 1) * n_loc, dtype=torch.int32,
                       device=dev)
    return ShardedRows(vectors=rows, row_ids=ids, n_valid=hi - lo, n=n,
                       mesh=mesh, axis=axis)


def build_index_sharded(
    vectors,
    mesh: DeviceMesh,
    *,
    axis: str = "data",
    leaf_size: int = 1,
    max_levels: Optional[int] = None,
    stats_subsample: Optional[int] = None,
    tie_break: str = "positional",
    donate: bool = False,
) -> ShardedBSPIndex:
    """Build one global tree with rows sharded over ``mesh[axis]``; every
    rank of the axis calls it.

    The tree is ``build_index_fused``'s: bit-exact whenever the f32
    segment sums do not depend on their order (integer-valued data, or
    one rank), else equal up to summation-order ulps in the planes.

    ``vectors``: a :class:`ShardedRows` (each rank read only its own
    rows), or the whole matrix (host or tensor, the same on every rank),
    of which each rank takes its block. ``donate``: accepted for the JAX
    signature. The build reads the rows in place and writes the leaf-major
    matrix as a new tensor; the input lives on while the caller holds it
    (``del`` it to free it).
    """
    del donate
    if isinstance(vectors, ShardedRows):
        if vectors.mesh is not mesh or vectors.axis != axis:
            raise ValueError("ShardedRows built for a different mesh/axis")
        rows = vectors
    else:
        if vectors.shape[0] == 0:
            raise ValueError("cannot build an index over zero vectors")
        rows = make_sharded_rows(vectors, mesh, axis=axis)
    n = rows.n
    if n == 0:
        raise ValueError("cannot build an index over zero vectors")
    if leaf_size < 1:
        raise ValueError("leaf_size must be >= 1")
    if tie_break not in ("positional", "mean_id"):
        raise ValueError("tie_break must be 'positional' or 'mean_id'")
    if tie_break == "mean_id":
        check_mean_id_rows(n)  # the global row count bounds the id sums
    n_loc = rows.vectors.shape[0]
    if stats_subsample is None:
        # the fused build's policy, keyed on the rows one rank holds
        stats_subsample = 4 if n_loc > 500_000 else 1

    nd, nm, nl, nh, nls, nlc, pid, pvec, total, level = sorted_build(
        rows.vectors, rows.row_ids, rows.n_valid,
        s_max=segment_capacity(n, leaf_size),
        m_max=2 * n,
        leaf_size=leaf_size,
        max_levels=max_levels if max_levels is not None else n + 64,
        stats_subsample=stats_subsample,
        tie_break=tie_break,
        group=mesh.get_group(axis),
    )
    leaf_cap = int(psum(nlc.max().reshape(1), mesh, axis, "max")[0])
    return ShardedBSPIndex(
        dim=nd, mid=nm, low=nl, high=nh, leaf_start=nls, leaf_count=nlc,
        vectors=pvec, orig_row=pid, n=n, depth=level, leaf_cap=leaf_cap,
        num_leaves=int((nd == -1).sum()), mesh=mesh, axis=axis,
    )


def to_bsp(index: ShardedBSPIndex) -> BSPIndex:
    """Gather a sharded tree into one ``BSPIndex`` on every rank (for a
    checkpoint, or serving a mesh-built tree on one device); a collective.

    Rows are re-packed leaf-major globally: each leaf's runs concatenate
    in rank order, so every leaf becomes one contiguous global run."""
    mesh, axis = index.mesh, index.axis
    p = index.num_shards
    vec = all_gather(index.vectors, mesh, axis)  # [P, n_loc, D]
    orig = all_gather(index.orig_row, mesh, axis).reshape(-1)
    starts = all_gather(index.leaf_start, mesh, axis).to(torch.int64)
    counts = all_gather(index.leaf_count, mesh, axis).to(torch.int64)
    n_loc = vec.shape[1]
    vec = vec.reshape(p * n_loc, -1)
    g_count = counts.sum(dim=0)
    g_start = torch.cumsum(g_count, dim=0) - g_count

    # each (leaf, rank) run is contiguous at its source and its runs
    # enumerate in (leaf, rank) order, the destination order: the whole
    # repack is one gather built from run lengths
    leaves = torch.nonzero(index.dim == -1)[:, 0]
    lens = counts[:, leaves].T.reshape(-1)  # [L*P], (leaf, rank) order
    src0 = (torch.arange(p, device=vec.device)[None, :] * n_loc
            + starts[:, leaves].T).reshape(-1)
    total = int(lens.sum())
    if total != index.n:
        raise AssertionError(f"leaf runs hold {total} rows, not {index.n}")
    run_begin = torch.cumsum(lens, dim=0) - lens
    src = (torch.repeat_interleave(src0 - run_begin, lens)
           + torch.arange(total, device=vec.device))
    return BSPIndex(
        dim=index.dim, mid=index.mid, low=index.low, high=index.high,
        leaf_start=g_start.to(torch.int32),
        leaf_count=g_count.to(torch.int32),
        vectors=vec[src], orig_row=orig[src],
        depth=index.depth,
        leaf_cap=int(g_count.max()) if index.num_nodes else 0,
        num_leaves=index.num_leaves,
    )


def _shard_local_search(index: ShardedBSPIndex, queries, radius,
                        max_leaves: int):
    """This rank's ``(rows, d2, overflow, match count)``: the traversal
    reads only the replicated node table, so every rank computes the same
    leaves without communication; the rerank reads the rank's own rows."""
    leaves, _, ov = _traverse_bfs(
        index.dim, index.mid, index.low, index.high, queries, radius,
        max_leaves=max_leaves, depth=index.depth,
    )
    rows, d2, match, _, _ = _rerank(
        index.leaf_start, index.leaf_count, index.vectors, index.orig_row,
        leaves, queries, radius, leaf_cap=max(index.leaf_cap, 1),
    )
    return rows, d2, ov, match.sum(dim=1)


def _prepare(index: ShardedBSPIndex, queries, radius, max_leaves):
    queries = atleast_2d(as_f32(queries, index.device))
    radius = torch.tensor(radius, dtype=torch.float32, device=index.device)
    return queries, radius, min(max_leaves, max(index.num_leaves, 1))


def search_global(
    index: ShardedBSPIndex,
    queries,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """Exact ε-ball search on the sharded global tree; a collective.

    Returns ``(rows [Q, P*C], sq_dists [Q, P*C], count [Q], overflow
    [Q])`` on every rank: matching global rows, rank by rank, with -1 /
    +inf padding."""
    queries, radius, max_leaves = _prepare(index, queries, radius,
                                           max_leaves)
    rows, d2, ov, cnt = _shard_local_search(index, queries, radius,
                                            max_leaves)
    mesh, axis = index.mesh, index.axis
    q = queries.shape[0]
    rows = all_gather(rows, mesh, axis).transpose(0, 1).reshape(q, -1)
    d2 = all_gather(d2, mesh, axis).transpose(0, 1).reshape(q, -1)
    return rows, d2, psum(cnt, mesh, axis), ov


def _knn_global_async(
    index: ShardedBSPIndex,
    queries,
    k: int,
    radius,
    *,
    max_leaves: int = 256,
):
    """``knn_global`` without the overflow warning: ``(rows, d2, ov)``,
    ``ov`` this rank's (every rank's traversal is the same)."""
    from vector_database_tpu_torch.parallel.forest import merge_topk

    queries, radius, max_leaves = _prepare(index, queries, radius,
                                           max_leaves)
    rows, d2, ov, _ = _shard_local_search(index, queries, radius,
                                          max_leaves)
    rows, d2 = merge_topk(rows, d2, k=k, mesh=index.mesh, axis=index.axis)
    return rows, d2, ov


def knn_global(
    index: ShardedBSPIndex,
    queries,
    k: int,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """k nearest within ``radius`` on the sharded tree: per-rank rerank,
    then one all-gather top-k merge. Returns ``(rows [Q, k], sq_dists [Q,
    k])``, the same on every rank; a collective."""
    rows, d2, ov = _knn_global_async(index, queries, k, radius,
                                     max_leaves=max_leaves)
    n_ov = psum(ov.sum().reshape(1), index.mesh, index.axis, "max")
    if int(n_ov[0]):
        warnings.warn(
            "knn_global: the per-shard leaf buffer overflowed for "
            f"{int(n_ov[0])} queries; their candidate sets are truncated "
            "(results may miss neighbors). Raise max_leaves or use the "
            "sharded scan (sharded_scan_knn) for non-selective queries.",
            RuntimeWarning,
            stacklevel=2,
        )
    return rows, d2
