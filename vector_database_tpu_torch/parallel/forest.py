"""Sharded forest: one BSP tree per rank over its block of rows (port of
``vector_database_tpu/parallel/forest.py``).

Each rank owns a contiguous block of rows and its own tree; a query fans
out to every rank, each walks its tree and reranks its candidates, and the
per-rank top-k lists merge into the global top-k through one all-gather
(``merge_topk``). Exactness holds: every member of the global top-k within
``radius`` is in its own rank's top-k.

Rank trees differ in size, so node tables and row blocks are padded to the
widest rank's (all-reduced maxima): padded rows are +inf (never match),
padded nodes unreachable leaves. The same widths on every rank keep the
gathered shapes equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vector_database_tpu_torch.builder import build_index_fused
from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d
from vector_database_tpu_torch.parallel.mesh import (
    all_gather,
    axis_rank,
    axis_size,
    mesh_device,
    psum,
)
from vector_database_tpu_torch.search import _rerank, _traverse_bfs


def _stable_topk(rows, d2, k):
    """The ``k`` smallest ``d2`` of each row with their ``rows``, equal
    distances in column order (as ``lax.top_k`` of ``-d2`` orders them)."""
    d2, pos = torch.sort(d2, dim=1, stable=True)
    return rows.gather(1, pos[:, :k]), d2[:, :k]


def merge_topk(rows, d2, *, k, mesh: DeviceMesh, axis: str = "data"):
    """Exact global top-k over every rank's ``[Q, C]`` shortlist of
    ``mesh[axis]``; a collective. Returns ``(rows [Q, min(k, P*C)], d2)``
    on every rank, -1 where the distance is not finite.

    JAX's ``merge_topk`` takes the stacked ``[P, Q, C]`` lists and keeps
    the lower index on equal distances; here each rank first keeps its
    own ``min(k, C)`` best (a stable sort), the ranks all-gather those,
    and a stable sort of the ``[Q, P*k]`` rank-major concatenation picks
    the winners: the same entries, in the same order, with ``P * k``
    instead of ``P * C`` per query on the wire."""
    k_loc = min(k, d2.shape[1])
    rows, d2 = _stable_topk(rows, d2, k_loc)
    q = d2.shape[0]
    rows_f = all_gather(rows, mesh, axis).transpose(0, 1).reshape(q, -1)
    d2_f = all_gather(d2, mesh, axis).transpose(0, 1).reshape(q, -1)
    rows, d2 = _stable_topk(rows_f, d2_f, min(k, rows_f.shape[1]))
    return torch.where(torch.isfinite(d2), rows, -1), d2


@dataclasses.dataclass
class ShardedForest:
    """This rank's tree of a forest, padded to the widest rank's tables.
    JAX stacks the trees into ``[P, ...]``; rank ``p`` holds row ``p``."""

    dim: torch.Tensor  # [M]
    mid: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor
    leaf_start: torch.Tensor
    leaf_count: torch.Tensor
    vectors: torch.Tensor  # [n_max, D], +inf padding
    orig_row: torch.Tensor  # [n_max] global rows, -1 padding
    depth: int
    leaf_cap: int
    num_shards: int
    mesh: DeviceMesh
    axis: str

    @classmethod
    def from_numpy(cls, arrays, meta, mesh: DeviceMesh, *,
                   axis: str = "data") -> "ShardedForest":
        """This rank's tree from a JAX ``ShardedForest``'s ``[P, ...]``
        arrays as numpy and ``meta`` (``depth``, ``leaf_cap``): rank ``p``
        takes row ``p``, on the mesh's device."""
        p, shards = axis_rank(mesh, axis), axis_size(mesh, axis)
        if np.asarray(arrays["dim"]).shape[0] != shards:
            raise ValueError("the forest was built over another number of "
                             "devices")
        dev = mesh_device(mesh)
        return cls(
            **{f: torch.as_tensor(np.array(np.asarray(arrays[f])[p]),
                                  device=dev)
               for f in ("dim", "mid", "low", "high", "leaf_start",
                         "leaf_count", "vectors", "orig_row")},
            depth=int(meta["depth"]), leaf_cap=int(meta["leaf_cap"]),
            num_shards=shards, mesh=mesh, axis=axis,
        )


def build_forest(
    vectors,
    mesh: DeviceMesh,
    *,
    axis: str = "data",
    leaf_size: int = 8,
) -> ShardedForest:
    """Split rows into ``mesh[axis]`` contiguous blocks (numpy
    ``linspace`` bounds, as JAX) and build one tree per rank: every rank
    passes the whole matrix and builds only its own block's tree, the
    "real pod" form of the JAX docstring. A collective (the padded widths
    are all-reduced)."""
    if isinstance(vectors, torch.Tensor):
        n, d = vectors.shape
    else:
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
    shards = axis_size(mesh, axis)
    if n < shards:
        raise ValueError(
            f"build_forest needs at least one vector per shard "
            f"(n={n} < shards={shards}); use build_index for tiny sets"
        )
    p = axis_rank(mesh, axis)
    bounds = np.linspace(0, n, shards + 1).astype(int)
    lo, hi = int(bounds[p]), int(bounds[p + 1])
    dev = mesh_device(mesh)
    ix = build_index_fused(as_f32(vectors[lo:hi], dev), leaf_size=leaf_size)

    widths = torch.tensor([ix.num_nodes, ix.n, ix.depth, ix.leaf_cap],
                          dtype=torch.int64, device=dev)
    m_max, n_max, depth, leaf_cap = psum(widths, mesh, axis, "max").tolist()

    def pad(t, width, value):
        out = torch.full((width, *t.shape[1:]), value, dtype=t.dtype,
                         device=dev)
        out[: t.shape[0]] = t
        return out

    return ShardedForest(
        dim=pad(ix.dim, m_max, -1),
        mid=pad(ix.mid, m_max, 0.0),
        low=pad(ix.low, m_max, -1),
        high=pad(ix.high, m_max, -1),
        leaf_start=pad(ix.leaf_start, m_max, 0),
        leaf_count=pad(ix.leaf_count, m_max, 0),
        vectors=pad(ix.vectors, n_max, float("inf")),
        orig_row=pad(ix.orig_row + lo, n_max, -1),
        depth=depth,
        leaf_cap=leaf_cap,
        num_shards=shards,
        mesh=mesh,
        axis=axis,
    )


def forest_knn(
    forest: ShardedForest,
    queries,
    k: int,
    radius: float,
    *,
    max_leaves: int = 256,
):
    """Global k-NN within ``radius``: each rank walks its tree and reranks
    its rows, then ``merge_topk``; a collective. Returns ``(rows [Q, k],
    sq_dists [Q, k], overflow [P, Q])`` on every rank; rows are global
    ids, -1 / +inf padding when fewer than k matches exist."""
    dev = forest.vectors.device
    queries = atleast_2d(as_f32(queries, dev))
    radius = torch.tensor(radius, dtype=torch.float32, device=dev)
    leaves, _, ov = _traverse_bfs(
        forest.dim, forest.mid, forest.low, forest.high, queries, radius,
        max_leaves=max_leaves, depth=forest.depth,
    )
    rows, d2, _, _, _ = _rerank(
        forest.leaf_start, forest.leaf_count, forest.vectors,
        forest.orig_row, leaves, queries, radius, leaf_cap=forest.leaf_cap,
    )
    rows, d2 = merge_topk(rows, d2, k=k, mesh=forest.mesh, axis=forest.axis)
    return rows, d2, all_gather(ov, forest.mesh, forest.axis)
