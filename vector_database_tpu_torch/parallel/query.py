"""Query-side data parallelism: the query batch split over the ranks of a
mesh (port of ``vector_database_tpu/parallel/query.py``).

Every rank holds the whole tree (node table and rows); each walks it for
its part of the batch with the port's ``search``/``knn``, and one
all-gather gives every rank the whole batch's results.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.collectives import agree_any
from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d
from vector_database_tpu_torch.parallel.mesh import (
    all_gather,
    axis_rank,
    axis_size,
)
from vector_database_tpu_torch.search import (
    SearchResult,
    _knn_select,
    _search,
)


def _local_queries(index: BSPIndex, queries, mesh: DeviceMesh, axis: str):
    """``(this rank's queries, q, q_pad)``: the batch padded to a multiple
    of the rank count with repeats of its first query (not zeros: the
    origin is the centroid of centred data, a worst-case query whose
    overflow would force every rank to grow its leaf buffer), cut into
    equal contiguous parts."""
    queries = atleast_2d(as_f32(queries, index.device))
    q = queries.shape[0]
    shards = axis_size(mesh, axis)
    q_pad = -(-q // shards) * shards
    if q_pad != q:
        queries = torch.cat(
            [queries, queries[:1].expand(q_pad - q, queries.shape[1])])
    per = q_pad // shards
    p = axis_rank(mesh, axis)
    return queries[p * per:(p + 1) * per], q, q_pad


def _search_part(index, queries, radius, mesh, axis, max_leaves):
    """This rank's part of a sharded search: the leaf buffer is sized for
    the whole padded batch, as one search of it would be, and grows only
    when the ranks agree that some query overflowed."""
    local, q, q_pad = _local_queries(index, queries, mesh, axis)
    group = mesh.get_group(axis)
    res = _search(index, local, radius, max_leaves=max_leaves,
                  auto_grow=True, budget_q=q_pad,
                  any_overflow=lambda ov: agree_any(bool(ov.any()), group))
    return res, q


def _gather_rows(t: torch.Tensor, mesh: DeviceMesh, axis: str, q: int):
    """Every rank's part of a per-query tensor, in rank order, as the
    first ``q`` rows of the whole batch."""
    g = all_gather(t, mesh, axis)
    return g.reshape(-1, *t.shape[1:])[:q]


def search_sharded(
    index: BSPIndex,
    queries,
    radius: float,
    mesh: DeviceMesh,
    *,
    axis: str = "data",
    max_leaves: Optional[int] = None,
) -> SearchResult:
    """``search`` with the query batch split over ``mesh[axis]``; a
    collective. Every rank returns the whole batch's result."""
    res, q = _search_part(index, queries, radius, mesh, axis, max_leaves)
    return SearchResult(**{
        f: _gather_rows(getattr(res, f), mesh, axis, q)
        for f in ("rows", "sq_dists", "count", "candidates", "cand_rows",
                  "overflow")})


def knn_sharded(
    index: BSPIndex,
    queries,
    k: int,
    radius: float,
    mesh: DeviceMesh,
    *,
    axis: str = "data",
    max_leaves: Optional[int] = None,
):
    """``knn`` with the query batch split over ``mesh[axis]``; a
    collective. Every rank returns ``(rows [Q, k], sq_dists [Q, k])`` of
    the whole batch."""
    res, q = _search_part(index, queries, radius, mesh, axis, max_leaves)
    rows, d2 = _knn_select(index, res, k, None)
    return (_gather_rows(rows, mesh, axis, q),
            _gather_rows(d2, mesh, axis, q))
