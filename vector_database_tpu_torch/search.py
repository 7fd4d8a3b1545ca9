"""Batched lockstep tree search with exact rerank (port of
``vector_database_tpu/search.py``).

The walk is the recursive-CTE formulation of the reference's ``dbo.Search``
run for a whole query batch: a ``[Q, F]`` frontier, one step per tree
level, descending low when ``mid >= q[dim] - radius`` and high when
``mid <= q[dim] + radius`` (possibly both). It returns a candidate
superset of leaves; the rerank computes exact distances over the leaf
buckets and filters. PyTorch has no vmapped ``while_loop``, so the
per-query DFS of the JAX package has no counterpart here: both
``traversal=`` values run the frontier walk, which reaches the same leaf
set. ``locate`` is the exact-match lookup: one root-to-leaf path per
query.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.exact import (
    as_f32,
    atleast_2d,
    exact_knn,
)


@dataclasses.dataclass
class SearchResult:
    """Result of a batched radius search.

    Attributes:
      rows: ``[Q, C]`` matching original input rows, -1 padding.
      sq_dists: ``[Q, C]`` float32 squared distances, +inf at padding.
      count: ``[Q]`` number of matches per query.
      candidates: ``[Q]`` candidates examined per query.
      cand_rows: ``[Q, C]`` every candidate row the walk surfaced, before
        the exact filter (-1 padding).
      overflow: ``[Q]`` bool, leaf buffer overflowed; results for that
        query may be incomplete (retry with larger ``max_leaves``).
    """

    rows: torch.Tensor
    sq_dists: torch.Tensor
    count: torch.Tensor
    candidates: torch.Tensor
    cand_rows: torch.Tensor
    overflow: torch.Tensor

    def match_rows(self, i: int) -> np.ndarray:
        """Matching original rows of query ``i`` as a numpy array."""
        r = self.rows[i].cpu().numpy()
        return r[r >= 0]


def _traverse_bfs(dim, mid, low, high, queries, radius, *, max_leaves,
                  depth):
    """Level-synchronous frontier expansion: ``(leaves [Q, F], count [Q],
    overflow [Q])``. Reached leaves stay in the frontier as terminal
    entries, so the frontier is the leaf buffer when the loop ends;
    entries dropped past width F set the overflow flag."""
    f = max_leaves
    q = queries.shape[0]
    dev = queries.device
    lane = torch.arange(f, device=dev)
    low, high = low.to(torch.int64), high.to(torch.int64)
    node = torch.full((q, f), -1, dtype=torch.int64, device=dev)
    node[:, 0] = 0
    act = torch.zeros((q, f), dtype=torch.bool, device=dev)
    act[:, 0] = True
    ov = torch.zeros(q, dtype=torch.bool, device=dev)
    neg = torch.full((), -1, dtype=torch.int64, device=dev)
    for _ in range(depth + 1):
        nc = node.clamp(min=0)
        nd = torch.where(act, dim[nc].to(torch.int64), -3)  # -3: inactive
        m = mid[nc]
        qd = queries.gather(1, nd.clamp(min=0))
        is_leaf = nd == -1
        internal = act & ~is_leaf
        dual = nd == -2  # no separating plane: descend both
        vis_lo = internal & (dual | (m >= qd - radius))
        vis_hi = internal & (dual | (m <= qd + radius))
        c0 = torch.where(act & is_leaf, node,
                         torch.where(vis_lo, low[nc], neg))
        c1 = torch.where(vis_hi, high[nc], neg)
        cand = torch.cat([c0, c1], dim=1)  # [Q, 2F]
        valid = cand >= 0
        cnt = valid.sum(dim=1)
        # left-compact the valid entries (stable: keeps sibling order)
        order = torch.argsort((~valid).to(torch.uint8), dim=1,
                              stable=True)[:, :f]
        node = cand.gather(1, order)
        act = lane[None, :] < torch.clamp(cnt, max=f)[:, None]
        ov = ov | (cnt > f)
        node = torch.where(act, node, neg)
    return node, act.sum(dim=1), ov


def _rerank(leaf_start, leaf_count, vectors, orig_row, leaves, queries,
            radius, *, leaf_cap):
    """Expand leaf buckets to rows, compute exact distances, filter."""
    valid_leaf = leaves >= 0
    lv = torch.where(valid_leaf, leaves, 0)
    starts = leaf_start[lv].to(torch.int64)
    cnts = torch.where(valid_leaf, leaf_count[lv], 0)
    k = torch.arange(leaf_cap, device=leaves.device)
    rows = starts[:, :, None] + k[None, None, :]  # [Q, L, K]
    rvalid = k[None, None, :] < cnts[:, :, None]
    rows = torch.where(rvalid, rows, 0)
    q = queries.shape[0]
    rows = rows.reshape(q, -1)
    rvalid = rvalid.reshape(q, -1)

    cand = vectors[rows]  # [Q, C, D]
    diff = cand - queries[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    match = rvalid & (d2 <= radius * radius)
    cand_rows = torch.where(rvalid, orig_row[rows].to(torch.int64), -1)
    out_rows = torch.where(match, cand_rows, -1)
    d2 = torch.where(match, d2, float("inf"))
    return out_rows, d2, match, rvalid.sum(dim=1), cand_rows


def search(
    index: BSPIndex,
    queries,
    radius: float,
    *,
    max_leaves: Optional[int] = None,
    auto_grow: bool = True,
    traversal: str = "dfs",
) -> SearchResult:
    """Find all vectors within inclusive L2 ``radius`` of each query.

    Exact (no false negatives, no false positives): the walk never prunes
    a subtree holding an in-radius point, and the rerank filters by true
    distance. ``max_leaves``: per-query leaf-buffer width. ``auto_grow``:
    on overflow, rerun with a doubled buffer (up to a ~2 GB rerank
    budget). ``traversal``: accepted for API parity; ``"dfs"`` and
    ``"bfs"`` both run the frontier walk (see the module docstring).
    """
    if traversal not in ("dfs", "bfs"):
        raise ValueError("traversal must be 'dfs' or 'bfs'")
    queries = atleast_2d(as_f32(queries, index.device))
    return _search(index, queries, radius, max_leaves=max_leaves,
                   auto_grow=auto_grow)


def _search(index: BSPIndex, queries, radius, *, max_leaves, auto_grow,
            budget_q=None, any_overflow=None) -> SearchResult:
    """``search`` on f32 ``queries`` on the index's device. ``budget_q``:
    the batch the rerank budget is sized for (default: ``queries``'s).
    ``any_overflow(ov) -> bool`` decides an auto-grow retry (default:
    ``ov.any()``); ranks that search shards of one batch pass an
    all-reduce, so that all of them retry together and keep one width."""
    radius = torch.tensor(radius, dtype=torch.float32, device=index.device)
    num_leaf_nodes = index.num_leaves
    if max_leaves is None:
        max_leaves = min(256, num_leaf_nodes)
    # the rerank gathers [Q, max_leaves*leaf_cap, D] floats: cap that
    # buffer at ~2 GB so a non-selective query reports an overflow
    # instead of running out of memory
    budget_q = queries.shape[0] if budget_q is None else budget_q
    budget_rows = (2 << 30) // (4 * budget_q * index.d)
    grow_cap = max(
        min(num_leaf_nodes, budget_rows // max(index.leaf_cap, 1)), 1
    )
    max_leaves = min(max_leaves, grow_cap)
    if any_overflow is None:
        any_overflow = lambda ov: bool(ov.any())  # noqa: E731

    while True:
        leaves, _, ov = _traverse_bfs(
            index.dim, index.mid, index.low, index.high, queries, radius,
            max_leaves=max_leaves, depth=index.depth,
        )
        if auto_grow and max_leaves < grow_cap and any_overflow(ov):
            max_leaves = min(max_leaves * 2, grow_cap)
            continue
        break

    rows, d2, match, ncand, cand_rows = _rerank(
        index.leaf_start, index.leaf_count, index.vectors, index.orig_row,
        leaves, queries, radius, leaf_cap=index.leaf_cap,
    )
    return SearchResult(
        rows=rows,
        sq_dists=d2,
        count=match.sum(dim=1),
        candidates=ncand,
        cand_rows=cand_rows,
        overflow=ov,
    )


def _descend(dim, mid, low, high, queries, *, depth, ties_high=False):
    """Single-branch lockstep descent: each query follows one root-to-leaf
    path, ``depth + 1`` steps of ``[Q]``-wide gathers. Returns ``(leaf
    node id, saw_dual)`` per query; ``saw_dual`` marks a path that
    crossed a dim == -2 node, where the single-branch choice is a guess.
    ``ties_high`` routes ``q[dim] == mid`` high (trie exports), else low
    (builder trees)."""
    q = queries.shape[0]
    dev = queries.device
    low, high = low.to(torch.int64), high.to(torch.int64)
    node = torch.zeros(q, dtype=torch.int64, device=dev)
    saw_dual = torch.zeros(q, dtype=torch.bool, device=dev)
    for _ in range(depth + 1):
        d = dim[node].to(torch.int64)
        m = mid[node]
        qd = queries.gather(1, d.clamp(min=0)[:, None])[:, 0]
        go_high = (qd >= m) if ties_high else (qd > m)
        nxt = torch.where(go_high, high[node], low[node])
        # a dual node has no separating plane: take the low child and
        # report the guess, so the caller can fall back to the exact walk
        nxt = torch.where(d == -2, low[node], nxt)
        saw_dual = saw_dual | (d == -2)
        node = torch.where(d == -1, node, nxt)
    return node, saw_dual


def _locate_in_leaf(leaf_start, leaf_count, vectors, orig_row, leaf,
                    queries, *, leaf_cap):
    """The original row of the first vector in ``leaf`` equal to each
    query, or -1."""
    start = leaf_start[leaf].to(torch.int64)
    cnt = leaf_count[leaf]
    k = torch.arange(leaf_cap, device=leaf.device)
    rows = start[:, None] + k[None, :]  # [Q, K]
    valid = k[None, :] < cnt[:, None]
    rows = torch.where(valid, rows, 0)
    eq = torch.all(vectors[rows] == queries[:, None, :], dim=-1) & valid
    first = torch.argmax(eq.to(torch.uint8), dim=1)  # first True
    hit = eq.gather(1, first[:, None])[:, 0]
    found = rows.gather(1, first[:, None])[:, 0]
    return torch.where(hit, orig_row[found].to(torch.int64), -1)


def locate(index: BSPIndex, queries) -> torch.Tensor:
    """Exact-match point lookup: the original row whose vector equals each
    query, or -1 (``[Q]`` int64 on the index's device). One root-to-leaf
    path per query plus an equality check in the reached leaf: the
    ``radius=0`` fast path. A query whose path crossed a dual (dim == -2)
    node and missed is re-run through the exact ``search(q, 0.0)``. On
    builder trees a query coordinate exactly on a traversed plane may
    still miss (the build routed such ties by id); ``split="max"`` trees
    on boolean data and trie exports (``ties_high``) are exact."""
    queries = atleast_2d(as_f32(queries, index.device))
    leaf, saw_dual = _descend(
        index.dim, index.mid, index.low, index.high, queries,
        depth=index.depth, ties_high=index.ties_high,
    )
    rows = _locate_in_leaf(
        index.leaf_start, index.leaf_count, index.vectors, index.orig_row,
        leaf, queries, leaf_cap=index.leaf_cap,
    )
    # a miss below a dual node is inconclusive: exact fallback for those
    miss = torch.nonzero(saw_dual & (rows < 0))[:, 0]
    if miss.numel():
        res = search(index, queries[miss], 0.0)
        # the JAX package's DFS lists matches in leaf-major position
        # order and takes the first; the frontier walk lists them in
        # another order, so take the match at the lowest position
        pos_of = torch.empty(index.n, dtype=torch.int64, device=index.device)
        pos_of[index.orig_row.to(torch.int64)] = torch.arange(
            index.n, device=index.device)
        key = torch.where(res.rows >= 0, pos_of[res.rows.clamp(min=0)],
                          index.n)
        first = torch.argmin(key, dim=1)
        found = res.rows.gather(1, first[:, None])[:, 0]
        rows[miss] = torch.where(key.amin(dim=1) < index.n, found, -1)
    return rows


def calibrate_radius(
    vectors,
    sample_queries,
    k: int,
    quantile: float = 0.95,
    *,
    max_sample: int = 65536,
) -> float:
    """An epsilon for radius-bounded k-NN: the ``quantile`` of the k-th
    neighbor distance over a query sample. The database side is strided
    down to ``max_sample`` rows, which can only overestimate the k-th
    distance (more candidates, never less recall)."""
    vectors = as_f32(vectors)
    n = vectors.shape[0]
    if n > max_sample:
        stride = -(-n // max_sample)
        vectors = vectors[::stride]
    _, d2 = exact_knn(vectors, sample_queries, k=min(k, vectors.shape[0]))
    kth = torch.sqrt(d2[:, -1])
    return float(torch.quantile(kth, quantile))


def knn(
    index: BSPIndex,
    queries,
    k: int,
    radius: Optional[float] = None,
    *,
    max_leaves: Optional[int] = None,
    row_filter=None,
):
    """k nearest neighbors among vectors within ``radius`` of each query:
    ``(rows [Q, k], sq_dists [Q, k])``, -1 / +inf padding when a query has
    fewer than ``k`` in-radius neighbors. ``radius=None`` calibrates it
    from the k-th neighbor distances of a query sample (95th percentile
    plus 10%). ``row_filter``: optional ``[N]`` bool over original rows;
    rows where False are excluded before the top-k.
    """
    queries = atleast_2d(as_f32(queries, index.device))
    if radius is None:
        radius = 1.1 * calibrate_radius(
            index.vectors, queries[: min(64, queries.shape[0])], k, 0.95
        )
    res = search(index, queries, radius, max_leaves=max_leaves)
    return _knn_select(index, res, k, row_filter)


def _knn_select(index: BSPIndex, res: SearchResult, k: int, row_filter):
    """``knn``'s top-k over a radius search's matches, with its overflow
    warning."""
    sq = res.sq_dists
    if row_filter is not None:
        rf = torch.as_tensor(np.asarray(row_filter, bool)
                             if not isinstance(row_filter, torch.Tensor)
                             else row_filter, device=index.device).bool()
        allowed = rf[res.rows.clamp(0, rf.shape[0] - 1)] & (res.rows >= 0)
        sq = torch.where(allowed, sq, float("inf"))
    kk = min(k, sq.shape[1])  # candidate width can be < k
    # stable: equal distances keep candidate order, as lax.top_k does
    d2, pos = torch.sort(sq, dim=1, stable=True)
    d2, pos = d2[:, :kk], pos[:, :kk]
    rows = res.rows.gather(1, pos)
    rows = torch.where(torch.isfinite(d2), rows, -1)
    if k > kk:
        rows = torch.nn.functional.pad(rows, (0, k - kk), value=-1)
        d2 = torch.nn.functional.pad(d2, (0, k - kk), value=float("inf"))
    if bool(res.overflow.any()):
        warnings.warn(
            "knn: the leaf buffer overflowed at its growth cap for "
            f"{int(res.overflow.sum())} queries; their candidate sets are "
            "truncated (results may miss neighbors). Use the packed scan "
            "for non-selective high-dimensional queries.",
            RuntimeWarning,
            stacklevel=3,
        )
    return rows, d2
