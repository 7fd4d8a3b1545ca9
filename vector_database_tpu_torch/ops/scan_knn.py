"""Streaming exact k-NN: a blocked scan with a running top-k (port of
``vector_database_tpu/ops/scan_knn.py``).

The database axis is cut into ``block``-row blocks; each block's
``[Q, block]`` scores ``|v|^2 - 2 q.v`` are reduced to a small shortlist
and merged into a running ``[Q, k_scan]`` top-k, so the ``[Q, N]`` distance
matrix never materializes. The JAX package runs this as plain XLA (no
Pallas kernel), so the port is torch ops.

Two modes:

- ``precise=True``: f32 products (TF32 off) and an exact per-block top-k;
- ``precise=False`` (default): inputs rounded to bf16, products summed in
  f32 (as XLA's ``preferred_element_type=float32``), each block reduced
  to ``buckets`` candidates by a bucket minimum (bucket = column mod
  ``buckets``, interleaved so a similarity-sorted layout does not put a
  query's neighbours in one bucket), then an exact f32 rerank of the
  ``oversample * k`` shortlist.

Every selection keeps the lower index on equal scores, as ``lax.top_k``
does.
"""

from __future__ import annotations

import torch

from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d, full_f32


def _lowest_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` smallest entries of each row,
    ascending, equal values in index order, and on a tie at the k-th
    place the lower indices win: exactly ``lax.top_k(-x, k)``. ``x`` holds
    no NaN."""
    q, n = x.shape
    if k >= n:
        vals, idx = torch.sort(x, dim=1, stable=True)
        return vals, idx
    kth = torch.topk(x, k, dim=1, largest=False).values.amax(
        dim=1, keepdim=True)
    below = x < kth
    tied = x == kth
    need = k - below.sum(dim=1, keepdim=True)
    keep = below | (tied & (torch.cumsum(tied.to(torch.int32), dim=1)
                            <= need))
    # exactly k kept per row; their indices ascending, then a stable sort
    # by value keeps index order among equal values
    pos = torch.arange(n, device=x.device)
    idx = torch.topk(torch.where(keep, pos, n), k, dim=1,
                     largest=False).values.sort(dim=1).values
    vals = x.gather(1, idx)
    o = torch.sort(vals, dim=1, stable=True).indices
    return vals.gather(1, o), idx.gather(1, o)


def scan_knn(
    vectors,  # [N, D] float32 (leaf-major or raw order)
    queries,  # [Q, D] float32
    *,
    k: int,
    block: int = 65536,
    precise: bool = False,
    oversample: int = 4,
    buckets: int = 256,
    row_mask=None,
):
    """k nearest neighbors: ``(rows [Q, k], sq_dists [Q, k])``, -1 / +inf
    padding. Rows index into ``vectors``; the database is padded to a
    multiple of ``block`` internally (padded rows score +inf).

    ``precise=False`` runs the bf16 bucketed scan and an exact f32 rerank
    of its ``oversample * k`` shortlist; ``precise=True`` is exact.
    ``row_mask``: optional ``[N]`` bool; rows where False are excluded
    from the result set. The filter is folded into the norm row, so it
    rides the scan (never a post-filter of an unfiltered top-k); in the
    bucketed mode two allowed rows in one (block, bucket) keep only the
    nearer, so pass ``precise=True`` for highly selective filters.
    """
    vectors = as_f32(vectors)
    queries = atleast_2d(as_f32(queries, vectors.device))
    dev = vectors.device
    n, d = vectors.shape
    q = queries.shape[0]
    k_scan = min(k * oversample, n) if not precise else k
    buckets = min(buckets, block)
    if block % buckets:
        raise ValueError("block must be a multiple of buckets")
    nb = -(-n // block)
    vn = torch.sum(vectors * vectors, dim=1)
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask, device=dev).bool()
        if tuple(row_mask.shape) != (n,):
            raise ValueError(
                f"row_mask must have shape ({n},) matching the database "
                f"rows, got {tuple(row_mask.shape)}"
            )
        # masked rows score +inf in every block: selection never sees them
        vn = torch.where(row_mask, vn, float("inf"))
    # bf16 mode: the inputs round to bf16, the products sum in f32
    qc = queries if precise else queries.to(torch.bfloat16).float()

    inf = float("inf")
    best_d = torch.full((q, k_scan), inf, device=dev)
    best_i = torch.full((q, k_scan), -1, dtype=torch.int64, device=dev)
    width = block // buckets
    off = torch.arange(buckets, device=dev)
    for b in range(nb):
        lo = b * block
        vblk = vectors[lo : lo + block]
        if not precise:
            vblk = vblk.to(torch.bfloat16).float()
        with full_f32():
            cross = qc @ vblk.T
        d2 = vn[lo : lo + block][None, :] - 2.0 * cross
        real = d2.shape[1]
        if real < block:  # the partial last block: padded rows are +inf
            d2 = torch.nn.functional.pad(d2, (0, block - real), value=inf)
        if precise:
            # cap the per-block selection at the block width; the running
            # merge accumulates the rest
            blk_d, pos = _lowest_k(d2, min(k_scan, block))
            blk_rows = torch.where(torch.isfinite(blk_d), lo + pos, -1)
        else:
            d2b = d2.view(q, width, buckets)
            arg = torch.argmin(d2b, dim=1)  # first minimum, as jnp.argmin
            blk_d = d2b.gather(1, arg[:, None, :])[:, 0, :]
            blk_rows = lo + arg * buckets + off[None, :]
            # all-padded buckets must not surface phantom rows >= n
            blk_rows = torch.where(torch.isfinite(blk_d), blk_rows, -1)
        # exact merge of the two small shortlists
        cat_d = torch.cat([best_d, blk_d], dim=1)
        cat_i = torch.cat([best_i, blk_rows], dim=1)
        o = torch.sort(cat_d, dim=1, stable=True).indices[:, :k_scan]
        best_d, best_i = cat_d.gather(1, o), cat_i.gather(1, o)

    def pad_to_k(rows_out, d2_out):
        short = k - rows_out.shape[1]
        if short > 0:  # k > n: -1 / +inf padding
            rows_out = torch.nn.functional.pad(rows_out, (0, short),
                                               value=-1)
            d2_out = torch.nn.functional.pad(d2_out, (0, short), value=inf)
        return rows_out, d2_out

    if precise:
        qn = torch.sum(queries * queries, dim=1, keepdim=True)
        return pad_to_k(best_i, torch.clamp(best_d + qn, min=0.0))

    # f32 rerank of the bf16 shortlist, also when k_scan <= k: its bf16
    # scores would misorder downstream exact merges
    cand = vectors[best_i.clamp(min=0)]  # [Q, k_scan, D]
    diff = cand - queries[:, None, :]
    d2 = torch.where(best_i >= 0, torch.sum(diff * diff, dim=-1), inf)
    out_d2, pos = torch.sort(d2, dim=1, stable=True)
    kk = min(k, k_scan)
    out_d2, pos = out_d2[:, :kk], pos[:, :kk]
    out_rows = best_i.gather(1, pos)
    return pad_to_k(torch.where(torch.isfinite(out_d2), out_rows, -1),
                    out_d2)
