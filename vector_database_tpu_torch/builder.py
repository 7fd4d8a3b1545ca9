"""Level-synchronous BSP index builder (port of
``vector_database_tpu/builder.py``: the fused build only).

The build is the set-oriented formulation of the reference's
``dbo.BuildIndex``: one pass over the device-resident ``[N, D]`` matrix per
tree level, doing the stats and the partition for every live range at
once (``ops/sorted_build.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.exact import as_f32
from vector_database_tpu_torch.ops.sorted_build import (
    check_mean_id_rows,
    segment_capacity,
    sorted_build,
)


def build_index_fused(
    vectors,
    *,
    leaf_size: int = 1,
    max_levels: Optional[int] = None,
    stats_subsample: Optional[int] = None,
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
    planes stay exact. ``tie_break``: ``"positional"`` halves rows on the
    plane (and zero-variance segments) by rank; ``"mean_id"`` is the
    reference rule ``id > floor(mean(ids))`` with exact id sums, for
    reference tree-shape parity (at most 2^30 - 1 rows, as in the JAX
    package). ``progress``: host callback ``(level, live_segments,
    active_rows)`` once per level.
    ``split``: ``"alternate"`` (the reference's max/min-variance parity
    rule) or ``"max"`` (max variance every level).
    """
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
