"""The plain check of a built BSP index against the rows it was built
from: what the node table promises, tested row by row.

An index is judged by ``tree_faults``, which counts, over its node table
(``dim``, ``mid``, ``low``, ``high``, ``leaf_start``, ``leaf_count``) and
its ``orig_row``:

- positions of ``orig_row`` that are no row, or rows it lists twice or
  never;
- leaf-major positions not covered by exactly one leaf, and leaves of
  more than ``leaf_size`` rows;
- internal nodes whose children are not two adjacent runs of their range;
- rows on the wrong side of their node's split plane: every row in the
  low child has ``x[dim] <= mid``, every row in the high child
  ``x[dim] >= mid`` (the build's plane rule; rows on the plane go either
  way). Nodes split by rank (``dim == -2``) promise no plane.

The rows are the benchmark's own, laid out by ``orig_row`` here.
"""

from __future__ import annotations

import torch


def tree_faults(rows, tree: dict, leaf_size: int) -> int:
    """The number of broken promises of ``tree`` over ``rows``; 0 for a
    sound index."""
    n = rows.shape[0]
    dev = rows.device
    o = tree["orig_row"].to(device=dev, dtype=torch.int64)
    if o.shape != (n,):
        return n + abs(o.numel() - n)
    ok = (o >= 0) & (o < n)
    seen = torch.zeros(n, dtype=torch.int64, device=dev)
    seen.index_add_(0, o[ok], torch.ones_like(o[ok]))
    faults = int((~ok).sum()) + int((seen != 1).sum())

    dim = tree["dim"].to(device=dev, dtype=torch.int64)
    mid = tree["mid"].to(device=dev, dtype=torch.float32)
    low = tree["low"].to(device=dev, dtype=torch.int64)
    high = tree["high"].to(device=dev, dtype=torch.int64)
    start = tree["leaf_start"].to(device=dev, dtype=torch.int64).clone()
    cnt = tree["leaf_count"].to(device=dev, dtype=torch.int64).clone()
    leaf = low < 0
    faults += int((cnt[leaf] > leaf_size).sum())
    edge = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    one = torch.ones_like(start[leaf])
    edge.index_add_(0, start[leaf].clamp(0, n), one)
    edge.index_add_(0, (start[leaf] + cnt[leaf]).clamp(0, n), -one)
    faults += int((torch.cumsum(edge, 0)[:n] != 1).sum())

    # levels from the root down, then each node's range from the leaves up
    levels, frontier = [], torch.zeros(1, dtype=torch.int64, device=dev)
    while frontier.numel():
        inner = frontier[low[frontier] >= 0]
        if inner.numel():
            levels.append(inner)
        frontier = torch.cat([low[inner], high[inner]])
        if len(levels) > 4096:
            return faults + n  # a cycle: no tree
    for nodes in reversed(levels):
        lo, hi = low[nodes], high[nodes]
        faults += int((start[hi] != start[lo] + cnt[lo]).sum())
        start[nodes] = start[lo]
        cnt[nodes] = cnt[lo] + cnt[hi]
    faults += int((cnt[0] != n) | (start[0] != 0))

    x = rows[o.clamp(0, n - 1)]  # the leaf-major matrix the tree implies
    for nodes in levels:
        nodes = nodes[dim[nodes] >= 0]
        if not nodes.numel():
            continue
        size = cnt[nodes]
        which = torch.repeat_interleave(
            torch.arange(nodes.numel(), device=dev), size)
        first = torch.cumsum(size, 0) - size
        pos = start[nodes][which] + (
            torch.arange(which.numel(), device=dev) - first[which])
        pos = pos.clamp(0, n - 1)
        value = x[pos, dim[nodes][which].clamp(0, rows.shape[1] - 1)]
        plane = mid[nodes][which]
        in_low = pos < (start[nodes] + cnt[low[nodes]])[which]
        wrong = torch.where(in_low, value > plane, value < plane)
        faults += int(wrong.sum())
    return faults
