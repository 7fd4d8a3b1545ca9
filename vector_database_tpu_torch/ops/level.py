"""One level of the host-loop BSP build (port of
``vector_database_tpu/ops/level.py``).

One call computes, for every live segment of a level, the count, the
per-dimension sums and sums of squares and the exact mean row id, picks
the split dimension (argmax / argmin of the variance by level parity,
the first dimension on ties), and assigns every row to a child:
``value > mid``, with ``id > mean_id`` deciding rows on the plane, and a
pure id partition where the split dimension has zero variance or where
the plane would leave a child empty. Rows stay where they are: retired
rows keep ``seg == -1``, and ``builder.build_index`` sorts them leaf-major
once, at the end.

Differences from the JAX function, none of which changes a tree on
integer-valued data:

- segment statistics come in an order fixed by the shapes alone: the rows
  are stably sorted by segment, and each total is a difference of a
  float64 ``sorted_build.prefix_sum`` at the segment's ends (JAX:
  ``segment_sum``, a scatter-add; on the card a float scatter-add sums in
  an order that changes from run to run). The totals are rounded to
  float32 before JAX's float32 moment formula, so on integer-valued data
  they are JAX's bit for bit; on float data they are closer to the exact
  sums than a float32 scatter-add and may differ from JAX's in the last
  bits;
- the id sums are exact int64 sums, where JAX sums int32 limbs
  (``_exact_mean_id``): the same quotient. The caller keeps JAX's bound of
  2^30 - 1 rows (``sorted_build.check_mean_id_rows``);
- ``use_max`` and ``node_base`` are host values, and the function is not
  compiled (``level_step`` is the same function, by the JAX name).

**Mesh forms** (``mesh=``, the JAX function under ``shard_map``): with
``axis_name``, every rank of ``mesh[axis_name]`` passes its own block of
rows (global ``row_ids``), which may be short or empty; counts, sums,
sums of squares, id sums and the high counts of the zero-progress guard
are all-reduced over that axis (float64 sums, rounded after the reduce),
so every rank sees the global statistics and the partition stays local.
With ``dim_axis_name`` as well, each rank holds only its ``d / P``
columns: the per-rank best variance is max- (or min-) reduced over that
axis, the lowest global dimension holding it wins (a min-reduce), and
``mid``, the variance at the split and each row's split value are
sum-reduced from the owning rank. Every collective runs on every rank, in
the same order, with shapes every rank shares.
"""

from __future__ import annotations

import torch

from vector_database_tpu_torch.ops.sorted_build import prefix_sum

# dimensions per float64 prefix pass: bounds its [chunk, N] transients
_D_CHUNK = 32
# the dim_axis candidate of a rank that does not hold the best variance
_NO_DIM = 2 ** 31 - 1


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, (int(x) - 1).bit_length())


def _segment_totals(values, starts, ends):
    """Per-segment totals of ``values`` (sorted segment-contiguous, along
    the last dim, possibly empty) over ``[starts[s], ends[s])``, from one
    prefix sum of the values after a leading zero: float64 through
    ``prefix_sum`` (an order of additions fixed by the shape), integers
    through ``torch.cumsum`` (exact in any order)."""
    values = torch.nn.functional.pad(values, (1, 0))
    if values.is_floating_point():
        pre = prefix_sum(values)
    else:
        pre = torch.cumsum(values, dim=-1)
    return pre[..., ends] - pre[..., starts]


def level_math(
    vectors: torch.Tensor,  # [N, D] float32 (a rank's block under a mesh)
    row_ids: torch.Tensor,  # [N] int (global row ordinals: tie-breaks)
    seg: torch.Tensor,  # [N] int; dense segment at this level, -1 = retired
    leaf_of_point: torch.Tensor,  # [N] int; leaf node id, -1 = not yet
    use_max: bool,  # split on the max-variance dim (else min)
    node_base: int,  # node id of segment 0 at this level
    *,
    num_segments: int,
    leaf_size: int,
    mesh=None,
    axis_name: str | None = None,
    dim_axis_name: str | None = None,
):
    """Split statistics of every segment and the next level's assignment.

    Returns the JAX function's dict: per-segment ``cnt``, ``split_dim``,
    ``mid``, ``mean_id``, ``degenerate``, ``dual`` (the first
    ``num_segments`` entries; the caller slices to the live count),
    ``num_internal``, and per row ``new_seg`` and ``new_leaf``. Integer
    outputs are int32, as in JAX. ``mesh``/``axis_name``/``dim_axis_name``:
    see the module docstring; every rank of the mesh calls with the same
    ``num_segments``, ``use_max`` and ``node_base``."""
    S = num_segments
    n, d = vectors.shape
    dev = vectors.device
    i64 = torch.int64
    if axis_name is None:
        allsum = lambda x: x  # noqa: E731
    else:
        from vector_database_tpu_torch.parallel.mesh import psum

        allsum = lambda x: psum(x, mesh, axis_name)  # noqa: E731

    row_ids = row_ids.to(i64)
    active = seg >= 0
    segidx = torch.where(active, seg, 0).to(i64)

    # rows sorted by segment, retired rows last: each segment is one run
    # [starts[s], ends[s]) of the order
    key = torch.where(active, segidx, S)
    order = torch.argsort(key, stable=True)
    bounds = torch.searchsorted(key[order],
                                torch.arange(S + 1, device=dev, dtype=i64))
    starts, ends = bounds[:-1], bounds[1:]

    def seg_total(sorted_values):  # [..., N] in sorted order -> [..., S]
        return allsum(_segment_totals(sorted_values, starts, ends))

    # --- segmented moments: float64 totals, rounded to float32 after the
    # all-reduce, then JAX's float32 formula
    cnt = allsum(ends - starts)
    xs = vectors[order]
    sums = torch.empty((S, d), dtype=torch.float64, device=dev)
    sumsq = torch.empty_like(sums)
    for c0 in range(0, d, _D_CHUNK):
        xc = xs[:, c0:c0 + _D_CHUNK].T.double()
        sums[:, c0:c0 + _D_CHUNK] = seg_total(xc).T
        sumsq[:, c0:c0 + _D_CHUNK] = seg_total(xc.square_()).T
        del xc
    del xs
    sums, sumsq = sums.float(), sumsq.float()
    cnt_f = torch.clamp(cnt, min=1).to(torch.float32)
    mean = sums / cnt_f[:, None]
    # XLA evaluates ``sumsq - (cnt * mean) * mean`` as one fused
    # multiply-subtract: the float64 product of two float32 values is
    # exact, so this rounds once, as XLA does
    cm = (cnt_f[:, None] * mean).double()
    m2 = torch.clamp((sumsq.double() - cm * mean.double()).float(), min=0.0)

    # --- exact mean id (the tie-break on the plane): int64 id sums
    # (retired rows sort past every segment's run: no mask needed)
    mean_id = torch.div(seg_total(row_ids[order]), torch.clamp(cnt, min=1),
                        rounding_mode="floor")

    # --- split dimension: first occurrence on ties
    split_local = torch.argmax(m2, dim=1) if use_max \
        else torch.argmin(m2, dim=1)
    if dim_axis_name is None:
        split_dim = split_local
        mid = mean.gather(1, split_local[:, None])[:, 0]
        m2_at = m2.gather(1, split_local[:, None])[:, 0]
        value = vectors.gather(1, split_dim[segidx][:, None])[:, 0]
    else:
        from vector_database_tpu_torch.parallel.mesh import axis_rank, psum

        # the per-rank best variance compared across the column shards
        # ([S]-sized collectives), the lowest global dimension holding it
        # wins, and its owner sends the plane and every row's value
        offset = axis_rank(mesh, dim_axis_name) * d
        lval = m2.gather(1, split_local[:, None])[:, 0]
        best = psum(lval, mesh, dim_axis_name, "max" if use_max else "min")
        cand = torch.where(lval == best, split_local + offset, _NO_DIM)
        split_dim = psum(cand, mesh, dim_axis_name, "min")
        mine = (split_dim >= offset) & (split_dim < offset + d)
        col = torch.clamp(split_dim - offset, 0, d - 1)[:, None]
        mid = psum(torch.where(mine, mean.gather(1, col)[:, 0], 0.0), mesh,
                   dim_axis_name)
        m2_at = psum(torch.where(mine, m2.gather(1, col)[:, 0], 0.0), mesh,
                     dim_axis_name)
        v_local = vectors.gather(1, col[segidx])[:, 0]
        value = psum(torch.where(mine[segidx], v_local, 0.0), mesh,
                     dim_axis_name)

    degenerate = m2_at == 0.0  # zero variance on the split dim -> id split
    is_internal = cnt > leaf_size

    # --- per-row branch
    p_mid = mid[segidx]
    by_id = row_ids > mean_id[segidx]
    go_high = torch.where(degenerate[segidx], by_id,
                          (value > p_mid) | ((value == p_mid) & by_id))
    # zero-progress guard: a plane that leaves a child empty falls back to
    # the id partition, so the build always terminates
    hi_cnt = seg_total(go_high[order].to(i64))
    stuck = is_internal & ((hi_cnt == 0) | (hi_cnt == cnt))
    go_high = torch.where(stuck[segidx], by_id, go_high)

    # --- dense child numbering: the r-th internal segment's children are
    # segments 2r (low) and 2r+1 (high)
    is_int_i = is_internal.to(i64)
    internal_rank = torch.cumsum(is_int_i, dim=0) - is_int_i
    p_internal = active & is_internal[segidx]
    new_seg = torch.where(p_internal,
                          2 * internal_rank[segidx] + go_high.to(i64), -1)
    became_leaf = active & ~is_internal[segidx]
    new_leaf = torch.where(became_leaf, node_base + segidx,
                           leaf_of_point.to(i64))

    i32 = torch.int32
    return {
        "cnt": cnt.to(i32),
        "split_dim": split_dim.to(i32),
        "mid": mid,
        "mean_id": mean_id.to(i32),
        "degenerate": degenerate,
        # no plane separates an id-partitioned node's children: stored as
        # dim -2, the search descends both
        "dual": degenerate | stuck,
        "num_internal": is_int_i.sum().to(i32),
        "new_seg": new_seg.to(i32),
        "new_leaf": new_leaf.to(i32),
    }


# the JAX package's jitted name for the same function
level_step = level_math
