"""Sorted-segment fused build (port of
``vector_database_tpu/ops/sorted_build.py``).

One invariant carries the build: **row positions are segment-contiguous
at every level.** Per-segment sums and sums of squares are sums over each
segment's positions (``segment_moments``); retired (leaf) ranges stop
being referenced and keep their positions, so the final layout is
leaf-major with no finalize sort; the per-level stable partition moves
positions only within their parent range, with destinations from one
running count of lows.

The rows themselves stay where they are: a position holds a row index
into ``vectors`` (``prow``), and each level moves that index, not the
rows. Phase 1 reads the sampled rows through it, phase 2 one column of
each row; one gather after the last level writes the leaf-major
matrix.

Differences from the JAX program, none of which changes a result:

- the level loop is a host ``while`` over levels with one ``.item()``
  sync per level (the live segment count), so per-segment arrays are
  sized to the live count instead of a static capacity and each level's
  node block is appended rather than window-written;
- the card scatters cheaply, so each level's permutation is applied by
  scattering the row index and the segment ids to their destinations
  where the TPU program sorted (``lax.sort_key_val``) and moved the rows,
  and the optimization barriers that sequenced the TPU's prefix
  transients are gone;
- the split value is a column gather, where the TPU program summed a
  one-hot mask (the same value for finite rows);
- every float prefix sum goes through ``prefix_sum``, whose order of
  additions depends on the shape alone, so one input gives one tree on
  every run; its two-level order rounds differently from XLA's, so on
  float data a plane may differ from the JAX build's in its last ulp;
- on the card the segment moments that rank the split dimensions come
  from a kernel (``segment_moments``) that sums each segment's sampled
  rows directly, in an order fixed by the shape, ``k`` and the segment
  bounds, where the JAX build (and the port on the CPU) differences two
  prefix sums over every sample before the segment's end. That rounds
  at the segment's own scale rather than the prefixes', so on float data
  a split dimension may differ from the JAX build's where two variances
  nearly tie; on integer-valued data every sum is exact and the trees
  are equal bit for bit.

Ties: ``tie_break="positional"`` halves rows on the plane (and whole
zero-variance segments) by rank inside the segment. ``"mean_id"`` is the
reference rule: plane ties go high when ``id > floor(sum_ids / count)``,
and zero-variance segments split by that rule alone (rows move). The
segment id sums are one int64 prefix sum, where the TPU program summed
int32 limbs (``_exact_mean_id``); the quotient is the same exact integer.

**Sharded form** (``group=``, the JAX program's ``axis_name``): every rank
of a ``torch.distributed`` process group runs the same level loop on its
own row shard, and each segment owns one contiguous run on every rank.
Per level the ranks all-reduce the segment counts, the boundary moments,
the subsampled counts, the split plane's numerator, the low counts behind
the zero-progress guard and, under ``mean_id``, the segment id sums; one
all-gather of the ``[S]`` counts gives each rank the global rank of its
first row in every segment, for positional ties. Rows never leave their
rank (a rank's row index points into its own shard). Node tables come
out identical on every rank, leaf runs local. The
one host sync per level reads the all-reduced counts, so every rank runs
the same levels and the same collectives in the same order. With one
rank every collective returns its input's bits: the tree is the
single-device tree.
"""

from __future__ import annotations

import ctypes

import torch

from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.ops.collectives import (
    all_reduce,
    exclusive_prefix,
)
from vector_database_tpu_torch.utils.profiling import COUNTERS, span

# dimensions per prefix-scan pass: bounds the [chunk, N/k] transients
_D_CHUNK = 128
# elements one row of ``prefix_sum`` scans
_SCAN_ROW = 1024


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` along its last dimension, in an order
    of additions fixed by the shape alone: the same input gives the same
    bits on every run, on the card as on the CPU.

    ``torch.cumsum`` scans a tensor with more than one row along its last
    dimension row by row, each row in one thread block in a fixed order
    (serially on the CPU). A tensor whose scanned dimension is its only
    non-unit one goes instead to CUB's single-pass scan on the card, whose
    look-back adds tile sums in an order set by timing, so float sums
    differ in their last bits from run to run. Here a row longer than
    ``_SCAN_ROW`` is cut into rows of that length (the last one
    zero-padded) that are scanned at once, their totals are scanned the
    same way, recursively, and each row adds the totals before it; a lone
    short row is scanned beside a row of zeros. Every ``torch.cumsum``
    call thus sees more than one row."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    if n <= _SCAN_ROW:
        rows = x.reshape(-1, n)
        if rows.shape[0] > 1:
            return torch.cumsum(rows, dim=1).reshape(x.shape)
        two = torch.cat([rows, torch.zeros_like(rows)])
        return torch.cumsum(two, dim=1)[:1].reshape(x.shape)
    tiles = -(-n // _SCAN_ROW)
    xp = torch.nn.functional.pad(x, (0, tiles * _SCAN_ROW - n))
    local = torch.cumsum(xp.reshape(*lead, tiles, _SCAN_ROW), dim=-1)
    carry = prefix_sum(local[..., -1])  # inclusive row totals
    local[..., 1:, :] += carry[..., :-1, None]
    return local.reshape(*lead, tiles * _SCAN_ROW)[..., :n]


def _at(prefix, idx):
    """Exclusive prefix ``prefix[..., idx - 1]`` (0 at idx == 0)."""
    v = prefix[..., torch.clamp(idx - 1, 0, prefix.shape[-1] - 1)]
    return torch.where(idx > 0, v, torch.zeros((), dtype=v.dtype,
                                               device=v.device))


def segment_moments_reference(x, seg_start, seg_cnt, k, rows=None):
    """Plain version of ``segment_moments``: prefix sums of the transposed
    samples, ``_D_CHUNK`` dimensions a pass, differenced at the segment
    bounds. Each sum is the difference of two prefixes over every sample
    before it, so it rounds at the scale of those prefixes."""
    d = x.shape[1]
    xs = x[::k] if rows is None else x[rows[::k]]
    # samples before idx
    n_before = lambda idx: (idx + (k - 1)) // k  # noqa: E731
    s_lo, s_hi = n_before(seg_start), n_before(seg_start + seg_cnt)
    sums_c, sumsq_c = [], []
    for c0 in range(0, d, _D_CHUNK):
        # scan along the last dim: [chunk, ns] rows scan in parallel
        xc = xs[:, c0 : c0 + _D_CHUNK].T
        pre = prefix_sum(xc)
        sums_c.append(_at(pre, s_hi) - _at(pre, s_lo))
        pre = prefix_sum(xc * xc)
        sumsq_c.append(_at(pre, s_hi) - _at(pre, s_lo))
        del pre, xc
    return torch.cat(sums_c, dim=0).T, torch.cat(sumsq_c, dim=0).T


def _declare(lib):
    lib.segment_moments_tile_samples.argtypes = []
    lib.segment_moments_tile_samples.restype = ctypes.c_int
    lib.segment_moments_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.segment_moments_launch.restype = ctypes.c_int


def _load():
    return cuda_build.load("segment_moments", _declare)


def segment_moments(x, seg_start, seg_cnt, k, rows=None):
    """Per-segment sums and sums of squares of the sampled rows:
    ``(sums, sumsq)``, each ``[S, D]`` f32, over the rows ``x[::k]`` holds
    in each segment's rows ``[seg_start[s], seg_start[s] + seg_cnt[s])``,
    zeros where a segment holds none. Segments ascend and do not overlap
    (``seg_start[s] + seg_cnt[s] <= seg_start[s + 1]``), as the build keeps
    them. ``rows``, an optional ``[M]`` int64 row index into ``x``, puts
    position ``i`` at row ``rows[i]``: the result is that on ``x[rows]``,
    bit for bit, without the copy (the samples are ``x[rows[::k]]``).

    On a CUDA tensor this launches ``csrc/segment_moments.cu`` (built with
    ``nvcc`` at first use), or raises: each sampled row of a segment is
    read once and summed in registers in row order, with a fixed order
    across the kernel's tiles, so one input gives the same bits on every
    run; ``COUNTERS["build.moments.launches"]`` counts the launches. On a
    CPU tensor it runs ``segment_moments_reference``."""
    if x.device.type == "cpu":
        return segment_moments_reference(x, seg_start, seg_cnt, k, rows)
    if x.device.type != "cuda":
        raise RuntimeError(f"segment_moments: no kernel for {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("segment_moments: x must be [N, D] float32")
    if x.stride(1) != 1:  # the kernel reads a row's columns side by side
        x = x.contiguous()
    index = [seg_start, seg_cnt] + ([] if rows is None else [rows])
    if any(t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous()
           for t in index) or seg_start.shape != seg_cnt.shape:
        raise ValueError("segment_moments: seg_start, seg_cnt (and rows) "
                         "must be contiguous [S] ([M]) int64")
    if any(t.device != x.device for t in index):
        raise ValueError("segment_moments: inputs must lie on one device")
    if k < 1:
        raise ValueError(f"segment_moments: k must be >= 1, got {k}")
    n, d = x.shape if rows is None else (rows.shape[0], x.shape[1])
    s = seg_start.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    sums, sumsq = torch.empty((s, d), **f32), torch.empty((s, d), **f32)
    if s == 0:
        return sums, sumsq
    lib = _load()
    samples = -(-n // k)
    tiles = max(1, -(-samples // lib.segment_moments_tile_samples()))
    parts = torch.empty((2, tiles, 2 * d), **f32)  # head, tail partials
    tail_seg = torch.empty(tiles, dtype=torch.int32, device=x.device)
    err = lib.segment_moments_launch(
        x.data_ptr(), x.stride(0), None if rows is None else rows.data_ptr(),
        seg_start.data_ptr(), seg_cnt.data_ptr(), s, k, d, n,
        sums.data_ptr(), sumsq.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), tail_seg.data_ptr(), tiles,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"segment_moments launch failed: CUDA error {err}")
    COUNTERS["build.moments.launches"] += 1
    return sums, sumsq


def check_mean_id_rows(n_total: int) -> None:
    """The JAX build keeps ids in int32 and its limb plan
    (``id_limb_plan``) refuses 2^30 rows or more under ``mean_id``; the
    port accepts the same inputs and raises the same error."""
    if n_total << 1 >= 2 ** 31:
        raise ValueError(
            "mean_id tie-break supports at most 2^30 - 1 rows (int32 "
            "ids); use positional ties beyond that"
        )


def segment_capacity(n: int, leaf_size: int) -> int:
    """Bound on live segments in any level: children of internal ranges
    only, and an internal range holds at least ``leaf_size + 1`` points."""
    return max(2, 2 * (n // (leaf_size + 1)))


def sorted_build(
    vectors: torch.Tensor,  # [N, D] float32
    row_ids: torch.Tensor,  # [N] original row of each position
    n_valid: int,  # leading rows that are real (<= N)
    *,
    s_max: int,
    m_max: int,
    leaf_size: int,
    max_levels: int,
    stats_subsample: int = 1,
    tie_break: str = "positional",
    progress_cb=None,
    split: str = "alternate",
    group=None,
):
    """Run the level-synchronous build.

    Returns ``(dim, mid, low, high, leaf_start, leaf_count, perm_rows,
    sorted_vectors, total_nodes, depth)``: node arrays of ``total_nodes``
    entries, ``sorted_vectors`` in leaf-major order and ``perm_rows[i]``
    the original row stored at position ``i``. ``s_max`` and ``m_max``
    bound the live segments and nodes (checked, not used for sizing).

    ``group``: a process group whose ranks each pass their own row shard
    (``n_valid`` real rows, global ``row_ids``); ``s_max``, ``m_max`` and
    ``max_levels`` then bound the global tree. Node arrays come out
    identical on every rank; ``leaf_start``/``leaf_count``, the rows and
    ``perm_rows`` are this rank's.
    """
    mean_id_ties = tie_break == "mean_id"
    if group is None:
        psum = lambda x: x  # noqa: E731
    else:
        psum = lambda x: all_reduce(x, group)  # noqa: E731
    n, d = vectors.shape
    dev = vectors.device
    i64 = dict(dtype=torch.int64, device=dev)
    pos = torch.arange(n, **i64)

    # the rows stay in place, row-contiguous for the moments kernel; each
    # position holds the row it stands for
    vectors = vectors.contiguous()
    ids = row_ids.to(torch.int64)
    prow = pos.clone()
    pseg = torch.where(pos < n_valid, 0, -1)
    seg_start = torch.zeros(1, **i64)
    seg_cnt = torch.full((1,), n_valid, **i64)
    blocks = []  # per level: (dim, mid, low, high, leaf_start, leaf_count)
    node_base, s_live, use_max, level = 0, 1, True, 0

    while s_live > 0 and level < max_levels:
        with span("vdb_torch.build.level"):
            if s_live > s_max or node_base + s_live > m_max:
                raise RuntimeError("segment capacity exceeded")
            active = pseg >= 0
            ps = torch.where(active, pseg, 0)
            ends = seg_start + seg_cnt
            g_cnt = psum(seg_cnt)  # global per-segment count
            if progress_cb is not None:
                progress_cb(level, s_live, int(g_cnt.sum()))

            with span("vdb_torch.build.moments"):
                # --- phase 1: split dimension from (optionally
                # subsampled) segment moments. Subsampling (every k-th
                # row) only ranks dimensions; the plane itself is exact.
                k = stats_subsample
                # samples before idx
                n_before = lambda idx: (idx + (k - 1)) // k
                s_lo, s_hi = n_before(seg_start), n_before(ends)
                sums, sumsq = segment_moments(vectors, seg_start, seg_cnt,
                                              k, prow)
                sums, sumsq = psum(sums), psum(sumsq)  # [S, D]

                cnt_f = torch.clamp(g_cnt, min=1).to(torch.float32)
                cnt_sub = psum(s_hi - s_lo)
                cnt_sub_f = torch.clamp(cnt_sub, min=1).to(torch.float32)
                mean_sub = sums / cnt_sub_f[:, None]
                # XLA evaluates ``sumsq - (cnt * mean) * mean`` as one
                # fused multiply-subtract (a single rounding); the f64
                # product of two f32 values is exact, so this rounds the
                # same way and dimension ranking ties break as in the JAX
                # build
                cm = (cnt_sub_f[:, None] * mean_sub).double()
                m2 = torch.clamp(
                    (sumsq.double() - cm * mean_sub.double()).float(),
                    min=0.0,
                )

                # alternating max/min variance by level parity; first on
                # ties
                split_dim = (torch.argmax(m2, dim=1) if use_max
                             else torch.argmin(m2, dim=1))
                degenerate = (
                    m2.gather(1, split_dim[:, None])[:, 0] == 0.0
                ) | (cnt_sub == 0)
                is_int = (g_cnt > leaf_size) & (level < max_levels - 1)
                # global rank of this shard's first row in each segment
                ex_cnt = (None if group is None
                          else exclusive_prefix(seg_cnt, group))

            with span("vdb_torch.build.plane"):
                p_dim = split_dim[ps]
                p_start = seg_start[ps]
                p_gcnt = g_cnt[ps]
                if mean_id_ties:
                    # floor(sum_ids / count) per segment from one int64
                    # prefix sum of the active rows' ids (exact: sums stay
                    # below 2^60)
                    pid = ids[prow]
                    ic = torch.cumsum(torch.where(active, pid, 0), dim=0)
                    mean_id = torch.div(
                        psum(_at(ic, ends) - _at(ic, seg_start)),
                        torch.clamp(g_cnt, min=1), rounding_mode="floor")

                # --- phase 2: per-row split value and the exact split
                # plane (one [N] prefix sum of the chosen column)
                value = vectors[prow, p_dim]
                vc = prefix_sum(torch.where(active, value, 0.0))
                mid = psum(_at(vc, ends) - _at(vc, seg_start)) / cnt_f
                p_mid = mid[ps]

                local_rank = pos - p_start
                if mean_id_ties:
                    tie_high = pid > mean_id[ps]
                else:
                    # positional ties: lows get the first ceil(cnt/2)
                    # ranks of the segment, counted over every shard
                    g_rank = (local_rank if ex_cnt is None
                              else local_rank + ex_cnt[ps])
                    tie_high = 2 * g_rank >= p_gcnt + (p_gcnt & 1)
                normal_high = (value > p_mid) | (
                    (value == p_mid) & tie_high)

                is_low_n = active & ~normal_high
                cl = torch.cumsum(is_low_n.to(torch.int64), dim=0)
                cl_lo = _at(cl, seg_start)
                lo_cnt = _at(cl, ends) - cl_lo
                # zero-progress guard (fp edge: every row on one side) ->
                # forced tie partition, like a degenerate segment
                g_lo = psum(lo_cnt)
                stuck = is_int & ((g_lo == 0) | (g_lo == g_cnt))
                degen_split = degenerate | stuck
                if mean_id_ties:
                    # tie-partitioned segments split purely by id: recount
                    # lows
                    cli = torch.cumsum((active & ~tie_high).to(torch.int64),
                                       dim=0)
                    cli_lo = _at(cli, seg_start)
                    lo_cnt = torch.where(degen_split,
                                         _at(cli, ends) - cli_lo, lo_cnt)
                else:
                    # a rank split moves no rows: this shard's lows are its
                    # part of the segment's first ceil(cnt/2) global ranks
                    half = (g_cnt + 1) // 2
                    if ex_cnt is not None:
                        half = torch.minimum(
                            torch.clamp(half - ex_cnt, min=0), seg_cnt)
                    lo_cnt = torch.where(degen_split, half, lo_cnt)

            # --- child numbering and boundaries
            ii = is_int.to(torch.int64)
            rank = torch.cumsum(ii, dim=0) - ii
            with span("vdb_torch.build.sync"):
                num_internal = int(ii.sum())  # the level's one host sync
            with span("vdb_torch.build.partition"):
                next_base = node_base + s_live
                # children of internal segment r land at 2r, 2r+1; leaves
                # write into a dropped slot past the end
                tgt = torch.where(is_int, 2 * rank, 2 * num_internal)
                new_start = torch.zeros(2 * num_internal + 2, **i64)
                new_cnt = torch.zeros(2 * num_internal + 2, **i64)
                new_start[tgt] = seg_start
                new_start[tgt + 1] = seg_start + lo_cnt
                new_cnt[tgt] = lo_cnt
                new_cnt[tgt + 1] = seg_cnt - lo_cnt
                new_start = new_start[: 2 * num_internal]
                new_cnt = new_cnt[: 2 * num_internal]

                # --- this level's node block. Tie-partitioned nodes store
                # dim -2: no plane separates their children, the search
                # descends both.
                node_dim = torch.where(degen_split, -2, split_dim)
                blocks.append((
                    torch.where(is_int, node_dim, -1),
                    torch.where(is_int & ~degen_split, mid, 0.0),
                    torch.where(is_int, next_base + 2 * rank, -1),
                    torch.where(is_int, next_base + 2 * rank + 1, -1),
                    # leaves record their (start, count): rows never move
                    # again
                    torch.where(is_int, 0, seg_start),
                    torch.where(is_int, 0, seg_cnt),
                ))

                # --- phase 3: stable within-range partition (rank splits
                # move no rows; id splits move rows like plane splits)
                p_locnt = lo_cnt[ps]
                p_degen = degen_split[ps]
                p_is_int = is_int[ps]
                p_rank = rank[ps]
                go_high = torch.where(p_degen, tie_high, normal_high)
                lows_upto = cl - cl_lo[ps]  # inclusive lows in [start, i]
                if mean_id_ties:
                    moving = active & p_is_int
                    lows_upto = torch.where(p_degen, cli - cli_lo[ps],
                                            lows_upto)
                else:
                    moving = active & p_is_int & ~p_degen
                dest_low = p_start + lows_upto - 1
                dest_high = p_start + p_locnt + local_rank - lows_upto
                dest = torch.where(
                    moving, torch.where(go_high, dest_high, dest_low), pos)
                new_seg = torch.where(
                    active & p_is_int, 2 * p_rank + go_high.to(torch.int64),
                    -1)
                # dest is a permutation: each position's row index and
                # segment go to their destination, the rows stay put
                moved_row, moved_seg = (torch.empty_like(pos),
                                        torch.empty_like(pos))
                moved_row[dest] = prow
                moved_seg[dest] = new_seg
                prow, pseg = moved_row, moved_seg
                seg_start, seg_cnt = new_start, new_cnt

            node_base = next_base
            s_live = 2 * num_internal
            # "alternate": the reference's max/min parity rule; "max":
            # max-variance every level
            use_max = use_max if split == "max" else not use_max
            level += 1

    if s_live > 0:
        # depth-cap exit: still-live segments retire as oversized leaves
        blocks.append((
            torch.full((s_live,), -1, **i64),
            torch.zeros(s_live, dtype=torch.float32, device=dev),
            torch.full((s_live,), -1, **i64),
            torch.full((s_live,), -1, **i64),
            seg_start,
            seg_cnt,
        ))
    with span("vdb_torch.build.partition"):
        # the build's one row gather: the leaf-major matrix
        sorted_vectors = vectors[prow]
    nd, nm, nl, nh, nls, nlc = (torch.cat(col) for col in zip(*blocks))
    i32 = torch.int32
    return (nd.to(i32), nm, nl.to(i32), nh.to(i32), nls.to(i32),
            nlc.to(i32), ids[prow].to(i32), sorted_vectors,
            node_base + s_live, level)
