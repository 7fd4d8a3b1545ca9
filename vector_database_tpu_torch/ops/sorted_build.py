"""Sorted-segment fused build (port of
``vector_database_tpu/ops/sorted_build.py``).

One invariant carries the build: **rows are stored segment-contiguous at
every level.** Per-segment sums and sums of squares are prefix-sum
differences at segment boundaries; retired (leaf) ranges stop being
referenced and keep their position, so the final layout is leaf-major
with no finalize sort; the per-level stable partition moves rows only
within their parent range, with destinations from one running count of
lows.

Differences from the JAX program, none of which changes a result:

- the level loop is a host ``while`` over levels with one ``.item()``
  sync per level (the live segment count), so per-segment arrays are
  sized to the live count instead of a static capacity and each level's
  node block is appended rather than window-written;
- the card scatters cheaply, so the permutation is inverted with one
  scatter ``src[dest] = pos`` where the TPU program sorted
  (``lax.sort_key_val``), and the optimization barriers that sequenced
  the TPU's prefix transients are gone;
- the split value is a column gather, where the TPU program summed a
  one-hot mask (the same value for finite rows);
- every float prefix sum goes through ``prefix_sum``, whose order of
  additions depends on the shape alone, so one input gives one tree on
  every run; its two-level order rounds differently from XLA's, so on
  float data a plane may differ from the JAX build's in its last ulp.

Ties: ``tie_break="positional"`` halves rows on the plane (and whole
zero-variance segments) by rank inside the segment. ``"mean_id"`` is the
reference rule: plane ties go high when ``id > floor(sum_ids / count)``,
and zero-variance segments split by that rule alone (rows move). The
segment id sums are one int64 prefix sum, where the TPU program summed
int32 limbs (``_exact_mean_id``); the quotient is the same exact integer.
"""

from __future__ import annotations

import torch

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
):
    """Run the level-synchronous build.

    Returns ``(dim, mid, low, high, leaf_start, leaf_count, perm_rows,
    sorted_vectors, total_nodes, depth)``: node arrays of ``total_nodes``
    entries, ``sorted_vectors`` in leaf-major order and ``perm_rows[i]``
    the original row stored at position ``i``. ``s_max`` and ``m_max``
    bound the live segments and nodes (checked, not used for sizing).
    """
    mean_id_ties = tie_break == "mean_id"
    n, d = vectors.shape
    dev = vectors.device
    i64 = dict(dtype=torch.int64, device=dev)
    pos = torch.arange(n, **i64)

    pvec = vectors
    pid = row_ids.to(torch.int64)
    pseg = torch.where(pos < n_valid, 0, -1)
    pleaf = torch.full((n,), -1, **i64)
    seg_start = torch.zeros(1, **i64)
    seg_cnt = torch.full((1,), n_valid, **i64)
    blocks = []  # per level: (dim, mid, low, high, leaf_start, leaf_count)
    node_base, s_live, use_max, level = 0, 1, True, 0

    def at(prefix, idx):
        """Exclusive prefix ``prefix[..., idx - 1]`` (0 at idx == 0)."""
        v = prefix[..., torch.clamp(idx - 1, 0, prefix.shape[-1] - 1)]
        return torch.where(idx > 0, v, torch.zeros((), dtype=v.dtype,
                                                   device=dev))

    while s_live > 0 and level < max_levels:
        if s_live > s_max or node_base + s_live > m_max:
            raise RuntimeError("segment capacity exceeded")
        active = pseg >= 0
        ps = torch.where(active, pseg, 0)
        ends = seg_start + seg_cnt
        g_cnt = seg_cnt
        if progress_cb is not None:
            progress_cb(level, s_live, int(g_cnt.sum()))

        # --- phase 1: split dimension from (optionally subsampled)
        # segment moments via prefix-sum differences. Subsampling (every
        # k-th row) only ranks dimensions; the plane itself is exact.
        k = stats_subsample
        xs = pvec[::k]
        n_before = lambda idx: (idx + (k - 1)) // k  # samples before idx
        s_lo, s_hi = n_before(seg_start), n_before(ends)
        sums_c, sumsq_c = [], []
        for c0 in range(0, d, _D_CHUNK):
            # scan along the last dim: [chunk, ns] rows scan in parallel
            xc = xs[:, c0 : c0 + _D_CHUNK].T
            pre = prefix_sum(xc)
            sums_c.append(at(pre, s_hi) - at(pre, s_lo))
            pre = prefix_sum(xc * xc)
            sumsq_c.append(at(pre, s_hi) - at(pre, s_lo))
            del pre, xc
        sums = torch.cat(sums_c, dim=0).T  # [S, D]
        sumsq = torch.cat(sumsq_c, dim=0).T

        cnt_f = torch.clamp(g_cnt, min=1).to(torch.float32)
        cnt_sub = s_hi - s_lo
        cnt_sub_f = torch.clamp(cnt_sub, min=1).to(torch.float32)
        mean_sub = sums / cnt_sub_f[:, None]
        # XLA evaluates ``sumsq - (cnt * mean) * mean`` as one fused
        # multiply-subtract (a single rounding); the f64 product of two
        # f32 values is exact, so this rounds the same way and dimension
        # ranking ties break as in the JAX build
        cm = (cnt_sub_f[:, None] * mean_sub).double()
        m2 = torch.clamp(
            (sumsq.double() - cm * mean_sub.double()).float(), min=0.0
        )

        # alternating max/min variance by level parity; first on ties
        split_dim = (torch.argmax(m2, dim=1) if use_max
                     else torch.argmin(m2, dim=1))
        degenerate = (m2.gather(1, split_dim[:, None])[:, 0] == 0.0) | (
            cnt_sub == 0
        )
        is_int = (g_cnt > leaf_size) & (level < max_levels - 1)

        p_dim = split_dim[ps]
        p_start = seg_start[ps]
        p_gcnt = g_cnt[ps]
        if mean_id_ties:
            # floor(sum_ids / count) per segment from one int64 prefix sum
            # of the active rows' ids (exact: sums stay below 2^60)
            ic = torch.cumsum(torch.where(active, pid, 0), dim=0)
            mean_id = torch.div(at(ic, ends) - at(ic, seg_start),
                                torch.clamp(g_cnt, min=1),
                                rounding_mode="floor")

        # --- phase 2: per-row split value and the exact split plane (one
        # [N] prefix sum of the chosen column)
        value = pvec.gather(1, p_dim[:, None])[:, 0]
        vc = prefix_sum(torch.where(active, value, 0.0))
        mid = (at(vc, ends) - at(vc, seg_start)) / cnt_f
        p_mid = mid[ps]

        local_rank = pos - p_start
        if mean_id_ties:
            tie_high = pid > mean_id[ps]
        else:
            # positional ties: lows get the first ceil(cnt/2) ranks
            tie_high = 2 * local_rank >= p_gcnt + (p_gcnt & 1)
        normal_high = (value > p_mid) | ((value == p_mid) & tie_high)

        is_low_n = active & ~normal_high
        cl = torch.cumsum(is_low_n.to(torch.int64), dim=0)
        cl_lo = at(cl, seg_start)
        lo_cnt = at(cl, ends) - cl_lo
        # zero-progress guard (fp edge: every row on one side) -> forced
        # tie partition, like a degenerate segment
        stuck = is_int & ((lo_cnt == 0) | (lo_cnt == g_cnt))
        degen_split = degenerate | stuck
        if mean_id_ties:
            # tie-partitioned segments split purely by id: recount lows
            cli = torch.cumsum((active & ~tie_high).to(torch.int64), dim=0)
            cli_lo = at(cli, seg_start)
            lo_cnt = torch.where(degen_split, at(cli, ends) - cli_lo, lo_cnt)
        else:
            lo_cnt = torch.where(degen_split, (g_cnt + 1) // 2, lo_cnt)

        # --- child numbering and boundaries
        ii = is_int.to(torch.int64)
        rank = torch.cumsum(ii, dim=0) - ii
        num_internal = int(ii.sum())  # the level's one host sync
        next_base = node_base + s_live
        # children of internal segment r land at 2r, 2r+1; leaves write
        # into a dropped slot past the end
        tgt = torch.where(is_int, 2 * rank, 2 * num_internal)
        new_start = torch.zeros(2 * num_internal + 2, **i64)
        new_cnt = torch.zeros(2 * num_internal + 2, **i64)
        new_start[tgt] = seg_start
        new_start[tgt + 1] = seg_start + lo_cnt
        new_cnt[tgt] = lo_cnt
        new_cnt[tgt + 1] = seg_cnt - lo_cnt
        new_start = new_start[: 2 * num_internal]
        new_cnt = new_cnt[: 2 * num_internal]

        # --- this level's node block. Tie-partitioned nodes store dim -2:
        # no plane separates their children, the search descends both.
        node_dim = torch.where(degen_split, -2, split_dim)
        blocks.append((
            torch.where(is_int, node_dim, -1),
            torch.where(is_int & ~degen_split, mid, 0.0),
            torch.where(is_int, next_base + 2 * rank, -1),
            torch.where(is_int, next_base + 2 * rank + 1, -1),
            # leaves record their (start, count): rows never move again
            torch.where(is_int, 0, seg_start),
            torch.where(is_int, 0, seg_cnt),
        ))

        # --- phase 3: stable within-range partition (rank splits move
        # no rows; id splits move rows like plane splits)
        p_locnt = lo_cnt[ps]
        p_degen = degen_split[ps]
        p_is_int = is_int[ps]
        p_rank = rank[ps]
        go_high = torch.where(p_degen, tie_high, normal_high)
        lows_upto = cl - cl_lo[ps]  # inclusive lows in [start, i]
        if mean_id_ties:
            moving = active & p_is_int
            lows_upto = torch.where(p_degen, cli - cli_lo[ps], lows_upto)
        else:
            moving = active & p_is_int & ~p_degen
        dest_low = p_start + lows_upto - 1
        dest_high = p_start + p_locnt + local_rank - lows_upto
        dest = torch.where(moving, torch.where(go_high, dest_high, dest_low),
                           pos)
        src = torch.empty_like(pos)
        src[dest] = pos  # invert the (unique-index) permutation

        new_seg = torch.where(active & p_is_int,
                              2 * p_rank + go_high.to(torch.int64), -1)
        new_leaf = torch.where(active & ~p_is_int, node_base + ps, pleaf)
        pvec = pvec[src]
        pid, pseg, pleaf = pid[src], new_seg[src], new_leaf[src]
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
    nd, nm, nl, nh, nls, nlc = (torch.cat(col) for col in zip(*blocks))
    i32 = torch.int32
    return (nd.to(i32), nm, nl.to(i32), nh.to(i32), nls.to(i32),
            nlc.to(i32), pid.to(i32), pvec, node_base + s_live, level)
