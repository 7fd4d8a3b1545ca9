"""The fused build of vector_database_tpu_torch against the JAX package.

On integer-valued data every f32 prefix sum is exact, so summation order
cannot matter and the node tables must be bitwise equal, under both tie
rules (``mean_id`` id sums are exact integers on both sides: int32 limbs
in JAX, one int64 prefix sum in the port). On float data the trees may
differ in the last ulp of a plane; there the search must equal the exact
oracle. The plain segment moments (phase 1 on the CPU) hold to float64
sums within the prefix sum's bound, and to exact sums on integer data.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu.models.bsp import BSPIndex as JaxBSPIndex
from vector_database_tpu_torch import build_index_fused, exact_ball, search
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.sorted_build import (
    prefix_sum,
    segment_moments,
    segment_moments_reference,
)
from vector_database_tpu_torch.utils import datasets

from segment_cases import (TensorsMade, float64_moments, ragged_segments,
                           row_index, with_orders)

torch.set_num_threads(2)

FIELDS = ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
          "orig_row", "vectors")


def _assert_same_tree(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (t.depth, t.leaf_cap, t.num_leaves) == \
        (j.depth, j.leaf_cap, j.num_leaves)


@pytest.mark.parametrize("stats_subsample", [1, 4])
@pytest.mark.parametrize("split", ["alternate", "max"])
def test_integer_data_bitwise_equal(stats_subsample, split):
    rng = np.random.default_rng(7 + stats_subsample)
    v = rng.integers(-8, 9, (3000, 7)).astype(np.float32)
    kw = dict(leaf_size=4, stats_subsample=stats_subsample, split=split)
    _assert_same_tree(build_index_fused(v, device="cpu", **kw),
                      jax_build(v, **kw))


@pytest.mark.parametrize("leaf_size,max_levels", [(1, None), (8, 5)])
def test_duplicates_and_depth_cap_bitwise_equal(leaf_size, max_levels):
    """Whole duplicate segments (zero variance: rank-partitioned dual
    nodes) and the depth-cap exit."""
    rng = np.random.default_rng(11)
    v = np.repeat(rng.integers(-3, 4, (40, 5)), 12, axis=0).astype(
        np.float32)
    kw = dict(leaf_size=leaf_size, max_levels=max_levels)
    _assert_same_tree(build_index_fused(v, device="cpu", **kw),
                      jax_build(v, **kw))


@pytest.mark.parametrize("kw", [
    dict(leaf_size=1),
    dict(leaf_size=4, split="max"),
    dict(leaf_size=3, stats_subsample=4),
    dict(leaf_size=8, max_levels=4),
])
def test_mean_id_ties_bitwise_equal(kw):
    """Duplicate-heavy integer data, shuffled so that ids and positions
    disagree: plane ties and whole zero-variance segments split by
    ``id > floor(mean id)``, and the rows move."""
    rng = np.random.default_rng(17)
    v = np.repeat(rng.integers(-3, 4, (60, 5)), 7, axis=0).astype(np.float32)
    v = v[rng.permutation(v.shape[0])]
    _assert_same_tree(build_index_fused(v, device="cpu", tie_break="mean_id",
                                        **kw),
                      jax_build(v, tie_break="mean_id", **kw))


def test_mean_id_row_bound_matches_jax():
    """Both packages accept mean_id builds up to 2^30 - 1 rows."""
    from vector_database_tpu.ops.sorted_build import id_limb_plan
    from vector_database_tpu_torch.ops.sorted_build import check_mean_id_rows

    for n in (1000, 17_000_000, 2 ** 30 - 1):
        id_limb_plan(n)
        check_mean_id_rows(n)
    with pytest.raises(ValueError, match="2\\^30"):
        id_limb_plan(2 ** 30)
    with pytest.raises(ValueError, match="2\\^30"):
        check_mean_id_rows(2 ** 30)


def test_float_data_search_equals_oracle():
    v = datasets.random_uniform(4000, 6, seed=21)
    q = datasets.random_uniform(16, 6, seed=22)
    index = build_index_fused(v, device="cpu", leaf_size=8)
    res = search(index, q, 0.45)
    ball = exact_ball(torch.from_numpy(v), q, 0.45).numpy()
    for i in range(16):
        assert set(res.match_rows(i).tolist()) == \
            set(np.nonzero(ball[i])[0].tolist())


def test_npz_round_trip_between_packages(tmp_path):
    v = datasets.random_uniform(2500, 5, seed=31)
    q = datasets.random_uniform(12, 5, seed=32)
    jidx = jax_build(v, leaf_size=4)
    jidx.save(str(tmp_path / "from_jax"))
    tidx = BSPIndex.load(str(tmp_path / "from_jax"), device="cpu")
    _assert_same_tree(tidx, jidx)
    from vector_database_tpu import search as jax_search

    jres, tres = jax_search(jidx, q, 0.5), search(tidx, q, 0.5)
    for i in range(12):
        assert set(tres.match_rows(i).tolist()) == \
            set(jres.match_rows(i).tolist())
    # and back: a port-saved index loads into the JAX package
    tidx.save(str(tmp_path / "from_torch.npz"))
    back = JaxBSPIndex.load(str(tmp_path / "from_torch.npz"))
    _assert_same_tree(tidx, back)


def test_argument_errors():
    v = datasets.random_uniform(100, 4, seed=1)
    # mean_id builds (it raised NotImplementedError before it was ported)
    assert build_index_fused(v, device="cpu", tie_break="mean_id").n == 100
    with pytest.raises(ValueError, match="tie_break"):
        build_index_fused(v, device="cpu", tie_break="median")
    with pytest.raises(ValueError):
        build_index_fused(v[:0], device="cpu")
    with pytest.raises(ValueError):
        build_index_fused(v, device="cpu", leaf_size=0)
    with pytest.raises(ValueError):
        build_index_fused(v, device="cpu", split="min")


def test_progress_callback():
    seen = []
    v = datasets.random_uniform(500, 4, seed=2)
    index = build_index_fused(v, device="cpu", leaf_size=8,
                              progress=lambda *a: seen.append(a))
    assert seen[0] == (0, 1, 500)
    assert len(seen) == index.depth


@pytest.mark.parametrize("shape", [(1,), (7,), (1024,), (1025,), (300_001,),
                                   (3, 2049), (96, 5000), (1, 3000)])
def test_prefix_sum_is_a_fixed_order_cumsum(shape):
    """The build's float prefix sum against float64 ``cumsum``: each f32
    partial sum is taken over at most a row of 1024 terms, then a chain of
    row totals, recursively, so its error stays within (1024 + n / 1024 +
    4) ulps of the running sum of |x|. On integer-valued data every sum is
    exact. A second call gives the same bits: the order of additions
    depends on the shape alone."""
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    got = prefix_sum(torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    x64 = x.astype(np.float64)
    tol = (1024 + shape[-1] / 1024 + 4) * 2.0 ** -24 * \
        np.cumsum(np.abs(x64), axis=-1)
    assert (np.abs(got.numpy() - np.cumsum(x64, axis=-1)) <= tol).all()
    assert torch.equal(got, prefix_sum(torch.from_numpy(x.copy())))
    ints = np.rint(x * 100).astype(np.float32)
    np.testing.assert_array_equal(prefix_sum(torch.from_numpy(ints)).numpy(),
                                  np.cumsum(ints.astype(np.float64), axis=-1))


@pytest.mark.parametrize("k,d,order", with_orders(
    [(k, d) for k in (1, 4) for d in (3, 96, 200)]))
def test_segment_moments_plain_version(k, d, order):
    """The plain segment moments against float64 on ragged segments with
    gaps between them, empty segments and (k = 4) segments that hold no
    sample. Each sum is the difference of two ``prefix_sum`` values, so its
    error stays within twice their bound: (1024 + ns / 1024 + 4) ulps of
    the running sum of |x| up to the segment's end, one more for the
    rounded squares. On integer-valued data the sums equal ``index_add_``'s
    bit for bit. Through a row index (``order``: the build's, ascending
    inside each segment, or one in no order) they are the moments of the
    rows it gathers, bit for bit. The wrapper runs the plain version on
    CPU tensors and has none for another device."""
    rng = np.random.default_rng(100 * k + d)
    n, s = 3000, 60
    start, cnt = ragged_segments(rng, n, s)
    st, ct = torch.from_numpy(start), torch.from_numpy(cnt)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    rows = row_index(rng, start, cnt, n, order)
    xr = x if rows is None else x[rows]
    sums, sumsq = segment_moments_reference(x, st, ct, k, rows)
    assert sums.shape == sumsq.shape == (s, d)
    ref, ref2, _, n_s = float64_moments(xr, start, cnt, k)
    assert (cnt == 0).any()
    assert k == 1 or ((n_s.numpy() == 0) & (cnt > 0)).any()
    ns = -(-n // k)
    run = torch.cumsum(xr[::k].double().abs(), 0)
    run2 = torch.cumsum(xr[::k].double() ** 2, 0)
    end = torch.clamp(-(-(st + ct) // k) - 1, min=0)
    ulps = (1024 + ns / 1024 + 4) * 2.0 ** -24
    assert ((sums.double() - ref).abs() <= 2 * ulps * run[end]).all()
    assert ((sumsq.double() - ref2).abs() <=
            2 * (ulps + 2.0 ** -24) * run2[end]).all()
    assert torch.equal(segment_moments(x, st, ct, k, rows)[0], sums)
    if rows is not None:
        want = segment_moments_reference(xr, st, ct, k)
        assert torch.equal(sums, want[0]) and torch.equal(sumsq, want[1])

    xi = torch.round(x * 3)
    isums, isumsq = segment_moments_reference(xi, st, ct, k, rows)
    iref, iref2, _, _ = float64_moments(xi if rows is None else xi[rows],
                                        start, cnt, k)
    assert torch.equal(isums, iref.float())
    assert torch.equal(isumsq, iref2.float())
    with pytest.raises(RuntimeError, match="no kernel"):
        segment_moments(x.to("meta"), st.to("meta"), ct.to("meta"), k)


@pytest.mark.parametrize("leaf_size", [1, 16])
def test_fused_build_gathers_the_rows_once(leaf_size):
    """The levels move a row index, not the rows: whatever the depth, a
    fused build makes one tensor of whole rows, the leaf-major matrix,
    and that matrix is the input's rows in ``orig_row``'s order. On the
    CPU the plain moments gather their samples, every 4th row, once a
    level; the card's kernel reads them through the index."""
    n, d = 4000, 6
    v = torch.from_numpy(datasets.random_uniform(n, d, seed=3))
    with TensorsMade() as made:
        index = build_index_fused(v, device="cpu", leaf_size=leaf_size,
                                  stats_subsample=4)
    assert index.depth > 1
    assert made.count[(n, d)] == 1
    assert made.count[(n // 4, d)] == index.depth
    assert torch.equal(index.vectors, v[index.orig_row.long()])
