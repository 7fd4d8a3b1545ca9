"""The fused build of vector_database_tpu_torch against the JAX package.

On integer-valued data every f32 prefix sum is exact, so summation order
cannot matter and the node tables must be bitwise equal, under both tie
rules (``mean_id`` id sums are exact integers on both sides: int32 limbs
in JAX, one int64 prefix sum in the port). On float data the trees may
differ in the last ulp of a plane; there the search must equal the exact
oracle.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu.models.bsp import BSPIndex as JaxBSPIndex
from vector_database_tpu_torch import build_index_fused, exact_ball, search
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.utils import datasets

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
