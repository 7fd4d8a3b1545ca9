"""Tree search of vector_database_tpu_torch against the JAX package.

Both packages walk the same tree (built by JAX, loaded into the port
through ``BSPIndex.from_numpy``). The frontier walk must reach exactly the
leaf set of JAX's per-query DFS ``_traverse``; results must equal JAX's
and the exact oracle as sets (rerank distances: rtol 1e-5, atol 1e-6, f32
sums over D in another order).
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu_torch import (
    build_index_fused,
    exact_ball,
    exact_knn,
    knn,
    search,
)
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.utils import datasets

# the packages export a function named ``search`` over the module's name
jsearch = importlib.import_module("vector_database_tpu.search")
tsearch = importlib.import_module("vector_database_tpu_torch.search")

torch.set_num_threads(2)


def _pair(n=3000, d=4, leaf=8, seed=41):
    v = datasets.random_uniform(n, d, seed=seed)
    jidx = jax_build(v, leaf_size=leaf)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in (
        "dim", "mid", "low", "high", "leaf_start", "leaf_count", "vectors",
        "orig_row")}
    tidx = BSPIndex.from_numpy(
        arrays, [jidx.depth, jidx.leaf_cap, jidx.num_leaves], device="cpu")
    return v, jidx, tidx


@pytest.mark.parametrize("radius", [0.05, 0.3, 0.8])
def test_frontier_reaches_dfs_leaf_set(radius):
    v, jidx, tidx = _pair()
    q = datasets.random_uniform(24, 4, seed=42)
    width = jidx.num_leaves
    jl, jn, jov = jsearch._traverse(
        jidx.dim, jidx.mid, jidx.low, jidx.high, q, np.float32(radius),
        max_leaves=width, max_stack=jidx.depth + 2)
    tl, tn, tov = tsearch._traverse_bfs(
        tidx.dim, tidx.mid, tidx.low, tidx.high, torch.from_numpy(q),
        torch.tensor(radius, dtype=torch.float32), max_leaves=width,
        depth=tidx.depth)
    jl = np.asarray(jl)
    for i in range(24):
        want = set(jl[i][jl[i] >= 0].tolist())
        got = set(tl[i][tl[i] >= 0].tolist())
        assert got == want
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert not tov.any() and not np.asarray(jov).any()


@pytest.mark.parametrize("traversal", ["dfs", "bfs"])
def test_search_matches_jax_and_oracle(traversal):
    v, jidx, tidx = _pair()
    q = datasets.random_uniform(16, 4, seed=43)
    jres = jsearch.search(jidx, q, 0.35)
    tres = search(tidx, q, 0.35, traversal=traversal)
    ball = exact_ball(torch.from_numpy(v), q, 0.35).numpy()
    for i in range(16):
        got = set(tres.match_rows(i).tolist())
        assert got == set(jres.match_rows(i).tolist())
        assert got == set(np.nonzero(ball[i])[0].tolist())
    np.testing.assert_array_equal(tres.count.numpy(),
                                  np.asarray(jres.count))
    np.testing.assert_array_equal(tres.candidates.numpy(),
                                  np.asarray(jres.candidates))


def test_auto_grow_from_a_tiny_leaf_buffer():
    v, _, tidx = _pair()
    q = datasets.random_uniform(8, 4, seed=44)
    res = search(tidx, q, 0.6, max_leaves=2)
    assert not res.overflow.any()
    ball = exact_ball(torch.from_numpy(v), q, 0.6).numpy()
    for i in range(8):
        assert set(res.match_rows(i).tolist()) == \
            set(np.nonzero(ball[i])[0].tolist())
    capped = search(tidx, q, 0.6, max_leaves=2, auto_grow=False)
    assert capped.overflow.any()


def test_knn_matches_jax_and_oracle():
    v, jidx, tidx = _pair()
    q = datasets.random_uniform(16, 4, seed=45)
    jr, jd = jsearch.knn(jidx, q, 5, 0.4)
    tr, td = knn(tidx, q, 5, 0.4)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    er, _ = exact_knn(torch.from_numpy(v), q, k=5)
    for i in range(16):
        if np.isfinite(td[i].numpy()).all():
            assert set(tr[i].tolist()) == set(er[i].tolist())


def test_knn_row_filter_and_padding():
    v, jidx, tidx = _pair()
    q = datasets.random_uniform(8, 4, seed=46)
    allowed = np.random.default_rng(0).random(v.shape[0]) < 0.3
    jr, jd = jsearch.knn(jidx, q, 6, 0.3, row_filter=allowed)
    tr, td = knn(tidx, q, 6, 0.3, row_filter=allowed)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    got = tr.numpy()
    assert allowed[got[got >= 0]].all()
    # a tiny radius leaves fewer than k: -1 / +inf padding
    pr, pd = knn(tidx, q, 6, 0.01)
    assert (pr.numpy() == -1).any() and np.isinf(pd.numpy()).any()


def test_calibrate_radius_and_auto_radius_knn():
    v, jidx, tidx = _pair()
    q = datasets.random_uniform(32, 4, seed=47)
    jr = jsearch.calibrate_radius(v, q, 5)
    tr = tsearch.calibrate_radius(torch.from_numpy(v), q, 5)
    assert tr == pytest.approx(jr, rel=1e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rows, d2 = knn(tidx, q, 5)  # radius=None: calibrated
    assert rows.shape == (32, 5)


@pytest.mark.parametrize("kw", [
    dict(leaf_size=2),
    dict(leaf_size=4, split="max"),
    dict(leaf_size=1, tie_break="mean_id"),
])
def test_locate_matches_jax(kw):
    """Duplicate-heavy integer data (bitwise equal trees in both
    packages): stored rows, off-grid misses and on-grid points. Paths
    through dual nodes that miss take the exact ``search(q, 0.0)``
    fallback, which must pick the same duplicate as JAX's DFS."""
    rng = np.random.default_rng(3)
    v = np.repeat(rng.integers(-2, 3, (80, 4)), 5, axis=0).astype(np.float32)
    v = v[rng.permutation(v.shape[0])]
    q = np.concatenate([
        v[rng.integers(0, v.shape[0], 30)],
        rng.integers(-2, 3, (20, 4)).astype(np.float32) + 0.5,
        rng.integers(-2, 3, (20, 4)).astype(np.float32),
    ])
    jidx, tidx = jax_build(v, **kw), build_index_fused(v, device="cpu", **kw)
    jl, jd = jsearch._descend(jidx.dim, jidx.mid, jidx.low, jidx.high, q,
                              depth=jidx.depth)
    tl, td = tsearch._descend(tidx.dim, tidx.mid, tidx.low, tidx.high,
                              torch.from_numpy(q), depth=tidx.depth)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    want = np.asarray(jsearch.locate(jidx, q))
    got = tsearch.locate(tidx, q).numpy()
    np.testing.assert_array_equal(got, want)
    found = got >= 0
    np.testing.assert_array_equal(v[got[found]], q[found])
    # the stored rows are all found, some of them through the fallback
    assert found[:30].all()
    assert (td.numpy() & (got >= 0)).any()


def test_locate_fallback_below_a_dual_node():
    """A zero-variance split dimension makes a dual node whose low guess
    misses: the exact fallback finds the row."""
    v = np.array([[0, 0], [0, 1], [0, 2], [0, 3]], np.float32)
    idx = build_index_fused(v, leaf_size=1, split="alternate", device="cpu")
    rows = tsearch.locate(idx, v)
    np.testing.assert_array_equal(rows.numpy(), [0, 1, 2, 3])
    want = np.asarray(jsearch.locate(jax_build(v, leaf_size=1), v))
    np.testing.assert_array_equal(rows.numpy(), want)
    assert tsearch.locate(idx, np.array([0.5, 0.5], np.float32)).tolist() \
        == [-1]
