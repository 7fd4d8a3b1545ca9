"""The port's forest and query-sharded search against the JAX package's,
at 2 and 4 Gloo ranks.

The port side runs in spawned Gloo ranks (``torch_mesh_worker.py``, one
spawn per rank count); the JAX side runs here on ``make_mesh(P)`` of
conftest's 8 virtual devices. Rows and queries are integer and quarter
valued, so distances are exact on both sides: each rank's tree, the
padded widths and the merged answers are JAX's (ids up to rows that tie
the k-th distance).
"""

import functools

import numpy as np
import pytest
import torch

import torch_mesh_worker as w
from vector_database_tpu import build_index_fused as jax_fused
from vector_database_tpu.parallel.forest import build_forest as jax_forest
from vector_database_tpu.parallel.forest import forest_knn as jax_forest_knn
from vector_database_tpu.parallel import knn_sharded as jax_knn_sharded
from vector_database_tpu.parallel import make_mesh
from vector_database_tpu.parallel import search_sharded as jax_search_sharded
from vector_database_tpu_torch import build_index_fused, search

torch.set_num_threads(2)

FOREST = ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
          "vectors", "orig_row")


@functools.lru_cache(maxsize=None)
def jax_forest_of(world):
    rows, _, _ = w.forest_data()
    return jax_forest(rows, make_mesh(world), leaf_size=4)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def ranks(request, tmp_path_factory):
    world = request.param
    fo = jax_forest_of(world)
    inputs = {f"forest{world}": (
        {f: np.asarray(getattr(fo, f)) for f in FOREST},
        dict(depth=fo.depth, leaf_cap=fo.leaf_cap))}
    out = w.run_suite("forest", world,
                      tmp_path_factory.mktemp(f"forest{world}"), inputs)
    return world, out


def _case(ranks, name):
    world, out = ranks
    for p, res in enumerate(out):
        assert "error" not in res[name], f"rank {p}:\n{res[name]['error']}"
    return world, [res[name] for res in out]


@pytest.mark.parametrize("radius", ["wide", "narrow"])
def test_forest_knn_equals_jax(ranks, radius):
    world, outs = _case(ranks, "forest")
    _, q, wide = w.forest_data()
    r, d, ov = jax_forest_knn(jax_forest_of(world), q, 5,
                              wide if radius == "wide" else 0.6)
    for o in outs:
        got = o[radius]
        w.assert_topk_equal(got["rows"], got["d2"], r, d, what=radius)
        np.testing.assert_array_equal(got["overflow"], np.asarray(ov))


def test_forest_padded_widths_equal_jax(ranks):
    world, outs = _case(ranks, "forest")
    fo = jax_forest_of(world)
    want = dict(m=fo.dim.shape[1], n=fo.vectors.shape[1], depth=fo.depth,
                leaf_cap=fo.leaf_cap)
    for o in outs:
        assert o["widths"] == want


def test_jax_built_forest_served_by_port(ranks):
    world, outs = _case(ranks, "forest_from_jax")
    _, q, radius = w.forest_data()
    r, d, _ = jax_forest_knn(jax_forest_of(world), q, 5, radius)
    for o in outs:
        w.assert_topk_equal(o["rows"], o["d2"], r, d)


def test_search_sharded_equals_jax(ranks):
    world, outs = _case(ranks, "query_sharded")
    rows, q, radius = w.forest_data()
    want = jax_search_sharded(jax_fused(rows, leaf_size=4), q, radius,
                              make_mesh(world))
    for o in outs:
        assert o["rows"].shape[0] == q.shape[0]
        w.assert_same_matches(o["rows"], o["sq_dists"],
                              np.asarray(want.rows),
                              np.asarray(want.sq_dists))
        for f in ("count", "candidates", "overflow"):
            np.testing.assert_array_equal(o[f], np.asarray(getattr(want, f)),
                                          err_msg=f)
        for i in range(q.shape[0]):
            assert set(o["cand_rows"][i].tolist()) - {-1} == \
                set(np.asarray(want.cand_rows)[i].tolist()) - {-1}


def test_knn_sharded_equals_jax(ranks):
    world, outs = _case(ranks, "query_sharded")
    rows, q, radius = w.forest_data()
    r, d = jax_knn_sharded(jax_fused(rows, leaf_size=4), q, 5, radius,
                           make_mesh(world))
    for o in outs:
        w.assert_topk_equal(o["knn_rows"], o["knn_d2"], r, d)


def test_sharded_search_grows_on_every_rank_together(ranks):
    """Only the ranks holding the central queries overflow at two leaves;
    all of them grow the buffer together, so the result is one search of
    the whole batch."""
    world, outs = _case(ranks, "agreed_growth")
    rows, _, _ = w.forest_data()
    q = np.zeros((2 * world, 4), np.float32)
    q[world:] = 100.0
    want = search(build_index_fused(rows, leaf_size=4, device="cpu"), q, 4.0,
                  max_leaves=2)
    assert want.rows.shape[1] > 2 * 4  # it did grow
    for o in outs:
        np.testing.assert_array_equal(o["rows"], want.rows.numpy())
        np.testing.assert_array_equal(o["count"], want.count.numpy())
        np.testing.assert_array_equal(o["overflow"], want.overflow.numpy())
