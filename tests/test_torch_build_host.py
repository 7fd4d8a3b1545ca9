"""The host-loop build of vector_database_tpu_torch (``build_index``)
against the JAX package's.

On integer-valued data every segment total is exact on both sides, so the
whole index (node table, leaf runs, leaf-major rows, ``orig_row``, depth,
leaf cap, leaf count) must be equal bit for bit. On float data the port's
sums are float64 prefix differences and JAX's float32 scatter-adds, so a
near-tie may pick another split dimension: there the tree is held to the
contract (``test_build.check_tree``'s invariants, and ``search`` equal to
``exact_ball``).
"""

import numpy as np
import pytest
import torch

from test_build import check_tree
from test_fused import assert_same_tree
from vector_database_tpu import build_index as jax_build_index
from vector_database_tpu_torch import (
    build_index,
    build_index_fused,
    exact_ball,
    search,
)
from vector_database_tpu_torch.utils import datasets
from vector_database_tpu_torch.utils.profiling import (
    BuildStats,
    ProgressLogger,
)

torch.set_num_threads(2)

FIELDS = ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
          "orig_row", "vectors")


def _assert_same_index(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (t.depth, t.leaf_cap, t.num_leaves) == \
        (j.depth, j.leaf_cap, j.num_leaves)


@pytest.mark.parametrize("leaf_size,max_levels", [(1, None), (8, None),
                                                  (1, 3)])
def test_integer_data_bitwise_equal(leaf_size, max_levels):
    # the shape of "mixed_duplicates" below: JAX compiles each level once
    rng = np.random.default_rng(3)
    v = rng.integers(-8, 9, (210, 5)).astype(np.float32)
    kw = dict(leaf_size=leaf_size, max_levels=max_levels)
    _assert_same_index(build_index(v, device="cpu", **kw),
                       jax_build_index(v, **kw))


@pytest.mark.parametrize("name", ["duplicates", "grid_integer",
                                  "single_vector", "mixed_duplicates"])
def test_reference_fixtures_bitwise_equal(name):
    # "duplicates" and "mixed_duplicates" at the shape of the test above
    v = {
        "duplicates": np.ones((210, 5), np.float32),
        "grid_integer": datasets.grid2d_not_normalized(10),
        "single_vector": np.zeros((1, 3), np.float32),
        "mixed_duplicates": np.repeat(
            np.random.default_rng(4).integers(-3, 4, (30, 5)), 7,
            axis=0).astype(np.float32),
    }[name]
    t = build_index(v, device="cpu")
    _assert_same_index(t, jax_build_index(v))
    check_tree(t, v, 1)
    if name == "duplicates":  # zero variance everywhere: id partition
        assert t.leaf_cap == 1 and t.num_leaves == 210


@pytest.mark.parametrize("name,leaf_size", [("uniform", 1), ("uniform", 8),
                                            ("grid2d", 1), ("one_hot", 1)])
def test_float_data_meets_the_tree_contract(name, leaf_size):
    v = {
        "uniform": datasets.random_uniform(700, 8, seed=41),
        "grid2d": datasets.grid2d(10),
        "one_hot": datasets.one_hot_crafted(96),
    }[name]
    index = build_index(v, device="cpu", leaf_size=leaf_size)
    check_tree(index, v, leaf_size)
    q = np.concatenate([v[:4] + 0.01, datasets.random_uniform(
        4, v.shape[1], seed=45)])
    radius = 0.6 if name == "uniform" else 0.3
    res = search(index, q, radius)
    ball = exact_ball(torch.from_numpy(v), q, radius).numpy()
    for i in range(q.shape[0]):
        assert set(res.match_rows(i).tolist()) == \
            set(np.nonzero(ball[i])[0].tolist())


def test_max_levels_cap_retires_oversized_leaves():
    v = datasets.random_uniform(256, 8, seed=2)
    index = build_index(v, device="cpu", max_levels=3)
    assert index.depth <= 3 and index.leaf_cap > 1
    check_tree(index, v, leaf_size=index.leaf_cap)


def test_emitted_blocks_concatenate_to_the_node_table():
    """``emit`` streams each level's node block as numpy as it is made
    (``tests/test_build.py``'s contract); node ids are ``base + i``."""
    v = datasets.random_uniform(400, 5, seed=77)
    blocks = []
    index = build_index(
        v, device="cpu", leaf_size=3,
        emit=lambda base, dim, mid, low, high: blocks.append(
            (base, dim.copy(), mid.copy(), low.copy(), high.copy())))
    assert len(blocks) == index.depth
    assert blocks[0][0] == 0
    for (b0, d0, *_), (b1, *_) in zip(blocks, blocks[1:]):
        assert b0 + len(d0) == b1
    for i, f in enumerate(("dim", "mid", "low", "high"), start=1):
        cat = np.concatenate([b[i] for b in blocks])
        assert isinstance(blocks[0][i], np.ndarray)
        np.testing.assert_array_equal(cat, getattr(index, f).numpy())


def test_progress_feeds_build_stats_and_the_logger(capsys):
    stats = BuildStats()
    index = build_index(datasets.random_uniform(500, 8, seed=120),
                        device="cpu", progress=stats)
    assert len(stats.levels) == index.depth >= 5
    assert (stats.levels[0].active_points, stats.levels[0].live_ranges) == \
        (500, 1)
    actives = [s.active_points for s in stats.levels]
    assert all(a >= b for a, b in zip(actives, actives[1:]))
    assert "level" in stats.report()
    build_index(datasets.random_uniform(200, 4, seed=121), device="cpu",
                progress=ProgressLogger(every=1))
    assert "Process level 0: 1 ranges, 200 active points" in \
        capsys.readouterr().out


def test_argument_errors():
    v = datasets.random_uniform(100, 4, seed=1)
    with pytest.raises(ValueError, match="zero vectors"):
        build_index(v[:0], device="cpu")
    with pytest.raises(ValueError, match="leaf_size"):
        build_index(v, device="cpu", leaf_size=0)


@pytest.mark.parametrize("name", ["duplicates", "one_hot"])
def test_equals_the_fused_build(name):
    """``tests/test_fused.py``'s two exact cases: the host-loop and fused
    builds give the same tree."""
    v = np.ones((40, 3), np.float32) * 0.25 if name == "duplicates" \
        else datasets.one_hot_crafted(64)
    assert_same_tree(build_index(v, device="cpu"),
                     build_index_fused(v, device="cpu"))


def test_input_tensor_stays_on_its_device():
    v = torch.from_numpy(datasets.random_uniform(300, 4, seed=5))
    index = build_index(v, leaf_size=4)
    assert index.vectors.device == v.device == index.dim.device
    torch.testing.assert_close(index.vectors, v[index.orig_row.long()],
                               rtol=0, atol=0)
