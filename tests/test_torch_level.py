"""One level of the host-loop build, ``vector_database_tpu_torch.ops.level``,
against the JAX package's ``level_step`` (XLA on the CPU).

On integer-valued data every segment total is exact (the port's float64
prefix differences and JAX's float32 scatter-adds both), so every output
key must be equal bit for bit, dtypes included: one level, several levels
in a row (each side fed its own outputs), under ``use_max`` True and
False, with degenerate (zero-variance) segments, segments that the plane
would leave with an empty child (the zero-progress guard), and exact
variance ties across dimensions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_database_tpu.ops.level import level_step as jax_level_step
from vector_database_tpu_torch.ops.level import level_math, next_pow2

torch.set_num_threads(2)


def _both(v, seg, leaf, use_max, node_base, S, leaf_size, ids=None):
    ids = np.arange(v.shape[0], dtype=np.int32) if ids is None else ids
    j = jax_level_step(jnp.asarray(v), jnp.asarray(ids), jnp.asarray(seg),
                       jnp.asarray(leaf), jnp.asarray(use_max),
                       jnp.asarray(node_base, jnp.int32), num_segments=S,
                       leaf_size=leaf_size)
    t = level_math(torch.tensor(v), torch.tensor(ids), torch.tensor(seg),
                   torch.tensor(leaf), use_max,
                   node_base, num_segments=S, leaf_size=leaf_size)
    return {k: np.asarray(x) for k, x in j.items()}, \
        {k: x.numpy() for k, x in t.items()}


def _assert_equal(j, t):
    assert set(j) == set(t)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("use_max", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_level_equals_jax(seed, use_max):
    """Random segments over integer rows, some rows retired (seg -1) with
    their leaves kept, more segments than are live."""
    rng = np.random.default_rng(seed)
    n, d, S = 400, 7, 32
    v = rng.integers(-6, 7, (n, d)).astype(np.float32)
    seg = rng.integers(-1, 21, n).astype(np.int32)
    leaf = np.where(seg < 0, rng.integers(0, 9, n), -1).astype(np.int32)
    j, t = _both(v, seg, leaf, use_max, 13, S, leaf_size=3)
    _assert_equal(j, t)


@pytest.mark.parametrize("leaf_size", [1, 4])
def test_levels_in_a_row_equal_jax(leaf_size):
    """The host loop's state through every level: each side is fed its own
    ``new_seg``/``new_leaf`` and its own live count."""
    rng = np.random.default_rng(5)
    v = rng.integers(-9, 10, (400, 7)).astype(np.float32)
    v[:60] = v[0]  # a run of duplicates: degenerate segments deep down
    jseg = tseg = np.zeros(400, np.int32)
    jleaf = tleaf = np.full(400, -1, np.int32)
    s_live, node_base, use_max, levels = 1, 0, True, 0
    while s_live:
        j, _ = _both(v, jseg, jleaf, use_max, node_base, next_pow2(s_live),
                     leaf_size)
        _, t = _both(v, tseg, tleaf, use_max, node_base, next_pow2(s_live),
                     leaf_size)
        _assert_equal(j, t)
        jseg, jleaf = j["new_seg"], j["new_leaf"]
        tseg, tleaf = t["new_seg"], t["new_leaf"]
        node_base += s_live
        s_live = 2 * int(t["num_internal"])
        use_max = not use_max
        levels += 1
    assert levels > 5 and (tleaf >= 0).all()


def test_degenerate_and_stuck_segments_equal_jax():
    """Segment 0: identical rows (zero variance: the id partition).
    Segment 1: rows 2^24 + 2 (id 3) and 2^24 (id 4): their float32 sum
    rounds to 2^25, so the plane is 2^24 and both rows go high (the larger
    above it, the other on it with an id above the mean id 3): the
    zero-progress guard falls back to the id partition. Segment 2: plain
    integers. Retired rows around them."""
    big = float(2 ** 24)
    v = np.array([
        [3, 1], [3, 1], [3, 1],               # seg 0
        [big + 2, 0], [big, 0],               # seg 1 (ids 3, 4)
        [1, 5], [4, -2], [-3, 0], [2, 2],     # seg 2
        [7, 7],                               # retired
    ], np.float32)
    seg = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, -1], np.int32)
    leaf = np.array([-1] * 9 + [5], np.int32)
    j, t = _both(v, seg, leaf, True, 6, 4, leaf_size=1)
    _assert_equal(j, t)
    assert t["degenerate"][0] and t["dual"][0]
    assert not t["degenerate"][1] and t["dual"][1]  # stuck
    assert not t["dual"][2]
    # the guard split segment 1 by id: id 3 low, id 4 high
    np.testing.assert_array_equal(t["new_seg"][3:5] % 2, [0, 1])


@pytest.mark.parametrize("use_max", [True, False])
def test_exact_variance_ties_take_the_first_dimension(use_max):
    """Columns whose variances tie exactly (permutations of one column)
    pick the first such dimension, as JAX's argmax/argmin do. The
    15-row pair A/B ties only under XLA's fused ``sumsq - (cnt * mean) *
    mean`` (one rounding: both 450.93332, where two roundings give A
    450.93335): the first dimension wins there too."""
    a = np.array([7, 7, 0, 8, 2, 8, 9, 1, -4, -7, 1, -6, 5, 8, -5],
                 np.float32)
    b = np.array([6, -6, -4, -4, 5, 1, -5, 5, 3, 8, 1, -7, 7, -6, -8],
                 np.float32)
    rng = np.random.default_rng(9)
    perm = np.stack([a, a[::-1], a[rng.permutation(15)]], 1)
    for v in (np.stack([b, a], 1), perm, np.stack([a, b, a], 1)):
        v = np.ascontiguousarray(v)
        n = v.shape[0]
        j, t = _both(v, np.zeros(n, np.int32), np.full(n, -1, np.int32),
                     use_max, 0, 1, leaf_size=1)
        _assert_equal(j, t)
    j, t = _both(np.ascontiguousarray(np.stack([b, a], 1)),
                 np.zeros(15, np.int32), np.full(15, -1, np.int32), True, 0,
                 1, leaf_size=1)
    assert t["split_dim"][0] == 0


def test_next_pow2_equals_jax():
    from vector_database_tpu.ops.level import next_pow2 as jax_next_pow2

    for x in list(range(0, 70)) + [1023, 1024, 1025, 2 ** 20 + 1]:
        assert next_pow2(x) == jax_next_pow2(x)
