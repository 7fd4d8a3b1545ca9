"""BoolMatrixIndex of vector_database_tpu_torch against the JAX package's.

Every quantity is a small integer (+-1 codes, Hamming distances), so the
two packages' trees are equal and every answer must be equal: rows,
distances, identifications and the order of equal distances (the lower
leaf-major row first in both).
"""

import numpy as np
import pytest
import torch

from vector_database_tpu.models.boolmatrix import (
    BoolMatrixIndex as JaxBoolMatrixIndex,
)
from vector_database_tpu_torch import BoolMatrixIndex
from vector_database_tpu_torch.models.boolmatrix import pack_bits, unpack_bits

torch.set_num_threads(2)


def random_matrix(n=200, p=40, seed=60):
    return np.random.default_rng(seed).random((n, p)) < 0.5


def hamming(a, b):
    return int(np.sum(a != b))


def test_pack_roundtrip():
    m = random_matrix(17, 70)
    assert (unpack_bits(pack_bits(m), 70) == m).all()


def test_tree_equals_jax():
    m = random_matrix(300, 32, seed=63)
    t = BoolMatrixIndex(m, leaf_size=4, device="cpu")
    j = JaxBoolMatrixIndex(m, leaf_size=4)
    np.testing.assert_array_equal(t.packed, j.packed)
    for name in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                 "vectors", "orig_row"):
        np.testing.assert_array_equal(getattr(t._index, name).numpy(),
                                      np.asarray(getattr(j._index, name)))


def test_identify():
    m = np.unique(random_matrix(), axis=0)
    t = BoolMatrixIndex(m, device="cpu")
    for i in (0, len(m) // 2, len(m) - 1):
        assert t.identify(m[i]) == i
    probe = m[0].copy()
    probe[:3] = ~probe[:3]
    if not any((row == probe).all() for row in m):
        assert t.identify(probe) is None


def test_find_hamming_matches_jax_and_oracle():
    m = random_matrix(150, 24, seed=61)
    t = BoolMatrixIndex(m, leaf_size=4, device="cpu")
    j = JaxBoolMatrixIndex(m, leaf_size=4)
    queries = np.random.default_rng(62).random((5, 24)) < 0.5
    got = t.find_hamming(queries, 3)
    want = j.find_hamming(queries, 3)
    for qi in range(5):
        rows, dists = got[qi]
        assert sorted(zip(rows.tolist(), dists.tolist())) == \
            sorted(zip(want[qi][0].tolist(), want[qi][1].tolist()))
        assert set(rows.tolist()) == {
            i for i in range(len(m)) if hamming(m[i], queries[qi]) <= 3}
        for r, dd in zip(rows, dists):
            assert hamming(m[r], queries[qi]) == dd


@pytest.mark.parametrize("n,k", [(300, 5), (300, 40), (6, 10)])
def test_knn_hamming_equals_jax(n, k):
    """Equal rows and distances in order, ties included; k > n pads."""
    m = random_matrix(n, 32, seed=63)
    t = BoolMatrixIndex(m, leaf_size=2, device="cpu")
    j = JaxBoolMatrixIndex(m, leaf_size=2)
    q = m[[0, 1, n - 1]]
    rows, ham = t.knn_hamming(q, k=k)
    jrows, jham = j.knn_hamming(q, k=k)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(ham, jham)
    assert rows.shape == ham.shape == (3, k)
    assert (rows[:, 0] == [0, 1, n - 1]).all() and (ham[:, 0] == 0).all()
    all_d = sorted(hamming(m[i], q[0]) for i in range(n))
    assert sorted(ham[0][rows[0] >= 0].tolist()) == all_d[:min(k, n)]
    if k > n:
        assert (rows[:, n:] == -1).all()


def test_best_question():
    m = np.zeros((10, 3), dtype=bool)
    m[:5, 1] = True  # property 1: a perfect 50/50 split
    m[:3, 2] = True
    t = BoolMatrixIndex(m, device="cpu")
    assert t.best_question() == 1
    assert t.best_question([0, 1, 2, 3]) in (1, 2)
    with pytest.raises(ValueError, match="empty"):
        t.best_question(candidate_rows=[])


def test_identify_batch_equals_jax():
    m = np.unique(random_matrix(400, 32, seed=66), axis=0)
    t = BoolMatrixIndex(m, leaf_size=4, device="cpu")
    j = JaxBoolMatrixIndex(m, leaf_size=4)
    assert t.identify_batch(m).tolist() == list(range(len(m)))
    probes = m[:16].copy()
    probes[:, :5] = ~probes[:, :5]
    got = t.identify_batch(probes).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.identify_batch(probes)))
    member = np.array([any((row == pr).all() for row in m) for pr in probes])
    assert ((got >= 0) == member).all()
