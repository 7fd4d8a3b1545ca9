"""The exact oracle of vector_database_tpu_torch against the JAX package.

Tolerances: distances are f32 sums over D taken in another order (and
JAX's matmul form at HIGHEST precision vs torch's full-f32 product), so
they agree to rtol 1e-5 / atol 1e-5; indices and ball sets are equal on
tie-free random data. Host data goes to the port as CPU tensors: with
no tensor and no ``device`` its entry points target the card.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu.ops import exact as jx
from vector_database_tpu_torch.ops import exact as tx
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)


def _data(n=1500, d=12, q=20, seed=3):
    return (datasets.random_uniform(n, d, seed=seed),
            datasets.random_uniform(q, d, seed=seed + 1))


@pytest.mark.parametrize("fn", ["pairwise_sq_dists", "exact_sq_dists"])
def test_distance_matrices(fn):
    v, q = _data()
    want = np.asarray(getattr(jx, fn)(q, v))
    got = getattr(tx, fn)(torch.from_numpy(q), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_matmul", [False, True])
def test_exact_ball(use_matmul):
    v, q = _data()
    want = np.asarray(jx.exact_ball(v, q, 0.9, use_matmul=use_matmul))
    got = tx.exact_ball(torch.from_numpy(v), q, 0.9,
                        use_matmul=use_matmul).numpy()
    # boundary points could flip on a last-ulp difference: none here
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,block", [(5, None), (7, 256), (3, 1000)])
def test_exact_knn(k, block):
    v, q = _data(n=2000)
    ji, jd = jx.exact_knn(v, q, k=k, block=block)
    ti, td = tx.exact_knn(torch.from_numpy(v), q, k=k, block=block)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_exact_knn_k_exceeds_n():
    v, q = _data(n=4, q=3)
    ti, td = tx.exact_knn(torch.from_numpy(v), q, k=6)
    ji, jd = jx.exact_knn(v, q, k=6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.isinf(td.numpy()[:, 4:]).all()


@pytest.mark.parametrize("k", [4, 9])
def test_exact_mips(k):
    rng = np.random.default_rng(5)
    v = rng.random((300, 16), dtype=np.float32) * 2 - 1
    q = rng.random((10, 16), dtype=np.float32) * 2 - 1
    if k > 8:
        v = v[:8]  # k > n pads with -1 / -inf
    ji, jd = jx.exact_mips(v, q, k=k)
    ti, td = tx.exact_mips(torch.from_numpy(v), q, k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_normalize_rows():
    v, _ = _data()
    v[3] = 0.0  # zero rows stay zero
    got = tx.normalize_rows(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jx.normalize_rows(v)),
                               rtol=1e-6, atol=1e-7)


def test_full_f32_restores_tf32_flag():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tx.full_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
