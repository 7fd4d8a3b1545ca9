"""The streaming scan ``scan_knn`` of vector_database_tpu_torch against the
JAX package and the exact oracle.

Both sides get the same numpy-seeded inputs (the JAX scan is plain XLA,
no Pallas). Tolerances, with their reasons:
- integer-valued data: every product and every f32 sum is exact in any
  order, and both sides keep the lower index on equal scores, so rows and
  distances are bitwise equal to JAX's, in order;
- float data: the two sides sum in other orders, so they are held to the
  exact oracle instead: neighbour sets equal, distances rtol 1e-4, atol
  1e-5 (the precise path's |q|^2 + |v|^2 - 2 q.v expansion against the
  oracle's), and the bucketed path's rerank rtol 1e-3 as in the JAX
  package's own tests.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu.ops.scan_knn import scan_knn as jax_scan_knn
from vector_database_tpu_torch import exact_knn, scan_knn
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)
# host data reaches the port as CPU tensors: with no tensor and no
# ``device`` its entry points target the card
_cpu = torch.from_numpy


def _ints(seed, n, q, d=8, span=4):
    rng = np.random.default_rng(seed)
    v = rng.integers(-span, span + 1, (n, d)).astype(np.float32)
    return v, rng.integers(-span, span + 1, (q, d)).astype(np.float32)


def _filtered_oracle(vecs, queries, mask, k):
    d2 = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    d2 = np.where(mask[None, :], d2, np.inf)
    pos = np.argsort(d2, axis=1)[:, :k]
    dd = np.take_along_axis(d2, pos, 1)
    return np.where(np.isfinite(dd), pos, -1), dd


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("kw", [
    dict(k=5, block=1024),
    dict(k=7, block=512, buckets=128, masked=0.4),
    dict(k=100, block=64, buckets=64),  # k wider than the block
    dict(k=3, block=256, masked=0.0),  # every row masked
    dict(k=4, block=256, buckets=128, oversample=8, masked=0.05),
])
def test_integer_data_equals_jax(precise, kw):
    kw = dict(kw)
    v, q = _ints(11, 3000, 16)
    frac = kw.pop("masked", None)
    if frac is not None:
        kw["row_mask"] = np.random.default_rng(12).random(3000) < frac
    want = jax_scan_knn(v, q, precise=precise, **kw)
    got = scan_knn(_cpu(v), q, precise=precise, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("precise", [True, False])
def test_row_mask_matches_filtered_oracle(precise):
    vecs = datasets.random_uniform(3000, 8, seed=180)
    queries = datasets.random_uniform(16, 8, seed=181)
    mask = np.random.RandomState(182).rand(3000) < 0.3
    want_r, want_d = _filtered_oracle(vecs, queries, mask, 5)
    rows, d2 = scan_knn(_cpu(vecs), queries, k=5, precise=precise,
                        row_mask=mask, block=1024)
    rows, d2 = rows.numpy(), d2.numpy()
    for i in range(16):
        assert set(rows[i].tolist()) == set(want_r[i].tolist())
    np.testing.assert_allclose(np.sort(d2, 1), np.sort(want_d, 1),
                               rtol=1e-4, atol=1e-5)
    assert not np.isin(rows[rows >= 0], np.nonzero(~mask)[0]).any()


def test_precise_float_data_matches_oracle_and_jax():
    vecs = datasets.random_uniform(5000, 16, seed=100)
    queries = datasets.random_uniform(8, 16, seed=101)
    rows, d2 = scan_knn(_cpu(vecs), queries, k=10, block=1024, precise=True)
    erows, ed2 = exact_knn(_cpu(vecs), queries, k=10)
    jrows, _ = jax_scan_knn(vecs, queries, k=10, block=1024, precise=True)
    np.testing.assert_allclose(np.sort(d2.numpy(), 1),
                               np.sort(ed2.numpy(), 1), rtol=1e-4, atol=1e-5)
    for i in range(8):
        got = set(rows[i].tolist())
        assert got == set(erows[i].tolist())
        assert got == set(np.asarray(jrows)[i].tolist())


def test_selective_mask_and_bucket_collision():
    """A 0.3% allowlist rides the scan; two allowed rows in one (block,
    bucket) both come back in precise mode."""
    vecs = datasets.random_uniform(4000, 6, seed=183)
    queries = datasets.random_uniform(4, 6, seed=184)
    mask = np.zeros(4000, bool)
    mask[[5, 1999, 3777]] = True
    rows, _ = scan_knn(_cpu(vecs), queries, k=3, row_mask=mask, block=512,
                       precise=True)
    for i in range(4):
        assert set(rows[i].tolist()) == {5, 1999, 3777}
    pair = np.zeros(4000, bool)
    pair[[5, 261]] = True  # columns 5 and 261 share bucket 5 of block 0
    rows, _ = scan_knn(_cpu(vecs), vecs[[5]], k=2, row_mask=pair, block=512,
                       buckets=256, precise=True)
    assert set(rows[0].tolist()) == {5, 261}


def test_similarity_sorted_layout_and_separated_recall():
    """Interleaved buckets keep a cluster-contiguous layout from
    collapsing to one candidate; on well separated data the f32 rerank
    of the bucketed shortlist equals the exact answer."""
    rng = np.random.default_rng(120)
    centers = (rng.random((16, 16)) * 2 - 1).astype(np.float32)
    vecs = np.concatenate([c + rng.normal(0, 0.1, (256, 16)).astype(
        np.float32) for c in centers])
    rows, _ = scan_knn(_cpu(vecs), centers[:4], k=10, block=1024, buckets=128,
                       oversample=16)
    erows, _ = exact_knn(_cpu(vecs), centers[:4], k=10)
    for i in range(4):
        assert len(set(rows[i].tolist()) & set(erows[i].tolist())) >= 8
    rng = np.random.default_rng(105)
    centers = (rng.random((20, 32)) * 2 - 1).astype(np.float32)
    vecs = np.concatenate([c + rng.normal(0, 0.01, (50, 32)).astype(
        np.float32) for c in centers])
    rows, d2 = scan_knn(_cpu(vecs), centers[:4], k=10, block=256, oversample=8)
    erows, ed2 = exact_knn(_cpu(vecs), centers[:4], k=10)
    for i in range(4):
        assert set(rows[i].tolist()) == set(erows[i].tolist())
    np.testing.assert_allclose(d2[0].numpy(), ed2[0].numpy(), rtol=1e-3,
                               atol=1e-5)


def test_padding_small_n_and_errors():
    vecs = datasets.random_uniform(1037, 8, seed=102)  # not block-aligned
    rows, d2 = scan_knn(_cpu(vecs), vecs[[3, 999]], k=1, block=256,
                        precise=True)
    assert rows[:, 0].tolist() == [3, 999]
    assert (rows < 1037).all()
    np.testing.assert_allclose(d2[:, 0].numpy(), 0.0, atol=1e-5)
    # n <= k: the shortlist is the result set, still f32-reranked
    rng = np.random.RandomState(77)
    v = rng.rand(6, 16).astype(np.float32) * 2 - 1
    q = rng.rand(3, 16).astype(np.float32) * 2 - 1
    rows, d2 = scan_knn(_cpu(v), q, k=10)
    rows, d2 = rows.numpy(), d2.numpy()
    for i in range(3):
        got = rows[i][rows[i] >= 0]
        assert got.size == 6 and (rows[i][6:] == -1).all()
        np.testing.assert_allclose(d2[i][:6], ((v[got] - q[i]) ** 2).sum(1),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="row_mask"):
        scan_knn(_cpu(vecs), vecs[:2], k=2, row_mask=np.ones(1036, bool))
    with pytest.raises(ValueError, match="multiple of buckets"):
        scan_knn(_cpu(vecs), vecs[:2], k=2, block=300, buckets=256)
