"""ChunkedIndex of vector_database_tpu_torch against the JAX package's.

The tests of ``tests/test_out_of_core.py`` on the port (``device="cpu"``,
where the scan kernel's plain version runs), then parity with the JAX
``ChunkedIndex`` (Pallas in interpret mode) on the same chunks: on
integer-valued data both trees and packs are equal, so every ``knn`` mode
gives the same distances bit for bit and the same ids up to the order of
equal distances (the JAX cross-chunk merge sorts unstably, the port's
stably); on float data both are held to the exact oracle (distances rtol
1e-4, atol 1e-5: f32 sums in another order). A directory written by the
JAX ``save`` loads in the port and serves the JAX ids.
"""

import json
import os

import numpy as np
import pytest
import torch

from vector_database_tpu.out_of_core import ChunkedIndex as JaxChunkedIndex
from vector_database_tpu_torch import ChunkedIndex, NativeVectorStore
from vector_database_tpu_torch import out_of_core as ooc
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)

CPU = dict(device="cpu")


def _exact(vecs, queries, k):
    """numpy oracle: ``(ids, sq_dists)`` of the k nearest rows."""
    d2 = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d2, ids, 1)


def _sets(a):
    return [set(r.tolist()) for r in np.asarray(a)]


def build_chunked(n=2200, d=8, chunk=500, seed=140, leaf_size=4):
    vecs = datasets.random_uniform(n, d, seed=seed)
    index = ChunkedIndex(leaf_size=leaf_size, **CPU)
    for start in range(0, n, chunk):
        index.add_chunk(vecs[start:start + chunk])
    return index, vecs


def _clustered(rng, n, d=8, centers=16, sort=False):
    c = rng.rand(centers, d).astype(np.float32) * 2 - 1
    pick = rng.randint(0, centers, size=n)
    pick = np.sort(pick) if sort else pick
    return (c[pick] + 0.05 * rng.randn(n, d)).astype(np.float32), c


# --- the tests of tests/test_out_of_core.py, on the port --------------------

def test_knn_matches_exact():
    index, vecs = build_chunked()
    assert len(index) == 2200 and index.num_chunks == 5
    queries = vecs[[3, 700, 2199]]
    rows, d2 = index.knn(queries, k=5, oversample=16)
    _, ed2 = _exact(vecs, queries, 5)
    assert (rows[:, 0] == np.array([3, 700, 2199])).all()
    np.testing.assert_allclose(np.sort(d2, 1), ed2, rtol=1e-3, atol=1e-5)


def test_radius_search_matches_oracle():
    index, vecs = build_chunked(n=1200, chunk=400)
    queries = datasets.random_uniform(4, 8, seed=141)
    results = index.search(queries, 0.5)
    d2 = ((queries[:, None, :] - vecs[None]) ** 2).sum(-1)
    for qi in range(4):
        assert set(results[qi][0].tolist()) == \
            set(np.nonzero(d2[qi] <= 0.25)[0].tolist())


def test_from_store_and_persistence(tmp_path):
    vecs = datasets.random_uniform(900, 6, seed=142)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        index = ChunkedIndex.from_store(store, chunk_rows=300, leaf_size=4,
                                        **CPU)
    assert index.num_chunks == 3
    path = str(tmp_path / "idx")
    index.save(path)
    loaded = ChunkedIndex.load(path, **CPU)
    assert len(loaded) == 900
    q = vecs[[17]]
    a = loaded.search(q, 0.4)[0]
    b = index.search(q, 0.4)[0]
    assert set(a[0].tolist()) == set(b[0].tolist())
    want = np.nonzero(((vecs - q) ** 2).sum(1) <= 0.16)[0]
    assert set(a[0].tolist()) == set(want.tolist())


def test_dim_mismatch():
    index = ChunkedIndex(**CPU)
    index.add_chunk(np.zeros((10, 4), np.float32))
    with pytest.raises(ValueError):
        index.add_chunk(np.zeros((10, 5), np.float32))


def test_spill_dir(tmp_path):
    vecs = datasets.random_uniform(3000, 8, seed=55)
    ci = ChunkedIndex(leaf_size=8, spill_dir=str(tmp_path / "spill"), **CPU)
    for i in range(0, 3000, 1000):
        ci.add_chunk(vecs[i:i + 1000])
    assert len(os.listdir(tmp_path / "spill")) == 6  # vectors + vb each
    assert isinstance(ci._chunks[0]["vectors"], np.memmap)
    assert isinstance(ci._chunks[0]["vb"], np.memmap)
    _, d2 = ci.knn(vecs[:8], k=5)
    _, ed2 = _exact(vecs, vecs[:8], 5)
    np.testing.assert_allclose(np.sort(d2, 1), ed2, rtol=1e-4, atol=1e-5)


def test_spilled_save_load_roundtrip(tmp_path):
    """A spilled index saves, reloads and serves under the O(node-tables)
    RAM bound: big arrays stream to .npy on save and come back
    memory-mapped on load."""
    vecs = datasets.random_uniform(1700, 8, seed=56)
    ci = ChunkedIndex(leaf_size=8, spill_dir=str(tmp_path / "spill"), **CPU)
    for i in range(0, 1700, 700):  # ragged final chunk on purpose
        ci.add_chunk(vecs[i:i + 700])
    path = str(tmp_path / "saved")
    ci.save(path)
    loaded = ChunkedIndex.load(path, **CPU)
    assert len(loaded) == 1700
    assert isinstance(loaded._chunks[0]["vectors"], np.memmap)
    assert isinstance(loaded._chunks[0]["vb"], np.memmap)
    rows, d2 = loaded.knn(vecs[[5, 900, 1699]], k=3)
    assert rows[:, 0].tolist() == [5, 900, 1699]
    _, ed2 = _exact(vecs, vecs[[5, 900, 1699]], 3)
    np.testing.assert_allclose(np.sort(d2, 1), ed2, rtol=1e-4, atol=1e-5)
    a = loaded.search(vecs[[42]], 0.4)[0]
    b = ci.search(vecs[[42]], 0.4)[0]
    assert set(a[0].tolist()) == set(b[0].tolist())


def test_uniform_shape_across_ragged_chunks():
    """Chunks pad to the first chunk's capacity: a ragged final chunk has
    the full chunks' shapes."""
    vecs = datasets.random_uniform(1100, 8, seed=57)
    ci = ChunkedIndex(leaf_size=8, **CPU)
    ci.add_chunk(vecs[:500])
    ci.add_chunk(vecs[500:1000])
    ci.add_chunk(vecs[1000:])  # 100 rows, padded to 500
    assert {c["cap"] for c in ci._chunks} == {500}
    assert {c["vb"].shape for c in ci._chunks} == {ci._chunks[0]["vb"].shape}
    rows, d2 = ci.knn(vecs[[0, 1050]], k=3)
    assert rows[:, 0].tolist() == [0, 1050]
    assert np.allclose(d2[:, 0], 0.0, atol=1e-5)


def test_ip_knn_merges_highest_dots():
    """metric="ip": the cross-chunk merge keeps the HIGHEST dots."""
    rng = np.random.RandomState(61)
    vecs = (rng.rand(600, 8).astype(np.float32) * 2 - 1) * np.linspace(
        0.1, 10.0, 600).astype(np.float32)[:, None]
    index = ChunkedIndex(leaf_size=4, metric="ip", **CPU)
    index.add_chunk(vecs[:300])
    index.add_chunk(vecs[300:])
    q = rng.rand(3, 8).astype(np.float32) * 2 - 1
    rows, dots = index.knn(q, k=5, oversample=16)
    truth = q @ vecs.T
    for i in range(3):
        assert set(rows[i].tolist()) == set(np.argsort(-truth[i])[:5].tolist())
        np.testing.assert_allclose(dots[i], np.sort(truth[i])[::-1][:5],
                                   rtol=1e-3, atol=1e-4)
        assert (np.diff(dots[i]) <= 1e-4).all()  # highest first


def test_ip_ragged_final_chunk():
    """The +inf sentinel rows of a ragged final chunk never win the ip
    rerank (their keys are -inf or NaN)."""
    rng = np.random.RandomState(62)
    vecs = rng.rand(517, 8).astype(np.float32) * 2 - 1
    index = ChunkedIndex(leaf_size=4, metric="ip", **CPU)
    index.add_chunk(vecs[:256])
    index.add_chunk(vecs[256:])
    q = rng.rand(2, 8).astype(np.float32) * 2 - 1
    rows, _ = index.knn(q, k=4, oversample=16)
    truth = q @ vecs.T
    for i in range(2):
        assert (rows[i] >= 0).all()
        assert set(rows[i].tolist()) == set(np.argsort(-truth[i])[:4].tolist())


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_cosine_search_normalizes_queries():
    rng = np.random.RandomState(63)
    vecs = rng.rand(400, 6).astype(np.float32) * 2 - 1
    index = ChunkedIndex(leaf_size=4, metric="cosine", **CPU)
    index.add_chunk(vecs[:200])
    index.add_chunk(vecs[200:])
    q = vecs[[17, 333]]
    unit, qn = _unit(vecs), _unit(q)
    for res in (index.search(q, 0.4), index.search(q * 37.5, 0.4)):
        for i in range(2):
            want = np.nonzero(((unit - qn[i]) ** 2).sum(1) <= 0.16 + 1e-7)[0]
            assert set(res[i][0].tolist()) == set(want.tolist())


METRICS = ["l2", "cosine", "ip"]


@pytest.mark.parametrize(
    "metric,data",
    [(m, "float") for m in METRICS] + [(m, "integer") for m in METRICS],
    ids=METRICS + [f"{m}-integer" for m in METRICS])
def test_host_rerank_matches_device_rerank(metric, data):
    """The candidates-only scan + host f32 rerank agrees with the
    on-device rerank, with a ragged (sentinel-padded) final chunk. Both
    take the best ``k`` by one stable sort of the shortlist's keys, so
    where the keys are exact (integer rows, l2 and ip), rows and scores
    are equal bit for bit, ties at the k-th place included (integer rows
    in a small range tie often). Float keys, and cosine (each rerank
    normalizes the query itself, numpy or torch), are summed in each
    side's own order: rows as sets, scores within f32 rounding."""
    rng = np.random.RandomState(64)
    if data == "float":
        vecs = rng.rand(517, 8).astype(np.float32) * 2 - 1
        q = rng.rand(5, 8).astype(np.float32) * 2 - 1
    else:
        vecs = rng.randint(-3, 4, (517, 8)).astype(np.float32)
        q = rng.randint(-3, 4, (5, 8)).astype(np.float32)
    ci = ChunkedIndex(leaf_size=4, metric=metric, **CPU)
    ci.add_chunk(vecs[:256])
    ci.add_chunk(vecs[256:])
    rh, dh = ci.knn(q, k=6, oversample=16, host_rerank=True)
    rd, dd = ci.knn(q, k=6, oversample=16, host_rerank=False)
    assert (rh >= 0).all() and (rd >= 0).all()
    if data == "integer" and metric != "cosine":
        np.testing.assert_array_equal(rh, rd)
        np.testing.assert_array_equal(dh, dd)
    else:
        assert _sets(rh) == _sets(rd)
        np.testing.assert_allclose(dh, dd, rtol=1e-4, atol=1e-5)


def test_host_rerank_cosine_scaled_queries():
    rng = np.random.RandomState(65)
    vecs = rng.rand(400, 6).astype(np.float32) * 2 - 1
    ci = ChunkedIndex(leaf_size=4, metric="cosine", **CPU)
    ci.add_chunk(vecs[:200])
    ci.add_chunk(vecs[200:])
    q = vecs[[17, 333]]
    r1, d1 = ci.knn(q, k=4)
    r2, d2 = ci.knn(q * 41.0, k=4)
    assert r1.tolist() == r2.tolist()
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-5)
    truth = ((_unit(vecs)[None] - _unit(q)[:, None]) ** 2).sum(-1)
    for i in range(2):
        assert set(r1[i].tolist()) == set(np.argsort(truth[i])[:4].tolist())


def test_host_rerank_k_exceeds_shortlist():
    """k wider than the shortlist pads with -1/inf instead of fabricating
    rows."""
    rng = np.random.RandomState(66)
    vecs = rng.rand(40, 6).astype(np.float32)
    ci = ChunkedIndex(leaf_size=4, buckets=8, block=8, **CPU)
    ci.add_chunk(vecs)
    rows, d2 = ci.knn(vecs[[3]], k=39, oversample=1)
    assert rows[0, 0] == 3 and d2[0, 0] < 1e-6
    got = rows[0][rows[0] >= 0]
    assert len(set(got.tolist())) == len(got)  # no duplicates


def test_pinned_serving_matches_streamed():
    """pin() keeps the packed blocks resident on the device: results equal
    streamed serving bit for bit in both rerank modes, survive
    add_chunk-after-pin, and free on unpin."""
    index, vecs = build_chunked(n=1700, chunk=600)
    q = vecs[[3, 900, 1650]]
    r0, d0 = index.knn(q, k=5)
    r0d, d0d = index.knn(q, k=5, host_rerank=False)
    index.pin()
    r1, d1 = index.knn(q, k=5)
    r1d, d1d = index.knn(q, k=5, host_rerank=False)
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(r1d, r0d)
    np.testing.assert_array_equal(d1d, d0d)
    index.pin()  # idempotent
    extra = vecs[:600] * 0.5 + 2.0
    index.add_chunk(extra)
    r2, _ = index.knn(extra[[7]], k=1)
    assert r2[0, 0] == 1700 + 7
    index.unpin()
    assert index._pinned is None
    r3, _ = index.knn(q, k=5)
    assert (r3[:, 0] == r1[:, 0]).all()


def _pipeline_index():
    vecs, _ = _clustered(np.random.RandomState(77), 4000)
    index = ChunkedIndex(leaf_size=8, block=256, buckets=128, **CPU)
    for lo in range(0, 4000, 1500):
        index.add_chunk(vecs[lo:lo + 1500])
    return index, vecs


def test_pinned_pipeline_matches_sequential(monkeypatch):
    """The capacity-mode pipeline (every chunk's scan and its shortlist's
    copy to the host before any host rerank) equals the sequential
    per-chunk path bit for bit, full and pruned, over 3 chunks.
    ``VDB_PIN_PIPELINE`` is set both ways explicitly."""
    index, vecs = _pipeline_index()
    qs = vecs[:32]
    nb = -(-index._capacity // 256)
    index.pin()
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("VDB_PIN_PIPELINE", flag)
        got[flag] = [index.knn(qs, k=5, q_tile=8),
                     index.knn(qs, k=5, q_tile=8, probes=max(1, nb // 2))]
    for (ra, da), (rb, db) in zip(got["1"], got["0"]):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da, db)
    index.unpin()


def test_pinned_buffers_typed_bf16():
    """The pinned device buffers land already typed bf16 (a uint16 buffer
    would need a per-call conversion that copies every block)."""
    index, _ = build_chunked(n=700, chunk=400)
    index.pin()
    assert len(index._pinned) == index.num_chunks
    for vb, vn in index._pinned:
        assert vb.dtype == torch.bfloat16
        assert vn.dtype == torch.float32
    index.unpin()


def test_add_chunk_over_budget_unpins(monkeypatch):
    """add_chunk on a pinned index whose new chunk exceeds free device
    memory degrades to streamed serving (warn + unpin), and never leaves
    _pinned shorter than _chunks."""
    index, vecs = build_chunked(n=800, chunk=400)
    index.pin()
    monkeypatch.setattr(ooc, "_hbm_budget", lambda device: 0)
    with pytest.warns(UserWarning, match="unpinned"):
        index.add_chunk(vecs[:400] + 3.0)
    assert index._pinned is None
    assert index.num_chunks == 3
    r, _ = index.knn(vecs[[7]] + 3.0, k=1)
    assert r[0, 0] == 800 + 7


def test_pin_over_budget_raises(monkeypatch):
    index, _ = build_chunked(n=800, chunk=400)
    monkeypatch.setattr(ooc, "_hbm_budget", lambda device: ooc._PIN_HEADROOM)
    with pytest.raises(ValueError, match="exceed free device memory"):
        index.pin()
    assert index._pinned is None


def test_ip_search_raises():
    index = ChunkedIndex(metric="ip", **CPU)
    index.add_chunk(np.ones((8, 4), np.float32))
    with pytest.raises(ValueError):
        index.search(np.ones((1, 4), np.float32), 1.0)


def test_from_store_small_store_not_padded(tmp_path):
    vecs = np.random.RandomState(77).rand(50, 8).astype(np.float32)
    with NativeVectorStore.create(str(tmp_path / "s.vstore"), dims=8) as st:
        st.append(vecs)
        index = ChunkedIndex.from_store(st, chunk_rows=100_000, leaf_size=4,
                                        **CPU)
    assert index.num_chunks == 1
    assert index._chunks[0]["cap"] == 50
    rows, _ = index.knn(vecs[:4], k=3)
    assert (rows[:, 0] == np.arange(4)).all()


def test_chunked_knn_probes_roundtrip(tmp_path):
    """probes=nb equals the full scan, the summaries survive save/load,
    and a pinned index serves pruned."""
    index, vecs = _pipeline_index()
    qs = vecs[:32]
    nb = -(-index._capacity // 256)
    r_full, d_full = index.knn(qs, k=5, q_tile=8)
    r_all, d_all = index.knn(qs, k=5, q_tile=8, probes=nb)
    np.testing.assert_array_equal(r_full, r_all)
    np.testing.assert_array_equal(d_full, d_all)
    r_p, _ = index.knn(qs, k=5, q_tile=8, probes=max(1, nb // 2))
    hits = sum(len(a & b) for a, b in zip(_sets(r_p), _sets(r_full)))
    assert hits >= 0.6 * 32 * 5
    index.save(str(tmp_path / "ci"))
    loaded = ChunkedIndex.load(str(tmp_path / "ci"), **CPU)
    r_l, d_l = loaded.knn(qs, k=5, q_tile=8, probes=nb)
    np.testing.assert_array_equal(r_l, r_all)
    np.testing.assert_array_equal(d_l, d_all)
    loaded.pin()
    r_pin, _ = loaded.knn(qs, k=5, q_tile=8, probes=nb)
    np.testing.assert_array_equal(r_pin, r_all)
    loaded.unpin()


class _FailingStore:
    """Row source that dies after yielding ``fail_after`` chunks: a
    mid-build crash for the checkpoint/resume contract."""

    def __init__(self, store, fail_after):
        self._store = store
        self._fail_after = fail_after

    def __len__(self):
        return len(self._store)

    def chunks(self, chunk_rows):
        for i, chunk in enumerate(self._store.chunks(chunk_rows)):
            if i >= self._fail_after:
                raise RuntimeError("injected mid-build crash")
            yield chunk


def test_from_store_checkpoint_resume(tmp_path):
    """Interrupted after chunk 1 of 3 and resumed with the same arguments,
    the build is bit-identical to an uninterrupted one: node tables,
    packed blocks, vectors and answers."""
    vecs = datasets.random_uniform(1100, 6, seed=147)
    ck = str(tmp_path / "ck")
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        with pytest.raises(RuntimeError, match="injected"):
            ChunkedIndex.from_store(_FailingStore(store, 1), chunk_rows=400,
                                    leaf_size=4, checkpoint_dir=ck, **CPU)
        with open(os.path.join(ck, "resume.json")) as f:
            assert json.load(f)["chunks_done"] == 1
        resumed = ChunkedIndex.from_store(store, chunk_rows=400, leaf_size=4,
                                          checkpoint_dir=ck, **CPU)
        fresh = ChunkedIndex.from_store(store, chunk_rows=400, leaf_size=4,
                                        **CPU)
    assert resumed.num_chunks == fresh.num_chunks == 3
    assert len(resumed) == 1100
    for cr, cf in zip(resumed._chunks, fresh._chunks):
        for key in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                    "orig_row", "vn", "vb", "vectors", "cent", "rad"):
            np.testing.assert_array_equal(np.asarray(cr[key]),
                                          np.asarray(cf[key]), err_msg=key)
    q = vecs[[3, 512, 1050]]
    rows_r, d_r = resumed.knn(q, k=5)
    rows_f, d_f = fresh.knn(q, k=5)
    np.testing.assert_array_equal(rows_r, rows_f)
    np.testing.assert_array_equal(d_r, d_f)
    rows_l, _ = ChunkedIndex.load(ck, **CPU).knn(q, k=5)
    np.testing.assert_array_equal(rows_l, rows_f)


def test_from_store_checkpoint_param_mismatch(tmp_path):
    vecs = datasets.random_uniform(500, 6, seed=148)
    ck = str(tmp_path / "ck")
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        ChunkedIndex.from_store(store, chunk_rows=250, leaf_size=4,
                                checkpoint_dir=ck, **CPU)
        with pytest.raises(ValueError, match="different"):
            ChunkedIndex.from_store(store, chunk_rows=100, leaf_size=4,
                                    checkpoint_dir=ck, **CPU)


def test_from_store_completed_checkpoint_is_noop(tmp_path):
    vecs = datasets.random_uniform(600, 6, seed=149)
    ck = str(tmp_path / "ck")
    with NativeVectorStore.create(str(tmp_path / "v"), dims=6) as store:
        store.append(vecs)
        a = ChunkedIndex.from_store(store, chunk_rows=200, leaf_size=4,
                                    checkpoint_dir=ck, **CPU)
        b = ChunkedIndex.from_store(store, chunk_rows=200, leaf_size=4,
                                    checkpoint_dir=ck, **CPU)
    assert b.num_chunks == a.num_chunks
    assert all(getattr(c["vb"], "filename", None) is not None
               for c in b._chunks)
    q = vecs[[7, 300]]
    np.testing.assert_array_equal(a.knn(q, k=4)[0], b.knn(q, k=4)[0])


def test_chunked_knn_min_probe_batch_guard():
    """Calls with fewer queries than min_probe_batch serve the full scan;
    min_probe_batch without probes raises. The default is None: no
    guard."""
    rng = np.random.RandomState(153)
    vecs, centers = _clustered(rng, 4000, sort=True)
    index = ChunkedIndex(leaf_size=8, block=256, buckets=64, **CPU)
    index.add_chunk(vecs[:2000])
    index.add_chunk(vecs[2000:])
    qs = (centers[rng.randint(0, 16, size=8)]
          + 0.05 * rng.randn(8, 8)).astype(np.float32)
    r_full, d_full = index.knn(qs, k=5, q_tile=8)
    r_g, d_g = index.knn(qs, k=5, q_tile=8, probes=1, min_probe_batch=64)
    np.testing.assert_array_equal(r_g, r_full)
    np.testing.assert_array_equal(d_g, d_full)
    r_p, _ = index.knn(qs, k=5, q_tile=8, probes=1, min_probe_batch=8)
    assert not np.array_equal(r_p, r_full)
    r_d, _ = index.knn(qs, k=5, q_tile=8, probes=1)
    np.testing.assert_array_equal(r_d, r_p)
    with pytest.raises(ValueError, match="min_probe_batch"):
        index.knn(qs, k=5, q_tile=8, min_probe_batch=8)


def test_from_store_checkpoint_data_mismatch(tmp_path):
    """Resuming a checkpoint against DIFFERENT data raises: a same-length
    store with other content trips the fingerprint, a grown store the
    recorded length."""
    vecs_a = datasets.random_uniform(800, 6, seed=154)
    vecs_b = datasets.random_uniform(800, 6, seed=155)
    ck = str(tmp_path / "ck")
    with NativeVectorStore.create(str(tmp_path / "a"), dims=6) as sa, \
            NativeVectorStore.create(str(tmp_path / "b"), dims=6) as sb, \
            NativeVectorStore.create(str(tmp_path / "c"), dims=6) as sc:
        sa.append(vecs_a)
        sb.append(vecs_b)
        sc.append(vecs_a)
        sc.append(vecs_b[:100])
        with pytest.raises(RuntimeError, match="injected"):
            ChunkedIndex.from_store(_FailingStore(sa, 1), chunk_rows=400,
                                    leaf_size=4, checkpoint_dir=ck, **CPU)
        with pytest.raises(ValueError, match="fingerprint"):
            ChunkedIndex.from_store(sb, chunk_rows=400, leaf_size=4,
                                    checkpoint_dir=ck, **CPU)
        with pytest.raises(ValueError, match="rows"):
            ChunkedIndex.from_store(sc, chunk_rows=400, leaf_size=4,
                                    checkpoint_dir=ck, **CPU)
        done = ChunkedIndex.from_store(sa, chunk_rows=400, leaf_size=4,
                                       checkpoint_dir=ck, **CPU)
    assert len(done) == 800


# --- parity with the JAX ChunkedIndex -------------------------------------

def _same_up_to_ties(got, want, what):
    """Distances bitwise equal; ids equal except in order among equal
    distances (the JAX merge's sort is unstable), and each tie group at
    the k-th place drawn from the same distance."""
    (gr, gd), (wr, wd) = got, want
    np.testing.assert_array_equal(gd, wd, err_msg=str(what))
    for i in range(gr.shape[0]):
        for value in np.unique(wd[i]):
            at = wd[i] == value
            if value == wd[i, -1]:
                assert at.sum() == (gd[i] == value).sum(), what
            else:
                assert set(gr[i][at].tolist()) == set(wr[i][at].tolist()), \
                    (what, i)


@pytest.fixture(scope="module")
def int_pair():
    """Integer-valued clustered rows in 3 chunks (a ragged third), block
    256 and 128 buckets (2 rows a bucket), built by both packages."""
    rng = np.random.default_rng(7)
    centers = rng.integers(-20, 21, (12, 8))
    vecs = (centers[rng.integers(0, 12, 1300)]
            + rng.integers(-3, 4, (1300, 8))).astype(np.float32)
    queries = (centers[rng.integers(0, 12, 24)]
               + rng.integers(-3, 4, (24, 8))).astype(np.float32)
    kw = dict(leaf_size=8, block=256, buckets=128)
    j = JaxChunkedIndex(**kw)
    t = ChunkedIndex(**kw, **CPU)
    for lo in range(0, 1300, 500):
        j.add_chunk(vecs[lo:lo + 500])
        t.add_chunk(vecs[lo:lo + 500])
    return j, t, vecs, queries


def test_chunks_equal_jax_on_integer_data(int_pair):
    j, t, _, _ = int_pair
    assert t._offsets == j._offsets and len(t) == len(j)
    for ct, cj in zip(t._chunks, j._chunks):
        for key in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                    "orig_row", "vectors", "vb", "vn", "cent", "rad"):
            np.testing.assert_array_equal(ct[key], np.asarray(cj[key]),
                                          err_msg=key)
        for key in ("depth", "leaf_cap", "num_leaves", "cap", "n_real",
                    "bits"):
            assert ct[key] == cj[key], key


MODES = [dict(), dict(host_rerank=False), dict(probes=1, q_tile=8),
         dict(probes=1, q_tile=8, host_rerank=False),
         dict(probes=1, q_tile=8, min_probe_batch=64), dict(oversample=1)]


@pytest.mark.parametrize("pinned", ["streamed", "pipelined", "sequential"])
def test_knn_equals_jax_on_integer_data(int_pair, monkeypatch, pinned):
    j, t, _, queries = int_pair
    want = [j.knn(queries, k=6, **mode) for mode in MODES]
    if pinned != "streamed":
        monkeypatch.setenv("VDB_PIN_PIPELINE",
                           "1" if pinned == "pipelined" else "0")
        t.pin()
    try:
        for mode, w in zip(MODES, want):
            _same_up_to_ties(t.knn(queries, k=6, **mode), w, mode)
    finally:
        t.unpin()


def test_search_equals_jax(int_pair):
    j, t, vecs, queries = int_pair
    for (tr, td), (jr, jd) in zip(t.search(queries, 4.0),
                                  j.search(queries, 4.0)):
        assert sorted(zip(tr.tolist(), td.tolist())) == \
            sorted(zip(jr.tolist(), jd.tolist()))


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_float_knn_and_search_match_jax(metric):
    """Float data: both packages equal the exact oracle's result sets
    (distances rtol 1e-4, atol 1e-5); search result sets are equal."""
    rng = np.random.RandomState(90)
    vecs = rng.rand(900, 8).astype(np.float32) * 2 - 1
    q = rng.rand(6, 8).astype(np.float32) * 2 - 1
    j = JaxChunkedIndex(leaf_size=4, metric=metric)
    t = ChunkedIndex(leaf_size=4, metric=metric, **CPU)
    for lo in range(0, 900, 400):
        j.add_chunk(vecs[lo:lo + 400])
        t.add_chunk(vecs[lo:lo + 400])
    tr, td = t.knn(q, k=5, oversample=16)
    jr, jd = j.knn(q, k=5, oversample=16)
    assert _sets(tr) == _sets(jr)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
    if metric == "ip":
        assert _sets(tr) == _sets(np.argsort(-(q @ vecs.T), 1)[:, :5])
        return
    base = _unit(vecs) if metric == "cosine" else vecs
    qq = _unit(q) if metric == "cosine" else q
    ids, ed2 = _exact(base, qq, 5)
    assert _sets(tr) == _sets(ids)
    np.testing.assert_allclose(td, ed2, rtol=1e-4, atol=1e-5)
    for (a, _), (b, _) in zip(t.search(q, 0.6), j.search(q, 0.6)):
        assert set(a.tolist()) == set(b.tolist())


def test_jax_save_loads_in_port(tmp_path, int_pair):
    """A directory written by the JAX ``save`` loads in the port (bf16
    blocks as their uint16 bits, memory-mapped) and serves the JAX ids,
    streamed and pinned; the port's ``save`` of it loads back in JAX."""
    j, _, vecs, queries = int_pair
    path = str(tmp_path / "jax")
    j.save(path)
    t = ChunkedIndex.load(path, **CPU)
    assert isinstance(t._chunks[0]["vb"], np.memmap)
    for mode in MODES[:3]:
        want = j.knn(queries, k=6, **mode)
        _same_up_to_ties(t.knn(queries, k=6, **mode), want, mode)
        t.pin()
        _same_up_to_ties(t.knn(queries, k=6, **mode), want, mode)
        t.unpin()
    back = str(tmp_path / "port")
    t.save(back)
    _same_up_to_ties(JaxChunkedIndex.load(back).knn(queries, k=6),
                     j.knn(queries, k=6), "port save -> JAX load")


def test_cross_chunk_merge_is_stable():
    """Equal distances across chunks keep the earlier chunk's row first
    (the reference's merge sorts unstably, ``out_of_core.py:561``): two
    chunks holding the same rows answer a stored row with its copy in
    chunk 0 first, then chunk 1's."""
    vecs = datasets.random_uniform(300, 6, seed=91)
    index = ChunkedIndex(leaf_size=4, **CPU)
    index.add_chunk(vecs)
    index.add_chunk(vecs)
    rows, d2 = index.knn(vecs[[5, 250]], k=2, oversample=16)
    assert rows.tolist() == [[5, 305], [250, 550]]
    assert (d2 == 0).all()
    # and the merge alone, on a row of ties in both the running and the
    # new chunk's lists, keeps the running list's order, then the new one's
    c = {"orig_row": np.arange(4, dtype=np.int32)}
    best_d = np.array([[1.0, 1.0, 2.0]], np.float32)
    best_r = np.array([[7, 3, 9]], np.int64)
    d, r = ChunkedIndex._merge_chunk(
        best_d, best_r, np.array([[2, 0, 1]]),
        np.array([[1.0, 1.0, 1.0]], np.float32), c, 100, 5, False, np.inf)
    assert r.tolist() == [[7, 3, 102, 100, 101]]
    assert d.tolist() == [[1.0] * 5]
