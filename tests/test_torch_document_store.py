"""DocumentStore of vector_database_tpu_torch against the JAX package.

The same workflow (create documents, add texts, index, search, batched
k-NN in every mode, adds served from the delta, save/load) runs step by
step through both packages. On integer-valued data every distance and
tree plane is exact, so the trees are bitwise equal and results must be
equal: k-NN arrays exactly where the JAX package sorts stably, and as
sets per query where JAX's delta merge sorts unstably (its ``argsort``
without ``kind``: equal distances may come in another order). Float-data
cases are held to brute force.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu.document_store import DocumentStore as JaxStore
from vector_database_tpu_torch import DocumentStore
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)


def _fill(store, vecs, docs=3):
    ids = [store.create_document(f"d{i}") for i in range(docs)]
    for i, v in enumerate(vecs):
        store.add_text(ids[i % docs], v, text=f"t{i}")
    return ids


def _equal(got, want, what):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(what))


def _same_sets(got, want):
    """Per-query equal (doc, text) sets and equal sorted distances."""
    (gd, gt, g2), (wd, wt, w2) = got, want
    for i in range(gd.shape[0]):
        assert set(zip(gd[i].tolist(), gt[i].tolist())) == \
            set(zip(wd[i].tolist(), wt[i].tolist()))
    np.testing.assert_array_equal(np.sort(g2, 1), np.sort(w2, 1))


def test_workflow_matches_jax():
    rng = np.random.default_rng(6)
    v = rng.integers(-5, 6, (900, 6)).astype(np.float32)
    q = rng.integers(-5, 6, (16, 6)).astype(np.float32)
    j, t = JaxStore(leaf_size=4), DocumentStore(leaf_size=4, device="cpu")
    _fill(j, v)
    _fill(t, v)
    j.index_document(1)
    t.index_document(1)
    for kw in (dict(doc_id=1), dict()):
        assert sorted(t.search(q[0], 3.0, **kw)) == \
            sorted(j.search(q[0], 3.0, **kw))
    # the raw candidate superset carries nan distances: compare the rows
    raw = dict(doc_id=2, exact=False)
    assert sorted(r[:2] for r in t.search(q[0], 3.0, **raw)) == \
        sorted(r[:2] for r in j.search(q[0], 3.0, **raw))
    modes = [dict(), dict(exact=False), dict(packed=True), dict(doc_id=2),
             dict(packed=True, probes=1, q_tile=8)]
    for mode in modes:
        _equal(t.knn_batch(q, 4, **mode), j.knn_batch(q, 4, **mode), mode)
    for doc_id in (None, 3):
        got = t.search_batch(q, 3.0, doc_id=doc_id)
        want = j.search_batch(q, 3.0, doc_id=doc_id)
        assert [sorted(x) for x in got] == [sorted(x) for x in want]
    assert t.combined_builds == j.combined_builds == 1

    # adds land in the delta: no rebuild, merged exactly on top
    for s in (j, t):
        s.add_text(1, q[0] + 0.5)
        s.add_text(3, q[1])
    for mode in [dict(), dict(packed=True), dict(doc_id=3)]:
        _same_sets(t.knn_batch(q, 4, **mode), j.knn_batch(q, 4, **mode))
    got = t.search_batch(q, 3.0, doc_id=1)
    want = j.search_batch(q, 3.0, doc_id=1)
    assert [sorted(x) for x in got] == [sorted(x) for x in want]
    assert t.combined_builds == j.combined_builds == 1
    docs, texts, d2 = t.knn_batch(q[1:2], 1)
    assert docs[0, 0] == 3 and d2[0, 0] == 0.0

    # past the delta threshold (max(64, rows // 4)) the next call rebuilds
    for i in range(240):
        for s in (j, t):
            s.add_text(2, np.full(6, 0.25 * (i % 9), np.float32))
    _same_sets(t.knn_batch(q, 4), j.knn_batch(q, 4))
    assert t.combined_builds == j.combined_builds == 2
    t.delete_document(2)
    j.delete_document(2)
    _equal(t.knn_batch(q, 4), j.knn_batch(q, 4), "after delete")


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_saved_store_serves_the_same_answers(tmp_path, direction):
    rng = np.random.default_rng(8)
    v = rng.integers(-4, 5, (300, 8)).astype(np.float32)
    q = rng.integers(-4, 5, (10, 8)).astype(np.float32)
    cpu = dict(device="cpu")
    src_cls, dst_cls, src_kw, dst_kw = (
        (JaxStore, DocumentStore, {}, cpu) if direction == "jax_to_torch"
        else (DocumentStore, JaxStore, cpu, {}))
    src = src_cls(leaf_size=4, **src_kw)
    docs = _fill(src, v, docs=2)
    src.index_document(docs[0])  # doc 2 stays dirty: no index saved
    src.save(str(tmp_path / "store"))
    dst = dst_cls.load(str(tmp_path / "store"), **dst_kw)
    assert dst._dims == (8,) and dst.documents == src.documents
    assert dst.get_text(docs[0], 5)[0] == src.get_text(docs[0], 5)[0]
    assert sorted(dst.search(q[0], 3.0, auto_index=False)) == \
        sorted(src.search(q[0], 3.0, auto_index=False))
    assert sorted(dst.search(q[0], 3.0)) == sorted(src.search(q[0], 3.0))
    for mode in (dict(), dict(packed=True), dict(doc_id=docs[1])):
        _equal(dst.knn_batch(q, 5, **mode), src.knn_batch(q, 5, **mode),
               mode)


def test_float_data_against_brute_force():
    store = DocumentStore(leaf_size=4, device="cpu")
    vecs = datasets.random_uniform(600, 8, seed=50)
    docs = _fill(store, vecs, docs=2)
    point = vecs[5]
    got = {t for _, t, _ in store.search(point, 0.5, doc_id=docs[1])}
    d2 = ((vecs - point) ** 2).sum(1)
    want = {i + 1 for i in np.nonzero(d2 <= 0.25)[0] if i % 2 == 1}
    assert got == want
    cand = {t for _, t, _ in store.search(point, 0.5, doc_id=docs[1],
                                          exact=False)}
    assert got <= cand  # the candidate-superset contract
    queries = datasets.random_uniform(8, 8, seed=51)
    hits = store.search_batch(queries, 0.6)
    for i, q in enumerate(queries):
        d2 = ((vecs - q) ** 2).sum(1)
        assert {t for _, t, _ in hits[i]} == \
            {r + 1 for r in np.nonzero(d2 <= 0.36)[0]}
    _, texts, d2k = store.knn_batch(queries, 5)
    for i, q in enumerate(queries):
        order = np.argsort(((vecs - q) ** 2).sum(1))[:5]
        assert set(texts[i].tolist()) == set((order + 1).tolist())
    _, ptexts, pd2 = store.knn_batch(queries, 5, packed=True)
    np.testing.assert_allclose(np.sort(pd2, 1), np.sort(d2k, 1), rtol=1e-4,
                               atol=1e-5)


def test_doc_slices_and_documents_in_the_delta():
    """The per-document slice cache stays LRU-bounded and serves right
    after evictions; a document created after the combined build is
    served from the delta alone."""
    store = DocumentStore(leaf_size=4, device="cpu")
    docs = []
    for i in range(6):
        doc = store.create_document(f"d{i}")
        vecs = datasets.random_uniform(20, 4, seed=60 + i)
        for v in vecs:
            store.add_text(doc, v)
        docs.append((doc, vecs))
    q = np.zeros((2, 4), np.float32)
    for doc, _ in docs:
        store.knn_batch(q, k=3, doc_id=doc)
    assert len(store._doc_slice) <= store._doc_slice_cap
    for doc, vecs in docs:
        ids, _, d2 = store.knn_batch(vecs[[7]], k=1, doc_id=doc)
        assert ids[0, 0] == doc and d2[0, 0] < 1e-6
    late = store.create_document("late")
    tid = store.add_text(late, [9.0, 9.0, 9.0, 9.0])
    d, t, d2 = store.knn_batch([[9.1, 9.0, 9.0, 9.0]], k=3, doc_id=late)
    assert d[0, 0] == late and t[0, 0] == tid
    assert abs(d2[0, 0] - 0.01) < 1e-5 and (d[0, 1:] == -1).all()


def test_errors_and_edges():
    store = DocumentStore(device="cpu")
    a = store.create_document("a")
    store.add_text(a, [1.0, 2.0, 3.0])
    b = store.create_document("b")
    with pytest.raises(ValueError):
        store.add_text(b, [1.0, 2.0])  # store-wide width check
    with pytest.raises(ValueError):
        store.knn_batch([[0.0, 0.0, 0.0]], k=2, doc_id=a, packed=True)
    with pytest.raises(ValueError, match="exact=True"):
        store.knn_batch([[0.0, 0.0, 0.0]], k=2, packed=True, exact=True)
    with pytest.raises(ValueError, match="min_probe_batch"):
        store.knn_batch([[0.0, 0.0, 0.0]], k=2, packed=True,
                        min_probe_batch=4)
    empty = store.create_document("empty")
    store.index_document(empty)
    assert store.search(np.zeros(3), 1.0, doc_id=empty) == []
    store.delete_document(a)
    store.delete_document(b)
    store.delete_document(empty)
    c = store.create_document("c")
    store.add_text(c, np.ones(5, np.float32))  # an emptied store resets
    assert store._dims == (5,)


def test_min_probe_batch_guard():
    vecs = datasets.random_uniform(600, 10, seed=502)
    store = DocumentStore(device="cpu")
    doc = store.create_document("d")
    for i, v in enumerate(vecs):
        store.add_text(doc, v, text_id=2000 + i)
    q = datasets.random_uniform(16, 10, seed=503)
    full = store.knn_batch(q, k=4, packed=True)
    guarded = store.knn_batch(q, k=4, packed=True, probes=1,
                              min_probe_batch=64)
    _equal(guarded, full, "guarded")
    assert store._packed_store[1] is not None
