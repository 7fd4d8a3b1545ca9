"""MemoryVectorIndex of vector_database_tpu_torch against the JAX package's.

The trie is host code in both packages: the same records give the same
node table and buckets, and every query the same records. ``find_batch``
(the exact scan) and ``to_bsp`` (the export searched by the tree walk) run
on the CPU device here and are held to the JAX package's answers and to a
numpy oracle; distances are exact on these grids and inclusive at the
boundary as ``exact_ball`` is.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu import MemoryVectorIndex as JaxMemoryVectorIndex
from vector_database_tpu import search as jax_search
from vector_database_tpu_torch import MemoryVectorIndex, locate, search
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)

CPU = dict(device="cpu")


def _pair(records, **kw):
    return (MemoryVectorIndex(records, **kw, **CPU),
            JaxMemoryVectorIndex(records, **kw))


def _key(r):
    return tuple(np.asarray(r["vector"] if isinstance(r, dict) else r))


def run_case(vectors, point, distance, threshold=10):
    records = [{"id": i, "vector": vectors[i]}
               for i in range(vectors.shape[0])]
    t, j = _pair(records, vector_selector=lambda r: r["vector"],
                 list_threshold=threshold)
    assert len(t) == len(j) == len(records)
    assert t._entries == j._entries
    point = np.asarray(point, np.float32)
    truth = {r["id"] for r in records
             if float(np.sqrt(np.sum((r["vector"] - point) ** 2))) <= distance}
    calls = {"t": 0, "j": 0}

    def predicate(side):
        def check(record, q):
            calls[side] += 1
            return float(np.sqrt(np.sum((record["vector"] - q) ** 2))) \
                <= distance
        return check

    got = {r["id"] for r in t.find(point, distance, predicate("t"))}
    want = {r["id"] for r in j.find(point, distance, predicate("j"))}
    assert got == want == truth, (got - truth, truth - got)
    assert calls["t"] == calls["j"]
    return t, calls["t"]


@pytest.mark.parametrize("vecs,point,distance", [
    (np.array([[i - 1, j - 1] for i in range(3) for j in range(3)],
              np.float32), [0.5, 0.9], 0.6),
    (datasets.grid2d(10), [0.3, 0.3], 0.3),
    (datasets.grid2d_not_normalized(100), [0.3, 0.3], 0.3),
])
def test_find_matches_jax_and_oracle(vecs, point, distance):
    run_case(vecs, point, distance)


def test_100x100_selectivity():
    _, calls = run_case(datasets.grid2d(100), [0.3, 0.3], 0.1)
    assert calls < 10000 // 4


def test_default_predicate_is_exact():
    vecs = datasets.grid2d(10)
    t, j = _pair(list(vecs))
    got = {_key(v) for v in t.find([0.3, 0.3], 0.3)}
    assert got == {_key(v) for v in j.find([0.3, 0.3], 0.3)}
    want = {tuple(v) for v in vecs
            if float(np.sqrt(np.sum((v - np.array([0.3, 0.3])) ** 2))) <= 0.3}
    assert got == want


def test_remove_and_add_cycles_match_jax():
    vecs = datasets.grid2d(10)
    t, j = _pair(list(vecs))
    n0 = len(t)
    removed = t.remove([0.3, 0.3], 0.3)
    assert removed == j.remove([0.3, 0.3], 0.3) > 0
    assert len(t) == len(j) == n0 - removed
    assert list(t.find([0.3, 0.3], 0.3)) == []
    assert len(list(t.find([0.0, 0.0], 10.0))) == n0 - removed
    assert t._entries == j._entries
    rng = np.random.default_rng(3)
    for _ in range(3):
        extra = rng.random((20, 2)).astype(np.float32) * 2 - 1
        for v in extra:
            t.add(v)
            j.add(v)
        point = rng.random(2).astype(np.float32) * 2 - 1
        assert t.remove(point, 0.25) == j.remove(point, 0.25)
        assert t._entries == j._entries and len(t) == len(j)


def test_remove_all_then_add():
    t = MemoryVectorIndex(list(datasets.grid2d(3)), **CPU)
    t.remove([0.0, 0.0], 10.0)
    assert len(t) == 0
    t.add(np.array([0.1, 0.1], np.float32))
    assert len(t) == 1
    assert len(list(t.find([0.1, 0.1], 0.01))) == 1


def test_incremental_add_matches_bulk():
    vecs = datasets.random_uniform(300, 3, seed=21)
    t = MemoryVectorIndex(**CPU)
    for v in vecs:
        t.add(v)
    assert len(t) == 300
    q = vecs[7]
    got = {_key(v) for v in t.find(q, 0.4)}
    want = {tuple(v) for v in vecs
            if float(np.sqrt(np.sum((v - q) ** 2))) <= 0.4}
    assert got == want


def test_duplicates_bad_distribution():
    vecs = [np.array([0.5, 0.5], np.float32)] * 25
    t = MemoryVectorIndex(vecs, list_threshold=10, **CPU)
    assert len(t) == 25
    assert len(list(t.find([0.5, 0.5], 0.0))) == 25


def test_clear_and_invalid_args():
    t = MemoryVectorIndex(list(datasets.grid2d(3)), **CPU)
    t.clear()
    assert len(t) == 0 and list(t.find([0, 0], 1.0)) == []
    with pytest.raises(ValueError):
        MemoryVectorIndex(list_threshold=0, **CPU)
    t = MemoryVectorIndex([np.array([0.1, 0.2], np.float32)], **CPU)
    with pytest.raises(ValueError):
        t.add(np.array([0.1, 0.2, 0.3], np.float32))
    with pytest.raises(ValueError):
        list(t.find([0.1], 0.5))


def test_hierarchy_matches_jax():
    t, j = _pair(list(datasets.grid2d(10)))
    nodes = list(t.index_hierarchy)
    jnodes = list(j.index_hierarchy)
    assert [n[:2] for n in nodes] == [n[:2] for n in jnodes]
    assert len([n for n in nodes if n[1] == -1]) == 1
    assert sum(len(n[3]) for n in nodes if n[3] is not None) == len(t)


def test_to_bsp_matches_jax_export():
    vecs = datasets.random_uniform(400, 3, seed=130)
    t, j = _pair(list(vecs), list_threshold=5)
    bsp, records = t.to_bsp()
    jbsp, jrecords = j.to_bsp()
    assert bsp.ties_high and bsp.device.type == "cpu"
    assert [_key(r) for r in records] == [_key(r) for r in jrecords]
    for name in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                 "vectors", "orig_row"):
        np.testing.assert_array_equal(getattr(bsp, name).numpy(),
                                      np.asarray(getattr(jbsp, name)))
    assert (bsp.depth, bsp.leaf_cap, bsp.num_leaves) == \
        (jbsp.depth, jbsp.leaf_cap, jbsp.num_leaves)
    mat = np.stack([np.asarray(r) for r in records])
    queries = datasets.random_uniform(6, 3, seed=131)
    res = search(bsp, queries, 0.4)
    jres = jax_search(jbsp, queries, 0.4)
    d2 = ((queries[:, None] - mat[None]) ** 2).sum(-1)
    for qi in range(6):
        want = set(np.nonzero(d2[qi] <= 0.16)[0].tolist())
        assert set(res.match_rows(qi).tolist()) == want
        assert set(jres.match_rows(qi).tolist()) == want
    host = {_key(r) for r in t.find(queries[0], 0.4)}
    assert host == {tuple(mat[r]) for r in res.match_rows(0)}


def test_to_bsp_after_removals():
    vecs = datasets.grid2d(12)
    t = MemoryVectorIndex(list(vecs), **CPU)
    t.remove([0.0, 0.0], 0.3)
    bsp, records = t.to_bsp()
    mat = np.stack([np.asarray(r) for r in records])
    assert len(records) == len(t)
    res = search(bsp, np.array([[0.5, 0.5]], np.float32), 0.4)
    want = np.nonzero(((mat - 0.5) ** 2).sum(1) <= 0.16)[0]
    assert set(res.match_rows(0).tolist()) == set(want.tolist())


def test_find_batch_matches_jax_and_oracle():
    vecs = datasets.grid2d(10)
    t, j = _pair(list(vecs))
    qs = np.array([[0.3, 0.3], [0.0, 0.0]], np.float32)
    records, match = t.find_batch(qs, 0.3)
    jrecords, jmatch = j.find_batch(qs, 0.3)
    assert isinstance(match, np.ndarray) and match.shape == (2, 100)
    assert [_key(r) for r in records] == [_key(r) for r in jrecords]
    np.testing.assert_array_equal(match, np.asarray(jmatch))
    for j_, r in enumerate(records):
        want = float(np.sum((np.asarray(r) - qs[0]) ** 2)) <= 0.09 + 1e-12
        assert bool(match[0, j_]) == want
    empty = MemoryVectorIndex(**CPU)
    assert empty.find_batch(qs, 0.3)[1].shape == (2, 0)


def test_locate_on_plane_coordinate():
    """A record with a coordinate exactly ON a trie cell center routes
    HIGH at build (v >= center); locate reproduces that tie rule on
    to_bsp trees."""
    rng = np.random.RandomState(9)
    recs = rng.rand(40, 3).astype(np.float32) * 2 - 1
    recs[7, 0] = 0.0  # on the root split plane of dim 0
    recs[19, 1] = 0.0
    t = MemoryVectorIndex([(i, recs[i]) for i in range(40)],
                          vector_selector=lambda r: r[1], list_threshold=2,
                          **CPU)
    bsp, records = t.to_bsp()
    assert bsp.ties_high
    rows = locate(bsp, recs).numpy()
    assert (rows >= 0).all()
    assert [records[r][0] for r in rows] == list(range(40))


def test_nan_record_survives_split():
    recs = [(i, np.array([0.1 * i - 0.5, 0.2], np.float32)) for i in range(6)]
    recs.append((99, np.array([np.nan, 0.2], np.float32)))
    t = MemoryVectorIndex(recs, vector_selector=lambda r: r[1],
                          list_threshold=4, **CPU)
    for i in range(6, 20):
        t.add((i, np.array([0.1 * (i % 10) - 0.5, -0.3], np.float32)))
    assert len(t) == len(recs) + 14
    assert sum(len(b) for b in t._buckets.values()) == len(t)
