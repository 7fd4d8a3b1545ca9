"""DynamicIndex of vector_database_tpu_torch against the JAX package.

The same sequence of adds, removals, searches and k-NN calls runs step by
step through both packages (the JAX packed scan in Pallas interpret mode,
the port's in the plain version of its kernel). On integer-valued data
every distance, pack entry and tree plane is exact, so the trees are
bitwise equal and every result must be equal too, ids and distances, in
order. Float-data cases are held to a numpy oracle over the live rows
(distances rtol 1e-4, atol 1e-5: f32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vector_database_tpu.dynamic import DynamicIndex as JaxDynamicIndex
from vector_database_tpu_torch import DynamicIndex
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)


def _ints(rng, shape, span=6):
    return rng.integers(-span, span + 1, shape).astype(np.float32)


def _equal(got, want, what):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(what))


def _same_up_to_ties(got, want, what):
    """Distances bitwise equal; ids equal as sets among equal distances,
    and the tie group at the k-th place of the same size (the JAX class
    picks its members with ``argpartition``)."""
    (gi, gd), (wi, wd) = got, want
    np.testing.assert_array_equal(gd, wd, err_msg=str(what))
    for i in range(gi.shape[0]):
        for value in np.unique(wd[i]):
            at = wd[i] == value
            if value != wd[i, -1]:
                assert set(gi[i][at].tolist()) == set(wi[i][at].tolist()), \
                    (what, i)


def test_churn_sequence_matches_jax():
    rng = np.random.default_rng(5)
    v = _ints(rng, (2500, 8))
    q = _ints(rng, (24, 8))
    kw = dict(leaf_size=8, rebuild_fraction=0.05)
    j = JaxDynamicIndex(v, **kw)
    t = DynamicIndex(v, device="cpu", **kw)
    modes = [dict(), dict(exact=False), dict(packed=True),
             dict(packed=True, probes=1, q_tile=8), dict(radius=4.0)]
    for step in range(3):
        for mode in modes:
            _equal(t.knn(q, k=5, **mode), j.knn(q, k=5, **mode),
                   (step, mode))
        gone = rng.choice(2500 + 30 * step, 40, replace=False)
        assert t.remove_ids(gone) == j.remove_ids(gone)
        extra = _ints(rng, (30, 8))
        _equal([t.add(extra)], [j.add(extra)], "add")
        point = _ints(rng, (8,))
        assert t.remove(point, 2.0) == j.remove(point, 2.0)
        for (ti, td), (ji, jd) in zip(t.search(q[:4], 3.0),
                                      j.search(q[:4], 3.0)):
            assert sorted(zip(ti.tolist(), td.tolist())) == \
                sorted(zip(ji.tolist(), jd.tolist()))
        allowed = rng.choice(2600, 300, replace=False)
        _equal(t.knn(q, k=4, allowed_ids=allowed),
               j.knn(q, k=4, allowed_ids=allowed), "allowed")
        assert len(t) == len(j)
    # churn passed the 5% threshold on the way: both compacted alike
    assert t._main.ids.size != 2500
    np.testing.assert_array_equal(t._main.ids, j._main_ids)
    np.testing.assert_array_equal(t._main_alive, j._main_alive)
    assert t._delta.size == len(j._delta_ids)
    t.add(q[:3])
    j.add(q[:3])
    for mode in modes:
        _equal(t.knn(q, k=5, **mode), j.knn(q, k=5, **mode), mode)


def test_pack_identity_invariants():
    """The main view is ``index.vectors`` itself; an add keeps both
    epochs and the pack; a removal keeps the base pack's blocks and only
    masks its norm row; the delta's capacity is 64, then 128; ``compact``
    starts a new base."""
    rng = np.random.default_rng(6)
    v = _ints(rng, (3000, 8))
    q = _ints(rng, (8, 8))
    t = DynamicIndex(v, leaf_size=8, rebuild_fraction=10.0, device="cpu")
    j = JaxDynamicIndex(v, leaf_size=8, rebuild_fraction=10.0)
    view = t._main_view()
    assert view.rows is t._main.index.vectors and view.mask is None
    t.knn(q, k=3, packed=True)
    base = t._main.pack
    assert view.pack is base  # unmasked epoch

    target = np.full((1, 8), 0.5, np.float32)
    main = t._main
    (tid,) = t.add(target)
    assert j.add(target)[0] == tid
    ids, d2 = t.knn(target, k=1, packed=True)
    assert t._main is main and t._main_view() is view and view.pack is base
    assert ids[0, 0] == tid and d2[0, 0] == 0.0
    assert t._delta.rows.shape[0] == 64 and t._delta.size == 1
    t.add(np.zeros((70, 8), np.float32))
    assert t._delta.rows.shape[0] == 128

    assert t.remove_ids([0, 1, tid]) == 3
    ids, _ = t.knn(q, k=3, packed=True)
    masked = t._main_view()
    assert t._main is main and main.pack is base  # no repack
    assert masked.pack is not base and masked.pack.vb is base.vb
    assert masked.rows is t._main.index.vectors
    assert int(masked.mask.sum()) == 2998
    assert not np.isin(ids, [0, 1, tid]).any()
    got, gd2 = t.knn(v[0:1], k=1, packed=True)
    assert got[0, 0] != 0

    t.compact()
    t.knn(q, k=3, packed=True)
    assert t._main.pack.vb is not base.vb


def test_min_probe_batch_guard(monkeypatch):
    """Under ``min_probe_batch`` queries the pruned call serves the full
    packed scan (bitwise the ``packed=True`` answer); at or above it the
    pruned scan runs. The default stays None, as in the JAX package."""
    import inspect

    from vector_database_tpu_torch.ops import packed_knn

    vecs = datasets.random_uniform(20000, 8, seed=421)
    queries = datasets.random_uniform(64, 8, seed=422)
    index = DynamicIndex(vecs, leaf_size=16, device="cpu")
    assert inspect.signature(index.knn).parameters[
        "min_probe_batch"].default is None
    full = index.knn(queries, k=5, packed=True)
    assert index._main.pack.vb.shape[0] > 1  # a real multi-block pack
    calls = []
    real = packed_knn._block_map

    def spy(*a, **kw):
        calls.append(kw["probes"])
        return real(*a, **kw)

    monkeypatch.setattr(packed_knn, "_block_map", spy)
    guarded = index.knn(queries, k=5, packed=True, probes=1,
                        min_probe_batch=128)
    assert calls == []
    _equal(guarded, full, "guarded")
    pruned = index.knn(queries, k=5, packed=True, probes=1,
                       min_probe_batch=32)
    assert calls == [1]
    jpruned = JaxDynamicIndex(vecs, leaf_size=16).knn(
        queries, k=5, packed=True, probes=1, min_probe_batch=32)
    same = sum(set(a) == set(b) for a, b in zip(pruned[0].tolist(),
                                                jpruned[0].tolist()))
    assert same >= 62
    with pytest.raises(ValueError, match="min_probe_batch"):
        index.knn(queries, k=5, packed=True, min_probe_batch=32)
    with pytest.raises(ValueError, match="filtered"):
        index.knn(queries, k=5, packed=True, allowed_ids=[1, 2])
    with pytest.raises(ValueError, match="exact=True"):
        index.knn(queries, k=5, packed=True, exact=True)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_saved_index_serves_the_same_answers(tmp_path, direction):
    rng = np.random.default_rng(7)
    v = _ints(rng, (600, 5))
    q = _ints(rng, (12, 5))
    cpu = dict(device="cpu")
    src_cls, dst_cls, src_kw, dst_kw = (
        (JaxDynamicIndex, DynamicIndex, {}, cpu)
        if direction == "jax_to_torch"
        else (DynamicIndex, JaxDynamicIndex, cpu, {}))
    src = src_cls(v, leaf_size=4, **src_kw)
    src.remove_ids(np.arange(0, 600, 7))
    src.add(_ints(rng, (10, 5)))  # pending delta: save compacts it
    src.save(str(tmp_path / "dyn"))
    dst = dst_cls.load(str(tmp_path / "dyn"), **dst_kw)
    assert len(dst) == len(src)
    for mode in (dict(), dict(packed=True)):
        _equal(dst.knn(q, k=5, **mode), src.knn(q, k=5, **mode), mode)
    for (a, ad), (b, bd) in zip(dst.search(q, 3.0), src.search(q, 3.0)):
        assert sorted(a.tolist()) == sorted(b.tolist())
    assert dst.add(np.zeros((1, 5), np.float32))[0] == src._next_id


def test_oracle_cycle_on_float_data():
    """Interleaved adds and removals (no compaction): exact k-NN and
    radius search equal a numpy oracle over the live rows at every step."""
    rng = np.random.default_rng(77)
    index = DynamicIndex(leaf_size=4, rebuild_fraction=10.0,
                         device="cpu")
    base = datasets.random_uniform(300, 5, seed=70)
    live = dict(zip(index.add(base).tolist(), base))
    index.compact()
    queries = datasets.random_uniform(16, 5, seed=71)
    for step in range(4):
        gone = list(live)[step * 2:step * 2 + 2]
        assert index.remove_ids(gone) == 2
        for g in gone:
            del live[g]
        fresh = rng.random((2, 5)).astype(np.float32) * 2 - 1
        live.update(zip(index.add(fresh).tolist(), fresh))
        point = rng.random(5).astype(np.float32) * 2 - 1
        keys = np.asarray(sorted(live))
        mat = np.stack([live[int(i)] for i in keys])
        in_ball = keys[((mat - point) ** 2).sum(1) <= 0.16]
        assert index.remove(point, 0.4) == in_ball.size
        for i in in_ball:
            del live[int(i)]
        keys = np.asarray(sorted(live))
        mat = np.stack([live[int(i)] for i in keys])
        d2 = ((queries[:, None, :] - mat[None, :, :]) ** 2).sum(-1)
        order = np.argsort(d2, axis=1)[:, :5]
        got_ids, got_d2 = index.knn(queries, k=5)
        np.testing.assert_allclose(got_d2, np.take_along_axis(d2, order, 1),
                                   rtol=1e-4, atol=1e-5)
        for qi in range(16):
            assert set(got_ids[qi].tolist()) == set(keys[order[qi]].tolist())
        ids, _ = index.search(queries[0], 0.5)[0]
        assert set(ids.tolist()) == set(keys[d2[0] <= 0.25].tolist())
    assert len(index) == len(live)


def test_small_cases():
    """Padding when k exceeds the live rows, removing everything, empty
    adds, and one build for a constructor plus a clean save."""
    index = DynamicIndex(np.eye(3, dtype=np.float32), leaf_size=2,
                         device="cpu")
    index.remove_ids([1])
    ids, d2 = index.knn(np.zeros((1, 3), np.float32), k=4)
    assert (ids[0] >= 0).sum() == 2 and 1 not in ids[0].tolist()
    assert np.isinf(d2[0][ids[0] < 0]).all()

    index = DynamicIndex(device="cpu")
    assert index.search(np.zeros(3), 1.0)[0][0].size == 0
    assert index.add([]).size == 0 and index.dims is None
    index.add(np.ones((5, 3), np.float32))
    assert index.remove(np.ones(3, np.float32), 0.0) == 5
    assert len(index) == 0
    assert index.add(np.zeros((0,), np.float32)).size == 0


def test_constructor_builds_once_and_clean_save_skips(tmp_path, monkeypatch):
    import vector_database_tpu_torch.dynamic as dyn

    calls = [0]
    real = dyn.build_index_fused

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(dyn, "build_index_fused", counting)
    index = DynamicIndex(datasets.random_uniform(200, 4, seed=50),
                         device="cpu")
    assert calls[0] == 1
    index.save(str(tmp_path / "ck"))
    assert calls[0] == 1
    index.remove_ids([0])
    index.compact()
    assert calls[0] == 2


def test_exact_fallback_under_overflow(monkeypatch):
    """A candidate buffer at its growth cap must not truncate search or
    remove: both fall back to the exact scan."""
    import vector_database_tpu_torch.dynamic as dyn

    vecs = datasets.random_uniform(300, 4, seed=51)
    index = DynamicIndex(vecs, device="cpu")
    q, radius = vecs[7], 0.6
    truth = np.nonzero(((vecs - q) ** 2).sum(1) <= radius * radius)[0]
    assert truth.size > 3
    real = dyn.bsp_search

    def overflowing(idx, queries, r, **kw):
        res = real(idx, queries, r, **kw)
        rows = torch.full_like(res.rows, -1)
        rows[:, 0] = res.rows[:, 0]
        return dataclasses.replace(res, rows=rows,
                                   overflow=torch.ones_like(res.overflow))

    monkeypatch.setattr(dyn, "bsp_search", overflowing)
    assert set(index.search(q[None], radius)[0][0].tolist()) == \
        set(truth.tolist())
    assert index.remove(q, radius) == truth.size
    monkeypatch.setattr(dyn, "bsp_search", real)
    assert index.search(q[None], radius)[0][0].size == 0


def test_allowed_ids_reach_the_delta():
    vecs = datasets.random_uniform(600, 5, seed=189)
    dyn = DynamicIndex(vecs[:500], leaf_size=8, device="cpu")
    extra = dyn.add(vecs[500:])
    allowed = np.asarray([3, 77, int(extra[10])])
    ids, _ = dyn.knn(vecs[[3, 510]], k=2, allowed_ids=allowed)
    assert ids[0, 0] == 3 and ids[1, 0] == int(extra[10])
    assert set(ids.ravel().tolist()) <= set(allowed.tolist())


def _delta_ties_case():
    """Main: one row at distance 1 from the origin, 64 far rows at
    distinct distances. Delta: 300 integer rows in six adds, each a copy
    of one of three rows (distances 1, 2 and 4 from the origin), so every
    distance is shared by ~100 adds and ``k`` cuts through a tie."""
    rng = np.random.default_rng(3)
    far = (40 + np.arange(64, dtype=np.float32))[:, None] * np.ones(4)
    main = np.vstack([[1, 0, 0, 0], far]).astype(np.float32)
    shapes = np.asarray([[0, 1, 0, 0], [0, 1, 1, 0], [0, 2, 0, 0]],
                        np.float32)
    delta = shapes[rng.integers(0, 3, 300)]
    queries = np.asarray([[0, 0, 0, 0], [0, 1, 0, 0]], np.float32)
    return main, delta, queries


@pytest.mark.parametrize("mode", [dict(), dict(exact=False),
                                  dict(packed=True)])
def test_delta_ties_keep_the_earliest_adds_in_add_order(mode):
    """On a tie at the k-th distance the delta keeps its earliest adds,
    equal distances come back in add order, and main rows lead delta
    rows: one stable sort over the main rows, then the delta in add
    order (the JAX class's ``argpartition`` keeps arbitrary adds: against
    it, distances are bitwise and tie groups sets)."""
    main, delta, queries = _delta_ties_case()
    kw = dict(leaf_size=4, rebuild_fraction=100.0)
    index = DynamicIndex(main, device="cpu", **kw)
    jax_index = JaxDynamicIndex(main, **kw)
    added = np.concatenate([index.add(delta[s:s + 50])
                            for s in range(0, 300, 50)])
    for s in range(0, 300, 50):
        jax_index.add(delta[s:s + 50])
    assert index._delta.size == 300
    all_ids = np.concatenate([np.arange(main.shape[0]), added])
    rows = np.vstack([main, delta])
    for k in (10, 120):
        ids, d2 = index.knn(queries, k=k, **mode)
        for i, q in enumerate(queries):
            dist = ((rows - q) ** 2).sum(1).astype(np.float32)
            order = np.argsort(dist, kind="stable")[:k]
            np.testing.assert_array_equal(d2[i], dist[order])
            np.testing.assert_array_equal(ids[i], all_ids[order],
                                          err_msg=str((k, i, mode)))
        _same_up_to_ties((ids, d2), jax_index.knn(queries, k=k, **mode),
                         (k, mode))


def _capacity(n):
    return max(64, 1 << (n - 1).bit_length())


def test_delta_buffer_keeps_add_order_and_capacity():
    """Across adds, ``remove_ids`` of delta rows and ``remove`` by
    radius, the delta buffer holds the live rows in add order with their
    ids, at the smallest power-of-two capacity >= max(64, size); its merge
    equals, bit for bit, that of a fresh index given the same live rows
    in one add (integer rows: many distances tie, so the slot order
    decides)."""
    rng = np.random.default_rng(11)
    kw = dict(leaf_size=8, rebuild_fraction=100.0, device="cpu")
    main = _ints(rng, (400, 6), span=2)
    t = DynamicIndex(main, **kw)
    live = {}
    q = _ints(rng, (20, 6), span=2)
    for step in range(5):
        rows = _ints(rng, (40 * step + 30, 6), span=2)
        live.update(zip(t.add(rows).tolist(), rows))
        gone = rng.choice(list(live), 10, replace=False)
        assert t.remove_ids(gone) == 10
        for g in gone:
            del live[int(g)]
        point = _ints(rng, (6,), span=2)
        hits = [i for i, r in live.items() if ((r - point) ** 2).sum() <= 1]
        assert t.remove(point, 1.0) >= len(hits)
        for g in hits:
            del live[g]
        delta = t._delta
        assert delta.ids.tolist() == list(live)
        assert delta.rows.shape[0] == _capacity(len(live))
        np.testing.assert_array_equal(delta.live.numpy(),
                                      np.stack(list(live.values())))
        fresh = DynamicIndex(main, **kw)
        remap = dict(zip(fresh.add(np.stack(list(live.values()))).tolist(),
                         live))
        remap[-1] = -1
        for k in (5, 40):
            empty = (np.full((20, k), -1, np.int64),
                     np.full((20, k), np.inf, np.float32))
            gi, gd = t.merge_delta(q, *empty, k)
            fi, fd = fresh.merge_delta(q, *empty, k)
            np.testing.assert_array_equal(gd, fd)
            np.testing.assert_array_equal(
                gi, np.vectorize(remap.get)(fi).reshape(gi.shape))
            assert (gd[:, :-1] == gd[:, 1:]).any()


def test_allowed_ids_mask_the_delta_as_jax():
    """``allowed_ids=`` masks the delta rows as the JAX class does: the
    same distances and tie groups, with only delta ids, only main ids,
    or both allowed, after removals on both sides."""
    rng = np.random.default_rng(12)
    v = _ints(rng, (800, 8))
    q = _ints(rng, (16, 8))
    kw = dict(leaf_size=8, rebuild_fraction=100.0)
    t = DynamicIndex(v, device="cpu", **kw)
    j = JaxDynamicIndex(v, **kw)
    for _ in range(3):
        extra = _ints(rng, (40, 8))
        _equal([t.add(extra)], [j.add(extra)], "add")
    gone = np.asarray([3, 5, 801, 830, 899])
    assert t.remove_ids(gone) == j.remove_ids(gone) == 5
    delta_ids = np.arange(800, 920)
    for allowed in (delta_ids[::3], np.arange(0, 800, 4),
                    rng.choice(920, 200, replace=False)):
        got = t.knn(q, k=6, allowed_ids=allowed)
        _same_up_to_ties(got, j.knn(q, k=6, allowed_ids=allowed),
                         allowed[:3])
        served = got[0][got[0] >= 0]
        assert np.isin(served, allowed).all()
        assert not np.isin(served, gone).any()


def test_forgotten_tombstones_serve_removed_rows_again():
    """``_main_alive[:] = True`` then ``_invalidate_main()`` (how the
    benchmark's ``no-tombstones`` control reaches the class) serves the
    removed main rows again from the next request on, packed or not,
    through one new removal epoch over the unmasked base pack."""
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    v = datasets.random_uniform(3000, 8, seed=91)
    t = DynamicIndex(v, leaf_size=8, rebuild_fraction=10.0, device="cpu")
    gone = np.arange(0, 3000, 7)
    assert t.remove_ids(gone) == gone.size
    modes = (dict(), dict(exact=False), dict(packed=True))
    for mode in modes:
        ids, _ = t.knn(v[gone[:20]], k=1, **mode)
        assert not np.isin(ids, gone).any(), mode
    views = COUNTERS["dynamic.main_views"]
    t._main_alive[:] = True
    t._invalidate_main()
    for mode in modes:
        ids, d2 = t.knn(v[gone[:20]], k=1, **mode)
        np.testing.assert_array_equal(ids[:, 0], gone[:20],
                                      err_msg=str(mode))
        assert (d2[:, 0] < 1e-5).all()  # the scan's own rounding of 0
    assert COUNTERS["dynamic.main_views"] == views + 1
    view = t._main_view()
    assert view.mask is None and view.pack is t._main.pack
