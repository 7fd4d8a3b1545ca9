"""PackedServer of vector_database_tpu_torch, and the whole slice (build ->
pack -> serve) against the JAX chain on the same numpy-seeded data.

Results are compared as original-row id sets per query (the rerank's f32
distances differ from JAX's in the last ulps, so equal-distance order may
differ); distances to rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu.ops import pallas_knn as jpk
from vector_database_tpu.serving import PackedServer as JaxServer
from vector_database_tpu_torch import (
    PackedServer,
    build_index_fused,
    exact_knn,
    pack_database,
    pallas_scan_knn_packed,
)

torch.set_num_threads(2)


def _clustered(seed, n=6000, d=8, c=24, q=100, sigma=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.rand(c, d).astype(np.float32) * 2 - 1
    vecs = (centers[rng.randint(0, c, size=n)]
            + sigma * rng.randn(n, d)).astype(np.float32)
    qs = (centers[rng.randint(0, c, size=q)]
          + sigma * rng.randn(q, d)).astype(np.float32)
    return vecs, qs


@pytest.fixture(scope="module")
def pack_and_queries():
    vecs, qs = _clustered(3)
    return pack_database(vecs, block=512, buckets=128), qs


@pytest.mark.parametrize("q", [0, 1, 7, 16, 37])
def test_ragged_batches_equal_direct_calls(pack_and_queries, q):
    pack, qs = pack_and_queries
    srv = PackedServer(pack, k=5, batch=16, q_tile=16)
    rows, d2 = srv.query(qs[:q])
    assert rows.shape == (q, 5) and d2.shape == (q, 5)
    if q == 0:
        return
    # every wave is padded to 16 rows; a row's result does not depend on
    # its wave-mates in the full scan
    want_r, want_d = pallas_scan_knn_packed(pack, qs[:q], k=5, q_tile=16)
    assert torch.equal(rows, want_r)
    assert torch.equal(d2, want_d)


def test_min_probe_batch_routes_small_waves_to_full_scan(pack_and_queries):
    pack, qs = pack_and_queries
    srv = PackedServer(pack, k=5, batch=32, q_tile=16, probes=2,
                       min_probe_batch=32)
    full = PackedServer(pack, k=5, batch=32, q_tile=16)
    pruned = PackedServer(pack, k=5, batch=32, q_tile=16, probes=2)
    # 40 queries: one full wave (pruned) + one 8-query wave (full scan)
    rows, _ = srv.query(qs[:40])
    assert torch.equal(rows[:32], pruned.query(qs[:32])[0])
    assert torch.equal(rows[32:], full.query(qs[32:40])[0])
    with pytest.raises(ValueError, match="exceeds batch"):
        PackedServer(pack, batch=32, probes=2, min_probe_batch=33)
    with pytest.raises(ValueError, match="requires probes"):
        PackedServer(pack, batch=32, probes_max=4)


def test_set_probes_with_runtime_probes(pack_and_queries):
    pack, qs = pack_and_queries
    srv = PackedServer(pack, k=5, batch=64, q_tile=16, probes=2,
                       probes_max=6)
    srv.warmup()
    for p in (1, 4, 6):
        srv.set_probes(p)
        static = PackedServer(pack, k=5, batch=64, q_tile=16, probes=p)
        assert torch.equal(srv.query(qs[:64])[0], static.query(qs[:64])[0])
    with pytest.raises(ValueError, match="probes_max"):
        srv.set_probes(7)


def test_from_vectors_splits_serve_keywords(pack_and_queries):
    pack, qs = pack_and_queries
    vecs, _ = _clustered(3)
    srv = PackedServer.from_vectors(vecs, k=5, batch=32, block=512,
                                    buckets=128, q_tile=16, probes=2,
                                    probes_max=4, min_probe_batch=32)
    assert srv._pack.block == 512 and srv._pack.m == 128
    want = PackedServer(pack, k=5, batch=32, q_tile=16, probes=2,
                        probes_max=4, min_probe_batch=32)
    assert torch.equal(srv.query(qs[:40])[0], want.query(qs[:40])[0])
    with pytest.raises(TypeError):
        PackedServer.from_vectors(vecs, k=5, bogus=1)


def test_server_defaults_match_jax(pack_and_queries):
    pack, qs = pack_and_queries
    for batch in (1, 20, 4096):
        assert PackedServer(pack, batch=batch)._q_tile == \
            JaxServer(None, batch=batch)._q_tile


def _ids(rows, orig):
    return [set(orig[r[r >= 0]].tolist()) for r in np.asarray(rows)]


@pytest.mark.parametrize("probes", [None, 6])
def test_build_pack_serve_matches_jax_chain(probes):
    """The whole slice on clustered float data. Served from the same
    (JAX-built) tree, the port's pack + serve returns JAX's id sets. Each
    package's own build may place a plane one ulp apart (f32 prefix sums
    in another order), which moves a few rows between buckets; the two
    chains must still agree on >= 97% of result ids and on recall against
    the exact oracle within 0.02."""
    vecs, qs = _clustered(17, n=8000, d=8, c=32, q=64)
    kw = dict(block=512, buckets=128)
    jidx = jax_build(vecs, leaf_size=16)
    tidx = build_index_fused(vecs, leaf_size=16)
    jorig, torig = np.asarray(jidx.orig_row), tidx.orig_row.numpy()
    jr, _ = JaxServer(jpk.pack_database(jidx.vectors, **kw), k=10, batch=64,
                      probes=probes).query(qs)
    want = _ids(jr, jorig)

    shared = PackedServer(pack_database(np.asarray(jidx.vectors), **kw),
                          k=10, batch=64, probes=probes)
    assert _ids(shared.query(qs)[0], jorig) == want

    tsrv = PackedServer(pack_database(tidx.vectors, **kw), k=10, batch=64,
                        probes=probes)
    tr, td = tsrv.query(qs)
    got = _ids(tr, torig)
    agree = sum(len(a & b) for a, b in zip(got, want)) / (10 * len(qs))
    assert agree >= 0.97
    truth = [set(r) for r in exact_knn(vecs, qs, k=10)[0].tolist()]

    def recall(ids):
        return sum(len(a & t) for a, t in zip(ids, truth)) / (10 * len(qs))

    assert abs(recall(got) - recall(want)) <= 0.02
    # returned distances are exact f32 for the returned rows
    lm = tidx.vectors.numpy()
    r0 = tr.numpy()[:, 0]
    np.testing.assert_allclose(td.numpy()[:, 0],
                               ((lm[r0] - qs) ** 2).sum(1), rtol=1e-5,
                               atol=1e-6)
