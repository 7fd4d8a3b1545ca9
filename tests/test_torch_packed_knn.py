"""The packed scan of vector_database_tpu_torch against the JAX package.

Both sides get the same numpy-seeded inputs. The JAX side runs its Pallas
kernels in interpret mode, as its own tests do; the port runs the plain
torch version of its CUDA kernel (the tensors lie on the CPU).

Tolerances, with their reasons:
- packed blocks ``vb`` are bitwise equal (``-2v`` is exact in f32 and both
  round it to bf16 the same way);
- ``vn``/``cent``/``rad`` are f32 sums whose order differs between XLA and
  torch: rtol 1e-6, atol 1e-5;
- the scan accumulator: each score is a sum of d_pad exact bf16 products
  in f32, accumulated in another order, so scores agree to 1e-5 relative
  plus the encode's masking of the low ``bits`` bits (2^(bits-23)
  relative); block ids must agree wherever the masked scores do;
- rerank distances: f32 sums over D in another order, rtol 1e-5, atol
  1e-6.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vector_database_tpu.ops import pallas_knn as jpk
from vector_database_tpu_torch.ops import bucket_scan as tbs
from vector_database_tpu_torch.ops import packed_knn as tpk
from vector_database_tpu_torch.utils import datasets
from vector_database_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(2)


def _clustered(seed, n, d, c, q, sigma=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.rand(c, d).astype(np.float32) * 2 - 1
    vecs = (centers[rng.randint(0, c, size=n)]
            + sigma * rng.randn(n, d)).astype(np.float32)
    qs = (centers[rng.randint(0, c, size=q)]
          + sigma * rng.randn(q, d)).astype(np.float32)
    return vecs, qs


def _spy_pallas_calls():
    """Patch ``pallas_call`` to record every (inputs, output) pair."""
    calls = []
    real = pl.pallas_call

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def call(*args):
            out = fn(*args)
            calls.append(([np.asarray(x) for x in args], np.asarray(out)))
            return out

        return call

    return calls, mock.patch.object(jpk.pl, "pallas_call", spy)


def _assert_acc_close(got, want, bits):
    mask = (1 << bits) - 1
    gi, wi = got.view(np.int32), want.view(np.int32)
    gs = (gi & ~mask).view(np.float32)
    ws = (wi & ~mask).view(np.float32)
    tol = 1e-5 * np.abs(ws) + 2.0 ** (bits - 22) * np.abs(ws) + 1e-6
    assert np.all(np.abs(gs - ws) <= tol)
    same = gs == ws
    np.testing.assert_array_equal((gi & mask)[same], (wi & mask)[same])


def _port_pack(jpack):
    return tpk.PackedDB.from_numpy(
        dict(vb=np.asarray(jpack.vb), vn=np.asarray(jpack.vn),
             vectors=np.asarray(jpack.vectors), cent=np.asarray(jpack.cent),
             rad=np.asarray(jpack.rad)),
        dict(n=jpack.n, block=jpack.block, m=jpack.m, bits=jpack.bits,
             metric=jpack.metric),
        device="cpu",
    )


@pytest.mark.parametrize(
    "n,d,block,buckets,rows_valid,metric",
    [(1000, 12, 256, 128, None, "l2"), (777, 13, 256, 128, 700, "l2"),
     (100, 24, 512, 128, None, "cosine"), (1500, 8, 512, 256, None, "ip")],
)
def test_pack_matches_jax(n, d, block, buckets, rows_valid, metric):
    rng = np.random.RandomState(31)
    v = rng.rand(n, d).astype(np.float32) * 2 - 1
    if rows_valid:
        v[rows_valid:] = np.inf
    j = jpk.pack_database(v, block=block, buckets=buckets, metric=metric,
                          rows_valid=rows_valid)
    t = tpk.pack_database(v, block=block, buckets=buckets, metric=metric,
                          rows_valid=rows_valid, device="cpu")
    assert (t.n, t.block, t.m, t.bits) == (j.n, j.block, j.m, j.bits)
    np.testing.assert_array_equal(
        t.vb.view(torch.int16).numpy(),
        np.asarray(j.vb).view(np.int16),
    )
    for name in ("vn", "cent", "rad"):
        np.testing.assert_allclose(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            rtol=1e-6, atol=1e-5, err_msg=name,
        )


def test_auto_block_matches_jax():
    for d in (8, 96, 640, 1536):
        assert tpk.auto_block(d) == jpk.auto_block(d)
    assert tpk._summary_cell(256) == jpk._summary_cell(256)


@pytest.mark.parametrize("q_tile", [8, 16])
def test_plain_scan_matches_jax_full_kernel(q_tile):
    """The JAX pack's arrays through the port's plain version equal
    JAX's interpret-mode ``_kernel`` accumulator."""
    vecs = datasets.random_uniform(3000, 20, seed=150)
    queries = datasets.random_uniform(37, 20, seed=151)
    jpack = jpk.pack_database(vecs, block=512, buckets=128)
    calls, patch = _spy_pallas_calls()
    with patch:
        jpk._scan_knn_packed_impl(jpack, jnp.asarray(queries), k=4,
                                  q_tile=q_tile, interpret=True)
    (args, acc), = calls
    vn, vb, qb = args
    pack = _port_pack(jpack)
    got = tbs.bucket_scan(
        pack.vn, pack.vb, tpk._to_tensor(qb, "cpu"), m=pack.m,
        bits=pack.bits,
    )
    _assert_acc_close(got.numpy(), acc.reshape(-1, pack.m), pack.bits)


@pytest.mark.parametrize("rt", [False, True])
def test_block_map_and_pruned_scan_match_jax(rt):
    vecs, queries = _clustered(23, 8000, 8, 32, 64)
    jpack = jpk.pack_database(vecs, block=512, buckets=128)
    nb = jpack.vb.shape[0]
    calls, patch = _spy_pallas_calls()
    with patch:
        jr, _ = jpk._scan_knn_packed_impl(
            jpack, jnp.asarray(queries), k=5, q_tile=16, probes=3,
            probes_max=nb // 2 if rt else None, interpret=True)
    (args, acc), = calls
    jbmap = args[3]
    pack = _port_pack(jpack)
    order, bmap = tpk._block_map(
        pack, torch.from_numpy(queries), q_tile=16,
        probes=nb // 2 if rt else 3,
    )
    np.testing.assert_array_equal(bmap.numpy(), jbmap)
    got = tbs.bucket_scan(
        pack.vn, pack.vb, tpk._to_tensor(args[2], "cpu"), m=pack.m,
        bits=pack.bits, bmap=bmap, nprobe=3, q_tile=16,
    )
    _assert_acc_close(got.numpy(), acc.reshape(-1, pack.m), pack.bits)
    tr, _ = (tpk.pallas_scan_knn_packed_rt(
        pack, queries, 3, k=5, probes_max=nb // 2, q_tile=16) if rt else
        tpk.pallas_scan_knn_packed(pack, queries, k=5, q_tile=16, probes=3))
    for a, b in zip(tr.numpy(), np.asarray(jr)):
        assert set(a.tolist()) == set(b.tolist())


def test_full_scan_matches_jax_results():
    vecs, queries = _clustered(113, 16384, 32, 64, 8)
    jr, jd = jpk.pallas_scan_knn(vecs, queries, k=10, block=1024, q_tile=8,
                                 oversample=8)
    tr, td = tpk.pallas_scan_knn(vecs, queries, k=10, block=1024, q_tile=8,
                                 oversample=8, device="cpu")
    for a, b in zip(tr.numpy(), np.asarray(jr)):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def test_small_database_equals_exact_oracle():
    """With n <= buckets every row owns a bucket: the scan is exact."""
    from vector_database_tpu_torch.ops.exact import exact_knn

    rng = np.random.RandomState(42)
    vecs = rng.rand(4000, 24).astype(np.float32) * 2 - 1
    qs = rng.rand(64, 24).astype(np.float32) * 2 - 1
    rows, d2 = tpk.pallas_scan_knn(vecs, qs, k=5, device="cpu")
    erows, ed2 = exact_knn(torch.from_numpy(vecs), qs, k=5)
    for a, b in zip(rows.tolist(), erows.tolist()):
        assert set(a) == set(b)
    np.testing.assert_allclose(np.sort(d2.numpy(), 1),
                               np.sort(ed2.numpy(), 1), rtol=1e-4, atol=1e-5)


def test_probes_full_coverage_equals_full_scan():
    vecs = datasets.random_uniform(3000, 12, seed=150)
    queries = datasets.random_uniform(37, 12, seed=151)
    pack = tpk.pack_database(vecs, block=512, buckets=128, device="cpu")
    nb = pack.vb.shape[0]
    fr, fd = tpk.pallas_scan_knn_packed(pack, queries, k=4, q_tile=8)
    # static probes >= nb is the full scan; the rt path with probes_max=nb
    # really runs the pruned kernel over every block
    for pr, pd in (
        tpk.pallas_scan_knn_packed(pack, queries, k=4, q_tile=8, probes=nb),
        tpk.pallas_scan_knn_packed_rt(pack, queries, nb, k=4, probes_max=nb,
                                      q_tile=8),
    ):
        assert torch.equal(fr, pr)
        assert torch.equal(fd, pd)


def test_pruned_exact_via_sentinel_block():
    vecs = datasets.random_uniform(1024, 16, seed=160)
    padded = np.concatenate([vecs, np.full((256, 16), np.inf, np.float32)])
    pack = tpk.pack_database(padded, block=256, buckets=128,
                             rows_valid=1024, device="cpu")
    nb = pack.vb.shape[0]
    assert nb == 5
    queries = datasets.random_uniform(50, 16, seed=161)
    fr, fd = tpk.pallas_scan_knn_packed(pack, queries, k=5, q_tile=16)
    pr, pd = tpk.pallas_scan_knn_packed(pack, queries, k=5, q_tile=16,
                                        probes=nb - 1)
    assert torch.equal(fr, pr) and torch.equal(fd, pd)


def test_runtime_probes_matches_static():
    vecs, queries = _clustered(23, 8000, 8, 32, 64)
    pack = tpk.pack_database(vecs, block=512, buckets=128, device="cpu")
    nb = pack.vb.shape[0]
    for p in (1, 3, nb // 2, nb):
        sr, sd = tpk.pallas_scan_knn_packed(pack, queries, k=5, q_tile=16,
                                            probes=p)
        rr, rd = tpk.pallas_scan_knn_packed_rt(pack, queries, p, k=5,
                                               probes_max=nb, q_tile=16)
        assert torch.equal(sr, rr), p
        assert torch.equal(sd, rd), p
    cr, _ = tpk.pallas_scan_knn_packed_rt(pack, queries, nb + 100, k=5,
                                          probes_max=nb, q_tile=16)
    assert torch.equal(cr, rr)


def test_probes_max_keyword_is_the_runtime_entry():
    """``pallas_scan_knn_packed(probes=p, probes_max=w)`` is the
    runtime-probes call, as in the JAX package's jitted entry."""
    vecs, queries = _clustered(23, 8000, 8, 32, 64)
    pack = tpk.pack_database(vecs, block=512, buckets=128, device="cpu")
    for p in (2, 5):
        got = tpk.pallas_scan_knn_packed(pack, queries, k=5, q_tile=16,
                                         probes=p, probes_max=6)
        want = tpk.pallas_scan_knn_packed_rt(pack, queries, p, k=5,
                                             probes_max=6, q_tile=16)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="requires probes"):
        tpk.pallas_scan_knn_packed(pack, queries, k=5, probes_max=6)


def test_calibrate_probes_matches_jax():
    vecs, qs = _clustered(13, 20000, 8, 64, 256, sigma=0.04)
    from vector_database_tpu import build_index_fused

    lm = np.asarray(build_index_fused(vecs, leaf_size=16).vectors)
    jpack = jpk.pack_database(lm, block=1024, buckets=512)
    pack = tpk.pack_database(lm, block=1024, buckets=512, device="cpu")
    want = jpk.calibrate_probes(jpack, qs, k=10, target_recall=0.9,
                                q_tile=64)
    got = tpk.calibrate_probes(pack, qs, k=10, target_recall=0.9, q_tile=64)
    assert got == want
    assert 1 <= got <= pack.vb.shape[0]


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_metrics_match_jax(metric):
    rng = np.random.default_rng(141)
    vecs = (rng.random((3000, 24)) * 4 - 2).astype(np.float32)
    vecs *= rng.random((3000, 1)).astype(np.float32) * 3 + 0.1
    queries = (rng.random((16, 24)) * 4 - 2).astype(np.float32)
    jr, js = jpk.pallas_scan_knn(vecs, queries, k=5, block=512, q_tile=8,
                                 metric=metric)
    tr, ts = tpk.pallas_scan_knn(vecs, queries, k=5, block=512, q_tile=8,
                                 metric=metric, device="cpu")
    for a, b in zip(tr.numpy(), np.asarray(jr)):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    if metric == "ip":  # exact dots, highest first
        assert np.all(np.diff(ts.numpy(), axis=1) <= 1e-6)


def test_errors():
    vecs = datasets.random_uniform(2000, 8, seed=152)
    with pytest.raises(ValueError, match="empty"):
        tpk.pack_database(np.zeros((0, 8), np.float32), block=256,
                          buckets=64, device="cpu")
    for dtype in ("int8", "int8f"):
        with pytest.raises(ValueError, match="ip"):
            tpk.pack_database(vecs, block=256, buckets=128, dtype=dtype,
                              metric="ip", device="cpu")
        with pytest.raises(ValueError, match="rows_valid"):
            tpk.pack_database(vecs, block=256, buckets=128, dtype=dtype,
                              rows_valid=1000, device="cpu")
    i8 = tpk.pack_database(vecs, block=256, buckets=128, dtype="int8",
                           device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        tpk.pallas_scan_knn_packed(i8, vecs[:8], k=3, q_tile=8, probes=2)
    pack = tpk.pack_database(vecs, block=256, buckets=128, device="cpu")
    import dataclasses

    bare = dataclasses.replace(pack, cent=None, rad=None)
    with pytest.raises(ValueError, match="summaries"):
        tpk.pallas_scan_knn_packed(bare, vecs[:8], k=3, q_tile=8, probes=2)


def test_wrapper_uses_plain_version_only_on_cpu():
    """A CPU tensor takes the plain version; any other device launches
    the kernel or raises (never falls back)."""
    vb = torch.zeros((2, 16, 256), dtype=torch.bfloat16)
    vn = torch.zeros((2, 1, 256))
    q = torch.zeros((8, 16), dtype=torch.bfloat16)
    before = COUNTERS["scan.launches.bf16"]
    out = tbs.bucket_scan(vn, vb, q, m=128, bits=1)
    assert out.shape == (8, 128)
    assert COUNTERS["scan.launches.bf16"] == before  # no kernel launch counted
    with pytest.raises(RuntimeError, match="no kernel"):
        tbs.bucket_scan(vn.to("meta"), vb.to("meta"), q.to("meta"), m=128,
                        bits=1)


def test_candidates_match_jax_and_contain_results():
    vecs, queries = _clustered(29, 6000, 8, 16, 24)
    jpack = jpk.pack_database(vecs, block=512, buckets=128)
    pack = tpk.pack_database(vecs, block=512, buckets=128, device="cpu")
    jc = np.asarray(jpk.pallas_scan_knn_candidates(jpack, queries, k=5,
                                                   q_tile=8))
    tc = tpk.pallas_scan_knn_candidates(pack, queries, k=5, q_tile=8)
    assert tc.shape == jc.shape  # [Q, k * oversample * block / m]
    # bucket order may differ at near-ties (accumulation order): sets
    same = sum(len(set(a) & set(b)) for a, b in zip(tc.tolist(), jc))
    assert same / jc.size >= 0.99
    rows, _ = tpk.pallas_scan_knn_packed(pack, queries, k=5, q_tile=8)
    for r, c in zip(rows.tolist(), tc.tolist()):
        assert set(r) <= set(c)


def _int_data(seed, n, d, q):
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (n, d)).astype(np.float32),
            rng.integers(-4, 5, (q, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8f"])
def test_mask_rows_vn_matches_jax(dtype):
    """Dead rows get the 3e38 sentinel, bitwise as JAX's ``_mask_vn``;
    every other tensor is shared with the unmasked pack."""
    vecs = datasets.random_uniform(1000, 12, seed=171)
    alive = np.random.default_rng(172).random(1000) >= 0.1
    jpack = jpk.pack_database(vecs, block=256, buckets=128, dtype=dtype)
    pack = _port_pack(jpack)
    masked = pack.mask_rows(alive)
    np.testing.assert_array_equal(masked.vn.numpy(),
                                  np.asarray(jpack.mask_rows(alive).vn))
    assert masked.vb is pack.vb and masked.vectors is pack.vectors
    assert masked.cent is pack.cent and masked.rad is pack.rad
    assert (masked.vn.view(-1)[:1000][~torch.from_numpy(alive)]
            == 3.0e38).all()
    assert torch.equal(masked.vn.view(-1)[1000:], pack.vn.view(-1)[1000:])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8f"])
@pytest.mark.parametrize("probes", [None, 3])
def test_masked_packed_knn_matches_jax(dtype, probes):
    """Tombstone serving over an immutable pack: ``mask_rows`` plus
    ``row_mask=`` on the integer-valued fixture. bf16: rows and distances
    bitwise equal to JAX's; int8f (queries scaled by 2/sq, sums not
    exact): equal sets, distances rtol 1e-5. No dead row is returned."""
    vecs, queries = _int_data(173, 4000, 8, 40)
    alive = np.random.default_rng(174).random(4000) >= 0.2
    jpack = jpk.pack_database(vecs, block=512, buckets=128, dtype=dtype)
    pack = tpk.pack_database(vecs, block=512, buckets=128, dtype=dtype,
                             device="cpu")
    kw = dict(k=6, q_tile=8, probes=probes)
    jr, jd = jpk.pallas_scan_knn_packed(jpack.mask_rows(alive), queries,
                                        row_mask=alive, **kw)
    tr, td = tpk.pallas_scan_knn_packed(pack.mask_rows(alive), queries,
                                        row_mask=alive, **kw)
    jr, jd = np.asarray(jr), np.asarray(jd)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(tr.numpy(), jr)
        np.testing.assert_array_equal(td.numpy(), jd)
    else:
        for a, b in zip(tr.numpy(), jr):
            assert set(a.tolist()) == set(b.tolist())
        np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5)
    got = tr.numpy()
    assert alive[got[got >= 0]].all()
    # the runtime-probes entry takes the mask too
    if probes is not None:
        rr, rd = tpk.pallas_scan_knn_packed_rt(
            pack.mask_rows(alive), queries, probes, k=6, q_tile=8,
            probes_max=5, row_mask=alive)
        assert torch.equal(rr, tr) and torch.equal(rd, td)


def test_row_mask_keeps_dead_bucket_mates_out():
    """A masked pack keeps dead rows from winning a bucket, but a bucket
    expands to block/m rows and a dead bucket-mate may ride along; the
    ``row_mask`` half keeps it out of the rerank. With one row per bucket
    (m = block) the masked pack alone suffices, and the answer equals the
    exact oracle over the live rows."""
    from vector_database_tpu_torch.ops.exact import exact_knn

    vecs = datasets.random_uniform(2000, 10, seed=175)
    queries = datasets.random_uniform(24, 10, seed=176)
    alive = np.random.default_rng(177).random(2000) >= 0.3
    pack = tpk.pack_database(vecs, block=512, buckets=128, device="cpu")
    for p in (pack, pack.mask_rows(alive)):
        rows, _ = tpk.pallas_scan_knn_packed(p, queries, k=5, q_tile=8,
                                             row_mask=alive)
        got = rows.numpy()
        assert alive[got[got >= 0]].all()
    rows, _ = tpk.pallas_scan_knn_packed(pack.mask_rows(alive), queries,
                                         k=5, q_tile=8)
    got = rows.numpy()
    assert not alive[got[got >= 0]].all()  # bucket-mates without row_mask
    one = tpk.pack_database(vecs, block=512, buckets=512, device="cpu")
    live = np.nonzero(alive)[0]
    rows, d2 = tpk.pallas_scan_knn_packed(one.mask_rows(alive), queries,
                                          k=5, q_tile=8)
    erows, ed2 = exact_knn(torch.from_numpy(vecs[live]), queries, k=5)
    for a, b in zip(rows.tolist(), erows.tolist()):
        assert set(a) == set(live[b].tolist())
    np.testing.assert_allclose(d2.numpy(), ed2.numpy(), rtol=1e-4, atol=1e-5)


def test_mask_rows_rejects_pure_int8():
    vecs = datasets.random_uniform(600, 8, seed=178)
    alive = np.ones(600, bool)
    for pkg, kw in ((jpk, {}), (tpk, dict(device="cpu"))):
        i8 = pkg.pack_database(vecs, block=256, buckets=128, dtype="int8",
                               **kw)
        with pytest.raises(ValueError, match="mask_rows"):
            i8.mask_rows(alive)
