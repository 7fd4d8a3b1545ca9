"""The int8 and int8f packs of vector_database_tpu_torch against the JAX
package.

Both sides get the same numpy-seeded inputs. The JAX side runs its Pallas
kernels in interpret mode; the port runs the plain torch versions of its
CUDA kernels (the tensors lie on the CPU).

Tolerances, with their reasons:
- ``vb`` bitwise: both multiply by the f32-rounded ``-sq``, round half to
  even and clip (the port's pure-int8 ``vb`` is K-major, ``[nb, block,
  d_pad]``: the transpose of JAX's);
- ``sq`` equal: the same Python arithmetic on the same f32 maximum;
- the pure-int8 norm row ``vn2``: exactly equal on integer data in
  [-127, 127] (``sq = 1``, every sum is an exact integer), within 1 on
  float data (f32 sums in another order can cross a .5 before ``rint``);
- the int8f norm row and summaries: f32 sums in another order, rtol 1e-6,
  atol 1e-5;
- the pure-int8 scan: integer arithmetic, scores and block ids bitwise;
- the int8f scans: each score sums d_pad exact bf16 x int8 products in
  f32 in another order, so the bf16 path's tolerance applies (1e-5
  relative plus the encode's masking of the low ``bits`` bits);
- rerank distances: f32 sums over D in another order, rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_packed_knn import (
    _assert_acc_close,
    _clustered,
    _spy_pallas_calls,
)
from vector_database_tpu.ops import pallas_knn as jpk
from vector_database_tpu.serving import PackedServer as JaxServer
from vector_database_tpu_torch import PackedServer
from vector_database_tpu_torch.ops import bucket_scan as tbs
from vector_database_tpu_torch.ops import bucket_scan_i8 as tbi
from vector_database_tpu_torch.ops import packed_knn as tpk
from vector_database_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(2)


def _port_pack(jpack):
    arrays = dict(vb=np.asarray(jpack.vb), vn=np.asarray(jpack.vn),
                  vectors=np.asarray(jpack.vectors))
    if jpack.cent is not None:
        arrays.update(cent=np.asarray(jpack.cent), rad=np.asarray(jpack.rad))
    return tpk.PackedDB.from_numpy(arrays, dict(
        n=jpack.n, block=jpack.block, m=jpack.m, bits=jpack.bits,
        sq=jpack.sq, metric=jpack.metric), device="cpu")


def _padded(queries, q_tile, d_pad):
    q = queries.shape[0]
    qp = torch.zeros((-(-q // q_tile) * q_tile, d_pad))
    qp[:q, :queries.shape[1]] = torch.as_tensor(queries)
    return qp


@pytest.mark.parametrize("dtype", ["int8", "int8f"])
@pytest.mark.parametrize("data", ["float", "integer", "cosine"])
def test_int8_packs_match_jax(dtype, data):
    rng = np.random.RandomState(37)
    n, d = 1000, 13
    if data == "integer":
        v = rng.randint(-127, 128, (n, d)).astype(np.float32)
        v[0, 0] = 127.0  # max |v| = 127: sq = 1
    else:
        v = (rng.rand(n, d) * 2 - 1).astype(np.float32)
    metric = "cosine" if data == "cosine" else "l2"
    # d_align 16 is raised to the int8 packs' 32
    kw = dict(block=256, buckets=128, dtype=dtype, metric=metric,
              d_align=16)
    j = jpk.pack_database(v, **kw)
    t = tpk.pack_database(v, device="cpu", **kw)
    assert (t.n, t.block, t.m, t.bits) == (j.n, j.block, j.m, j.bits)
    assert t.vb.dtype == torch.int8 and t.d_pad == 32
    assert t.sq == j.sq
    if data == "integer":
        assert t.sq == 1.0
    want = np.asarray(j.vb)
    if dtype == "int8":  # K-major: each block's rows as they lie
        assert t.vb.shape == (4, 256, 32)
        want = want.transpose(0, 2, 1)
    else:
        assert t.vb.shape == (4, 32, 256)
    np.testing.assert_array_equal(t.vb.numpy(), want)
    if dtype == "int8":
        assert t.vn.dtype == torch.int32 and t.cent is None and j.cent is None
        diff = np.abs(t.vn.numpy().astype(np.int64)
                      - np.asarray(j.vn).astype(np.int64))
        assert diff.max() <= (0 if data == "integer" else 1)
        return
    for name in ("vn", "cent", "rad"):
        np.testing.assert_allclose(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            rtol=1e-6, atol=1e-5, err_msg=name,
        )


@pytest.mark.parametrize("q_tile", [8, 16])
def test_i8_scan_matches_jax_kernel(q_tile):
    """The port's quantized queries and its plain i8 scan, on the JAX
    pack loaded (and made K-major) through ``from_numpy``, equal JAX's
    interpret-mode ``_kernel_i8`` inputs and outputs bit for bit."""
    vecs, queries = _clustered(41, 3000, 20, 24, 37)
    jpack = jpk.pack_database(vecs, block=512, buckets=128, dtype="int8")
    calls, patch = _spy_pallas_calls()
    with patch:
        jpk._scan_knn_packed_impl(jpack, jnp.asarray(queries), k=4,
                                  q_tile=q_tile, interpret=True)
    (args, (score, ids)), = calls
    pack = _port_pack(jpack)
    assert pack.vb.shape == (jpack.vb.shape[0], 512, pack.d_pad)
    np.testing.assert_array_equal(pack.vb.numpy(),
                                  np.asarray(jpack.vb).transpose(0, 2, 1))
    qi = tpk._scan_queries(pack, _padded(queries, q_tile, pack.d_pad))
    np.testing.assert_array_equal(qi.numpy(), args[2])
    got_s, got_b = tbi.bucket_scan_i8(pack.vn, pack.vb, qi, m=pack.m)
    np.testing.assert_array_equal(got_s.numpy(), score.reshape(-1, pack.m))
    np.testing.assert_array_equal(got_b.numpy(), ids.reshape(-1, pack.m))
    assert len(np.unique(ids)) > 1  # the ids really vary


@pytest.mark.parametrize("mode", ["full", "static", "runtime"])
def test_int8f_scans_match_jax_kernels(mode):
    """The int8 branches of ``_kernel``, ``_kernel_pruned`` and
    ``_kernel_pruned_rt`` against the port's scan of int8 blocks."""
    vecs, queries = _clustered(43, 8000, 8, 32, 64)
    jpack = jpk.pack_database(vecs, block=512, buckets=128, dtype="int8f")
    nb = jpack.vb.shape[0]
    kw = dict(k=5, q_tile=16)
    if mode != "full":
        kw["probes"] = 3
    if mode == "runtime":
        kw["probes_max"] = nb // 2
    calls, patch = _spy_pallas_calls()
    with patch:
        jr, _ = jpk._scan_knn_packed_impl(jpack, jnp.asarray(queries),
                                          interpret=True, **kw)
    (args, acc), = calls
    pack = _port_pack(jpack)
    qp = _padded(queries, 16, pack.d_pad)
    bmap = None
    if mode != "full":
        order, bmap = tpk._block_map(pack, torch.from_numpy(queries),
                                     q_tile=16, probes=kw.get(
                                         "probes_max", 3))
        np.testing.assert_array_equal(bmap.numpy(), args[3])
        qp[:len(queries)] = qp[:len(queries)][order]
    qb = tpk._scan_queries(pack, qp)
    np.testing.assert_array_equal(qb.view(torch.int16).numpy(),
                                  args[2].view(np.int16))
    got = tbs.bucket_scan(pack.vn, pack.vb, qb, m=pack.m, bits=pack.bits,
                          bmap=bmap, nprobe=None if bmap is None else 3,
                          q_tile=None if bmap is None else 16)
    _assert_acc_close(got.numpy(), acc.reshape(-1, pack.m), pack.bits)
    tr, _ = tpk.pallas_scan_knn_packed(pack, queries, **kw)
    for a, b in zip(tr.numpy(), np.asarray(jr)):
        assert set(a.tolist()) == set(b.tolist())


@pytest.mark.parametrize("dtype", ["int8", "int8f"])
def test_pallas_scan_knn_int8_matches_jax(dtype):
    vecs, queries = _clustered(47, 16384, 32, 64, 8)
    kw = dict(k=10, block=1024, q_tile=8, dtype=dtype)
    jr, jd = jpk.pallas_scan_knn(vecs, queries, **kw)
    tr, td = tpk.pallas_scan_knn(vecs, queries, device="cpu", **kw)
    if dtype == "int8":  # exact integer selection: the same rows
        for a, b in zip(tr.numpy(), np.asarray(jr)):
            assert set(a.tolist()) == set(b.tolist())
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-6)
    jpack = jpk.pack_database(vecs, block=1024, dtype=dtype)
    pack = tpk.pack_database(vecs, block=1024, dtype=dtype, device="cpu")
    jc = np.asarray(jpk.pallas_scan_knn_candidates(jpack, queries, k=10,
                                                   q_tile=8))
    tc = tpk.pallas_scan_knn_candidates(pack, queries, k=10, q_tile=8)
    # oversample defaults to 16 on int8 blocks: [Q, 16 * k * block/m]
    assert tc.shape == jc.shape == (8, 16 * 10 * (1024 // pack.m))
    same = sum(len(set(a) & set(b)) for a, b in zip(tc.tolist(), jc))
    assert same / jc.size >= (1.0 if dtype == "int8" else 0.99)


def test_calibrate_probes_int8f_matches_jax():
    vecs, qs = _clustered(13, 20000, 8, 64, 256, sigma=0.04)
    from vector_database_tpu import build_index_fused

    lm = np.asarray(build_index_fused(vecs, leaf_size=16).vectors)
    kw = dict(block=1024, buckets=512, dtype="int8f")
    want = jpk.calibrate_probes(jpk.pack_database(lm, **kw), qs, k=10,
                                target_recall=0.9, q_tile=64)
    pack = tpk.pack_database(lm, device="cpu", **kw)
    got = tpk.calibrate_probes(pack, qs, k=10, target_recall=0.9, q_tile=64)
    assert got == want
    assert 1 <= got < pack.vb.shape[0]


@pytest.mark.parametrize("dtype", ["int8", "int8f"])
def test_packed_server_over_int8_packs(dtype):
    vecs, qs = _clustered(3, 6000, 8, 24, 40)
    kw = dict(block=512, buckets=128, dtype=dtype)
    pack = tpk.pack_database(vecs, device="cpu", **kw)
    srv = PackedServer(pack, k=5, batch=16, q_tile=16)
    rows, d2 = srv.query(qs)  # three waves, the last one padded
    want_r, want_d = tpk.pallas_scan_knn_packed(pack, qs, k=5, q_tile=16)
    assert torch.equal(rows, want_r) and torch.equal(d2, want_d)
    built = PackedServer.from_vectors(vecs, k=5, batch=16, q_tile=16,
                                      device="cpu", **kw)
    assert torch.equal(built.query(qs)[0], rows)
    jr, _ = JaxServer(jpk.pack_database(vecs, **kw), k=5, batch=16,
                      q_tile=16).query(qs)
    agree = sum(len(set(a) & set(b))
                for a, b in zip(rows.tolist(), np.asarray(jr).tolist()))
    assert agree / rows.numel() >= (1.0 if dtype == "int8" else 0.99)
    if dtype == "int8f":
        pruned = PackedServer(pack, k=5, batch=16, q_tile=16, probes=3,
                              probes_max=6)
        static = PackedServer(pack, k=5, batch=16, q_tile=16, probes=3)
        assert torch.equal(pruned.query(qs)[0], static.query(qs)[0])


def test_i8_plain_version_is_exact_past_one_f32_chunk():
    """d_pad above 1024 splits the f32 products; the sum stays exact."""
    rng = np.random.default_rng(5)
    vb = torch.from_numpy(rng.integers(-127, 128, (2, 256, 1088),
                                       dtype=np.int8))
    vn = torch.from_numpy(rng.integers(0, 2 ** 20, (2, 1, 256),
                                       dtype=np.int32))
    q = torch.from_numpy(rng.integers(-127, 128, (8, 1088), dtype=np.int8))
    scores, ids = tbi.bucket_scan_i8_reference(vn, vb, q, m=128)
    dots = q.long() @ vb.long().transpose(1, 2)  # [2, 8, 256], int64
    s = (dots + vn.long()).view(2, 8, 2, 128).amin(2)
    want_s, want_b = s.min(0)  # first minimum: ties keep block 0
    assert torch.equal(scores.long(), want_s)
    assert torch.equal(ids.long(), want_b)


def test_i8_wrapper_uses_plain_version_only_on_cpu():
    vb = torch.zeros((2, 256, 32), dtype=torch.int8)
    vn = torch.zeros((2, 1, 256), dtype=torch.int32)
    q = torch.zeros((8, 32), dtype=torch.int8)
    before = COUNTERS["scan.launches.int8"]
    scores, ids = tbi.bucket_scan_i8(vn, vb, q, m=128)
    assert scores.shape == ids.shape == (8, 128)
    assert COUNTERS["scan.launches.int8"] == before
    with pytest.raises(RuntimeError, match="no kernel"):
        tbi.bucket_scan_i8(vn.to("meta"), vb.to("meta"), q.to("meta"), m=128)
    with pytest.raises(TypeError, match="int8"):
        tbi.bucket_scan_i8(vn.float(), vb, q, m=128)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8f", "int8"])
def test_packs_of_1000_buckets_match_jax(dtype):
    """``buckets=1000``, whose default block is 1000 (a bucket count no
    64-column tile divides, and int8f rows of 1000 bytes, which TMA cannot
    stride over): the port keeps JAX's values with the block axis in rows
    padded to 1008 elements, and serves the same rows."""
    vecs, queries = _clustered(53, 2500, 13, 24, 16)
    kw = dict(buckets=1000, dtype=dtype)
    j = jpk.pack_database(vecs, **kw)
    t = tpk.pack_database(vecs, device="cpu", **kw)
    assert (t.block, t.m, t.vb.shape[0]) == (j.block, j.m, 3) and \
        t.block == t.m == 1000
    assert tbs.row_stride(t.vn) == 1008
    want = np.asarray(j.vb)
    if dtype == "int8":
        want = want.transpose(0, 2, 1)  # K-major, rows of d_pad bytes
        assert tbs.row_stride(t.vb) == t.d_pad == 128
        # vn2 rounds f32 sums taken in another order: within 1
        assert np.abs(t.vn.numpy().astype(np.int64)
                      - np.asarray(j.vn).astype(np.int64)).max() <= 1
    else:
        assert tbs.row_stride(t.vb) == 1008
        np.testing.assert_allclose(t.vn.numpy(), np.asarray(j.vn),
                                   rtol=1e-6, atol=1e-5)
    got = t.vb.view(torch.int16) if dtype == "bfloat16" else t.vb
    np.testing.assert_array_equal(got.numpy(),
                                  want.view(np.int16) if dtype == "bfloat16"
                                  else want)
    tr, _ = tpk.pallas_scan_knn_packed(t, queries, k=5, q_tile=16)
    jr, _ = jpk.pallas_scan_knn_packed(j, queries, k=5, q_tile=16)
    agree = sum(len(set(a) & set(b))
                for a, b in zip(tr.tolist(), np.asarray(jr).tolist()))
    assert agree / tr.numel() >= (1.0 if dtype == "int8" else 0.99)
