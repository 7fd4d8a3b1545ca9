"""The uint8 pack (``pack_database(dtype="uint8")``) against plain brute
force written here, with no kernel of the port.

Rows and queries are seeded integers in [0, 255], 0 and 255 among them.
The pack stores ``v - 128`` in int8 and the integer norm ``|v - 128|^2``;
the scan's score ``|v'|^2 - 2 q'.v'`` is an exact integer, so every
comparison with the int64 brute force is bitwise (block ids included: a
tie keeps the earlier block). Distances of integer rows are exact in
float32 (each is a sum of at most 128 squares of integers up to 255, below
2^24), so served distances equal the float64 ones exactly.
"""

import pytest
import torch

from vector_database_tpu_torch import PackedServer, pack_database
from vector_database_tpu_torch.ops import bucket_scan_i8 as tbi
from vector_database_tpu_torch.ops import packed_knn as tpk
from vector_database_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(2)


def _sift_like(seed, n, d, q, centres=32, top=255.0, sigma=24.0):
    """Clustered rows and queries (centres uniform in [0, top), noise
    ``sigma``), rounded and clipped to [0, 255] as SIFT's are, with the
    range's ends present: some rows and queries wholly 0 or 255, and some
    elements pushed to either end."""
    g = torch.Generator().manual_seed(seed)
    cent = torch.rand((centres, d), generator=g) * top

    def draw(count):
        x = cent[torch.randint(0, centres, (count,), generator=g)]
        x = x + sigma * torch.randn((count, d), generator=g)
        return x.round().clamp(0, 255)

    rows, queries = draw(n), draw(q)
    rows[:3], rows[3:6] = 0.0, 255.0
    queries[0], queries[1] = 0.0, 255.0
    return rows, queries


def _brute_scores(rows, queries, block, m, d_pad):
    """``(scores, ids)`` of the uint8 scan by int64 brute force: per query
    and bucket the least ``|v'|^2 - 2 q'.v'`` over the bucket's rows
    (2^30 at padded rows), and the first block that reached it."""
    n, d = rows.shape
    nb = -(-n // block)
    v = torch.zeros((nb * block, d_pad), dtype=torch.int64)
    v[:n, :d] = rows.long() - 128
    qq = torch.zeros((queries.shape[0], d_pad), dtype=torch.int64)
    qq[:, :d] = queries.long() - 128
    vn = (v * v).sum(1)
    vn[n:] = 2 ** 30
    s = vn[None, :] - 2 * (qq @ v.T)  # [Q, nb * block]
    per_block = s.view(-1, nb, block // m, m).amin(2)  # [Q, nb, m]
    best = per_block.amin(1)
    first = (per_block == best[:, None, :]).int().argmax(1)
    return best, first


@pytest.mark.parametrize("m", [64, 256])
@pytest.mark.parametrize("d", [96, 128, 100])
def test_uint8_scan_equals_integer_brute_force(d, m):
    rows, queries = _sift_like(d + m, 2500, d, 40)
    rows[1024:1124] = rows[:100]  # equal rows a block later: ties
    pack = pack_database(rows, buckets=m, block=1024, dtype="uint8")
    assert pack.dtype == "uint8" and pack.d_pad == 128
    assert pack.vb.shape == (3, 1024, 128) and pack.vb.dtype == torch.int8
    # the blocks: v - 128 as it lies, 0 past the rows and columns
    flat = pack.vb.reshape(-1, 128)
    assert torch.equal(flat[:2500, :d].long(), rows.long() - 128)
    assert not flat[2500:].any() and not flat[:, d:].any()
    norms = pack.vn.reshape(-1)
    assert torch.equal(norms[:2500].long(),
                       ((rows.long() - 128) ** 2).sum(1))
    assert (norms[2500:] == 2 ** 30).all()
    qp = torch.zeros((64, 128))
    qp[:40, :d] = queries
    qs = tpk._scan_queries(pack, qp)
    scores, ids = tbi.bucket_scan_i8(pack.vn, pack.vb, qs, m=m, uint8=True)
    want_s, want_b = _brute_scores(rows, queries, 1024, m, 128)
    assert torch.equal(scores[:40].long(), want_s)
    assert torch.equal(ids[:40].long(), want_b)


def _knn(rows, queries, k):
    """Squared distances ``[Q, n]`` and the ``k`` least of each row, by the
    expansion in float64: exact on integer data (every term is an integer
    below 2^53)."""
    q, v = queries.double(), rows.double()
    d2 = (q * q).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2 * q @ v.T
    return d2, d2.topk(k, dim=1, largest=False).values


def test_served_knn_is_exact_where_no_rows_share_a_bucket():
    """1,000 rows over 1,024 buckets, one row a bucket: the shortlist of
    40 buckets holds the 40 best rows, and the server returns the exact
    10 nearest (any of those tied at the 10th distance) with their exact
    distances."""
    rows, queries = _sift_like(3, 1000, 128, 64)
    srv = PackedServer.from_vectors(rows, k=10, batch=32, buckets=1024,
                                    block=1024, dtype="uint8", device="cpu")
    got, dist = srv.query(queries)
    d2, kth = _knn(rows, queries, 10)
    served = d2.gather(1, got)
    assert torch.equal(dist.double(), served)
    assert (served <= kth[:, 9:]).all()
    assert torch.equal(served.sort(1).values, kth)


def test_served_nearest_row_is_never_lost():
    """Many rows a bucket (20,000 rows, 256 buckets, three blocks): the
    nearest row wins its bucket and that bucket the shortlist, so every
    query is served its nearest row, with exact distances."""
    rows, queries = _sift_like(4, 20000, 128, 200)
    srv = PackedServer.from_vectors(rows, k=10, buckets=256,
                                    dtype="uint8", device="cpu")
    got, dist = srv.query(queries)
    d2, kth = _knn(rows, queries, 10)
    served = d2.gather(1, got)
    assert torch.equal(dist.double(), served)
    assert (served.amin(1) == kth[:, 0]).all()


def test_symmetric_int8_pack_loses_nearest_rows_uint8_finds():
    """On the benchmark recipe's SIFT data (centres in [0, 128), noise
    3.2), the symmetric scale keeps 128 levels of 256 and loses nearest
    rows that the uint8 pack keeps."""
    rows, queries = _sift_like(4, 20000, 128, 200, centres=20, top=128.0,
                               sigma=3.2)
    d2, kth = _knn(rows, queries, 10)
    missed = {}
    for dtype in ("uint8", "int8"):
        pack = pack_database(rows, buckets=256, dtype=dtype, device="cpu")
        got, _ = tpk.pallas_scan_knn_packed(pack, queries, k=10)
        missed[dtype] = int((d2.gather(1, got).amin(1) > kth[:, 0]).sum())
    assert missed["uint8"] == 0
    assert missed["int8"] >= 10


@pytest.mark.parametrize("bad", [256.0, -1.0, 0.5, float("nan"),
                                 float("inf")])
def test_rows_that_are_not_uint8_are_refused(bad):
    rows, _ = _sift_like(5, 300, 16, 2)
    rows[123, 7] = bad
    with pytest.raises(ValueError, match="uint8"):
        pack_database(rows, buckets=64, dtype="uint8")


def test_uint8_pack_refuses_what_it_cannot_serve():
    rows, queries = _sift_like(6, 3000, 32, 8)
    for kw in (dict(metric="cosine"), dict(metric="ip"),
               dict(rows_valid=2000)):
        with pytest.raises(ValueError, match="uint8"):
            pack_database(rows, buckets=64, dtype="uint8", **kw)
    pack = pack_database(rows, buckets=64, block=1024, dtype="uint8")
    with pytest.raises(ValueError, match="uint8"):
        pack.mask_rows(torch.ones(3000, dtype=torch.bool))
    with pytest.raises(ValueError, match="uint8"):
        tpk.pallas_scan_knn_packed(pack, queries, k=5, probes=1)
    # the default block is the int8 pack's
    assert tpk.auto_block(128, dtype="uint8") == tpk.auto_block(
        128, dtype="int8")


def test_queries_are_rounded_and_clamped_on_the_way_in():
    """Queries off the integers or out of [0, 255] score as their rounded
    and clamped values; the rerank still takes the queries as given."""
    rows, queries = _sift_like(7, 2000, 32, 16)
    pack = pack_database(rows, buckets=64, block=1024, dtype="uint8")
    odd = queries + torch.where(queries > 127, 40.3, -40.3)
    qp = torch.zeros((16, 32))
    qp[:, :] = odd
    want = torch.zeros((16, 32))
    want[:, :] = odd.round().clamp(0, 255)
    assert torch.equal(tpk._scan_queries(pack, qp),
                       tpk._scan_queries(pack, want))
    rows_out, dist = tpk.pallas_scan_knn_packed(pack, odd, k=4)
    d2 = torch.cdist(odd.double(), rows.double()) ** 2
    assert torch.allclose(dist.double(), d2.gather(1, rows_out), rtol=1e-6)


@pytest.mark.parametrize("dtype,oversample", [("uint8", 4), ("int8", 16),
                                              ("bfloat16", 4)])
def test_shortlist_counters_read_k_times_oversample_times_w(dtype,
                                                             oversample):
    rows, queries = _sift_like(8, 5000, 64, 30)
    pack = pack_database(rows, buckets=256, block=1024, dtype=dtype)
    w = pack.block // pack.m
    before = dict(COUNTERS)
    srv = PackedServer(pack, k=5, batch=16)
    srv.query(queries)
    got = {key: COUNTERS[key] - before[key] for key in COUNTERS}
    assert got["knn.shortlist_queries"] == 32  # two waves, the last padded
    assert got["knn.shortlist_rows"] == 32 * 5 * oversample * w
    assert got["scan.launches.uint8"] == got["scan.launches.int8"] == 0
