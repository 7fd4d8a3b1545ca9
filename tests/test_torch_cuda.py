"""The port's CUDA kernels against their plain torch versions on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so it also runs
where the card is and JAX is not:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Every comparison is bitwise: the inputs are small integers, or multiples
of a power of two small enough that every product and every f32 sum is
exact in any order, so the kernel and its plain version must agree bit
for bit (block ids included: on equal scores both keep the lower id).
The float tolerances of real data are ``chip_smoke.py``'s, at full size.
Bucket counts that no 64-column tile divides (1000, 125, 96) take a
partial tile in the grid's last CTA; int8 blocks of 1000 columns lie in
rows padded to 16 bytes (``pad_rows``), as ``pack_database`` lays them;
slices that start off 16-byte boundaries (m 125 or 250 in blocks of
1000) are scanned from a copy in aligned slices (``pad_slices``).
The build's segment-moments kernel holds to float64 sums within the
height of its summation tree, gives the same bits on every call, equals
its plain version on integer data, and runs once a level of a fused
build. Two builds of one input give the same tree, and ``BuildStats``'s
CUDA events add up to the build's time within 10%. A ``ChunkedIndex`` of three
chunks serves pinned, pipelined or not, and streamed, with equal results.
On ``make_mesh()``, a world of one rank over NCCL, the sharded build and
the sharded scan of 1M x 96 float rows equal the single-device ones bit
for bit (every collective of one rank returns its input's bits). The
host-loop ``build_index`` gives one tree per input at 1M x 96, the same
tree over ``make_mesh()`` and over ``make_mesh_2d(1, 1)`` with
``dim_axis``, and ``argmax``/``argmin`` on the card keep the first index
of a tie, as the split-dimension choice needs. The ``recall_qps`` and
``latency`` harnesses run at 100k x 96 on the card, with their recall
floors, and a latency request ends with its rows on the host.
The integer scan's uint8 form equals its plain version bit for bit on
``pack_database(dtype="uint8")`` packs, up to the benchmark cell's shapes
cut to 64 blocks, and a 1M x 128 uint8 serve holds float64 brute force:
exact distances, every nearest row served.
The delta k-NN kernel (``csrc/delta_knn.cu``) equals its plain version
on integer rows bit for bit, holds float rows to float64 within 2e-5,
and counts its launches on card merges only.
``DynamicIndex.merge_delta`` on the card equals its CPU run, a churn
sequence of ``DynamicIndex`` at 1M x 96 holds the live-set reference
(``tests/live_reference.py``) with its counters, and the
``probe_perm``, ``probe_meanid`` and ``probe_sharded_mem`` harnesses run
there with their equalities. The headline bench
(``vector_database_tpu_torch.bench``) runs every leg at 200k x 96 with
its recall floor, its world-of-one sharded rows the single-device rows.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu_torch.benchmarks import probe_kernel_ab as tab
from vector_database_tpu_torch.ops import bucket_scan as tbs
from vector_database_tpu_torch.ops import bucket_scan_i8 as tbi
from vector_database_tpu_torch.ops import sorted_build as tsb
from vector_database_tpu_torch.utils.profiling import COUNTERS

from segment_cases import (TensorsMade, float64_moments, ragged_segments,
                           row_index, with_orders)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    kw = dict(generator=g, device=cuda_device)
    # bf16 blocks in [-2, 2], queries in multiples of 1/8 in [-1, 1],
    # norms in multiples of 1/8: every sum is an exact multiple of 1/64
    vb = torch.randint(-2, 3, (5, 96, 1024), **kw).bfloat16()
    vn = torch.randint(0, 241, (5, 1, 1024), **kw) / 8.0
    q = (torch.randint(-8, 9, (64, 96), **kw) / 8.0).bfloat16()
    got = tbs.bucket_scan(vn, vb, q, m=512, bits=3)
    want = tbs.bucket_scan_reference(vn, vb, q, m=512, bits=3)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d_pad,pruned", [(96, False), (160, True)])
def test_int8f_kernel_matches_plain_on_card(cuda_device, d_pad, pruned):
    """int8 blocks (``-v*sq``) scored with bf16 queries (``q*2/sq``);
    d_pad 160 takes two contraction chunks, the second one partial."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    kw = dict(generator=g, device=cuda_device)
    # queries in multiples of 1/64 in [-2, 2]: exact sums below 2^24/64
    vb = torch.randint(-127, 128, (5, d_pad, 1024), dtype=torch.int8, **kw)
    vn = torch.randint(0, 2 ** 20, (5, 1, 1024), **kw) / 64.0
    q = (torch.randint(-128, 129, (64, d_pad), **kw) / 64.0).bfloat16()
    args = dict(m=512, bits=3)
    if pruned:  # two query groups of 32, each with its own block list
        args.update(bmap=torch.tensor([[4, 0, 2], [1, 3, 0]],
                                      dtype=torch.int32, device=cuda_device),
                    nprobe=2, q_tile=32)
    got = tbs.bucket_scan(vn, vb, q, **args)
    want = tbs.bucket_scan_reference(vn, vb, q, **args)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q_pad,d_pad,block,m,span", [
    (64, 96, 1024, 512, 127),    # 64-row CTA; a chunk past d_pad (zeros)
    (24, 160, 1024, 256, 127),   # one 32-row CTA, two contraction chunks
    (8, 64, 1024, 128, 127),     # m 128: two 64-column tiles
    (64, 32, 1024, 256, 2),      # small values: many ties between blocks
    (300, 128, 1024, 512, 127),  # 256-row CTAs, the second one partial
    (104, 128, 1000, 1000, 127),  # m 1000: a 40-column tail tile
    (64, 96, 1000, 125, 127),    # m 125, 8 slices: the tail reads slice j+1
    (256, 32, 960, 96, 2),       # m 96, ties
    (256, 128, 8192, 4096, 2),   # the main path's block and m, ties
])
def test_i8_kernel_matches_plain_on_card(cuda_device, q_pad, d_pad, block,
                                         m, span):
    """The K-major pack ([nb, block, d_pad]) through s8 wgmma: scores and
    first-block ids bitwise equal to the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    kw = dict(generator=g, device=cuda_device)
    vb = torch.randint(-span, span + 1, (5, block, d_pad), dtype=torch.int8,
                       **kw)
    vn = torch.randint(0, 2 * span * span + 1, (5, 1, block),
                       dtype=torch.int32, **kw)
    q = torch.randint(-span, span + 1, (q_pad, d_pad), dtype=torch.int8,
                      **kw)
    before = COUNTERS["scan.launches.int8"]
    scores, ids = tbi.bucket_scan_i8(vn, vb, q, m=m)
    assert COUNTERS["scan.launches.int8"] == before + 1
    want_s, want_b = tbi.bucket_scan_i8_reference(vn, vb, q, m=m)
    assert torch.equal(scores, want_s)
    assert torch.equal(ids, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d_pad", [(8, 32), (104, 96), (4096, 128),
                                        (300, 160), (512, 1536)])
def test_i8_plan_matches_kernel_layout(cuda_device, rows, d_pad):
    plan = tbi.i8_plan(rows, d_pad)
    assert tbi._load().bucket_scan_i8_smem_bytes(
        plan.nq, d_pad, plan.stages) == plan.smem


def _uint8_rows(g, n, d, dev):
    """Integer rows in [0, 255] over the whole range, 0 and 255 included,
    with every 97th row past the first 8,192 a copy of the row 8,192
    earlier (the same bucket a block earlier, so blocks tie)."""
    rows = torch.randint(0, 256, (n, d), generator=g, device=dev).float()
    rows[:2], rows[2:4] = 0.0, 255.0
    if n > 8192:
        tie = torch.arange(8192, n, 97, device=dev)
        rows[tie] = rows[tie - 8192]
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,block,m,q", [
    (64 * 8192 - 1000, 128, 8192, 4096, 1024),  # the cell's shapes, cut
    (5 * 1024 - 7, 96, 1024, 512, 300),   # 96 columns in 128, a tail CTA
    (3 * 1000, 100, 1000, 125, 104),      # m 125: slices off 16 bytes
])
def test_uint8_kernel_matches_plain_on_card(cuda_device, n, d, block, m, q):
    """A ``pack_database(dtype="uint8")`` pack scored by the kernel's uint8
    form: scores and first-block ids bitwise the plain version's, with
    ``scan.launches.uint8`` counting the launch and ``.int8`` still."""
    from vector_database_tpu_torch.ops import packed_knn as tpk

    g = torch.Generator(device=cuda_device).manual_seed(24)
    rows = _uint8_rows(g, n, d, cuda_device)
    pack = tpk.pack_database(rows, block=block, buckets=m, dtype="uint8")
    qp = torch.zeros((q, pack.d_pad), device=cuda_device)
    qp[:, :d] = torch.randint(0, 256, (q, d), generator=g,
                              device=cuda_device).float()
    qp[0, :d], qp[1, :d] = 0.0, 255.0
    qs = tpk._scan_queries(pack, qp)
    before = dict(COUNTERS)
    scores, ids = tbi.bucket_scan_i8(pack.vn, pack.vb, qs, m=m, uint8=True)
    assert COUNTERS["scan.launches.uint8"] == \
        before["scan.launches.uint8"] + 1
    assert COUNTERS["scan.launches.int8"] == before["scan.launches.int8"]
    want_s, want_b = tbi.bucket_scan_i8_reference(pack.vn, pack.vb, qs, m=m,
                                                  uint8=True)
    assert torch.equal(scores, want_s)
    assert torch.equal(ids, want_b)


@pytest.mark.cuda
def test_uint8_serve_of_1m_rows_on_card(cuda_device):
    """``PackedServer`` over a 1M x 128 uint8 pack of SIFT-like rows (the
    benchmark recipe's: centres in [0, 128), noise 3.2) against float64
    brute force: distances exact (integer rows: every f32 sum is exact),
    every nearest row served, recall@10 at SIFT's cell limit or above, and
    the integer kernel launched in its uint8 form only."""
    from vector_database_tpu_torch import PackedServer

    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(25)
    cent = torch.rand((1000, 128), generator=g, device=dev) * 128

    def draw(count):
        x = cent[torch.randint(0, 1000, (count,), generator=g, device=dev)]
        x += 3.2 * torch.randn((count, 128), generator=g, device=dev)
        return x.round_().clamp_(0, 255)

    rows, queries = draw(1_000_000), draw(2048)
    before = dict(COUNTERS)
    srv = PackedServer.from_vectors(rows, k=10, buckets=4096, dtype="uint8")
    got, dist = srv.query(queries)
    assert COUNTERS["scan.launches.uint8"] == \
        before["scan.launches.uint8"] + 2
    assert COUNTERS["scan.launches.int8"] == before["scan.launches.int8"]
    v = rows.double()
    vv = (v * v).sum(1)
    hits = 0
    for lo in range(0, 2048, 256):
        q = queries[lo:lo + 256].double()
        d2 = (q * q).sum(1)[:, None] + vv[None, :] - 2 * q @ v.T
        kth = d2.topk(10, dim=1, largest=False).values
        served = d2.gather(1, got[lo:lo + 256])
        assert torch.equal(dist[lo:lo + 256].double(), served)
        assert (served.amin(1) == kth[:, 0]).all()
        hits += int((served <= kth[:, 9:]).sum())
    assert hits / (2048 * 10) >= 0.987


@pytest.mark.cuda
@pytest.mark.parametrize("mode", tab.MODES)
def test_probe_kernel_matches_plain_on_card(cuda_device, mode):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    kw = dict(generator=g, device=cuda_device)
    vb = torch.randint(-2, 3, (3, tab.D_PAD, tab.BLOCK), **kw).bfloat16()
    vn = torch.randint(0, 9, (3, 1, tab.BLOCK), **kw).float()
    q = torch.randint(-2, 3, (256, tab.D_PAD), **kw).bfloat16()
    qn = torch.randint(0, 9, (256, 1), **kw).float()
    args = dict(m=tab.M, bits=tab.id_bits(3, tab.BLOCK // tab.M))
    got = tab.probe_kernel_ab(mode, vn, vb, q, qn, **args)
    want = tab.probe_kernel_ab_reference(mode, vn, vb, q, qn, **args)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("int8f,pruned", [(False, False), (False, True),
                                          (True, False)])
def test_kernel_matches_plain_on_masked_pack(cuda_device, int8f, pruned):
    """Tombstones: ``mask_rows`` gives dead rows the 3e38 norm sentinel.
    On exact inputs the kernel equals its plain version bitwise on the
    masked norm row, and no bucket is won by a dead row (every bucket
    keeps live rows, and a dead row scores about 3e38)."""
    from vector_database_tpu_torch.ops.packed_knn import _mask_vn

    g = torch.Generator(device=cuda_device).manual_seed(4)
    kw = dict(generator=g, device=cuda_device)
    nb, d_pad, block = 5, 96, 1024
    if int8f:
        vb = torch.randint(-127, 128, (nb, d_pad, block), dtype=torch.int8,
                           **kw)
        q = (torch.randint(-128, 129, (64, d_pad), **kw) / 64.0).bfloat16()
    else:
        vb = torch.randint(-2, 3, (nb, d_pad, block), **kw).bfloat16()
        q = (torch.randint(-8, 9, (64, d_pad), **kw) / 8.0).bfloat16()
    vn = torch.randint(0, 241, (nb, 1, block), **kw) / 8.0
    n = nb * block - 100  # the last rows are padding past n
    alive = torch.rand(n, **kw) >= 0.1
    vn = _mask_vn(vn, alive, n)
    args = dict(m=512, bits=3)
    if pruned:
        args.update(bmap=torch.tensor([[4, 0, 2], [1, 3, 0]],
                                      dtype=torch.int32, device=cuda_device),
                    nprobe=3, q_tile=32)
    got = tbs.bucket_scan(vn, vb, q, **args)
    want = tbs.bucket_scan_reference(vn, vb, q, **args)
    assert torch.equal(got, want)
    assert bool((got < 1e30).all())  # every winner is a live row


def _exact_bf16(g, dev, nb, d_pad, block, q_pad):
    """bf16 blocks in [-2, 2], queries in multiples of 1/8 in [-1, 1],
    norms in multiples of 1/8: every sum is an exact multiple of 1/64."""
    kw = dict(generator=g, device=dev)
    vb = torch.randint(-2, 3, (nb, d_pad, block), **kw).bfloat16()
    vn = torch.randint(0, 241, (nb, 1, block), **kw) / 8.0
    q = (torch.randint(-8, 9, (q_pad, d_pad), **kw) / 8.0).bfloat16()
    return vn, vb, q


@pytest.mark.cuda
@pytest.mark.parametrize("d_pad,q_pad,m", [
    (96, 64, 512),     # one CTA row of 64 queries, a partial K box
    (128, 600, 256),   # 256-row CTAs, the third one ragged; 4 slices
    (384, 300, 512),   # 64-row contraction chunks, six a slice
])
def test_bf16_kernel_full_scan_on_card(cuda_device, d_pad, q_pad, m):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    vn, vb, q = _exact_bf16(g, cuda_device, 5, d_pad, 1024, q_pad)
    before = COUNTERS["scan.launches.bf16"]
    got = tbs.bucket_scan(vn, vb, q, m=m, bits=3)
    assert COUNTERS["scan.launches.bf16"] == before + 1
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, m=m, bits=3))


@pytest.mark.cuda
@pytest.mark.parametrize("q_tile,d_pad", [(104, 128), (256, 96), (512, 384)])
def test_bf16_kernel_pruned_on_card(cuda_device, q_tile, d_pad):
    """Two query groups, each walking 3 of its 4 listed blocks; a group
    of 104 rows takes one 128-row CTA, 512 rows two of 256. Then every
    block in every group's map: equal to the full scan, bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    nb = 5
    vn, vb, q = _exact_bf16(g, cuda_device, nb, d_pad, 1024, 2 * q_tile)
    bmap = torch.tensor([[4, 0, 2, 1], [1, 3, 0, 4]], dtype=torch.int32,
                        device=cuda_device)
    args = dict(m=512, bits=3, bmap=bmap, nprobe=3, q_tile=q_tile)
    got = tbs.bucket_scan(vn, vb, q, **args)
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, **args))
    every = torch.stack([torch.randperm(nb, generator=g, device=cuda_device)
                         for _ in range(2)]).int()
    all_probes = tbs.bucket_scan(vn, vb, q, m=512, bits=3, bmap=every,
                                 nprobe=nb, q_tile=q_tile)
    assert torch.equal(all_probes, tbs.bucket_scan(vn, vb, q, m=512, bits=3))


@pytest.mark.cuda
def test_bf16_kernel_masked_norm_row_on_card(cuda_device):
    """A norm row with 3e38 entries (dead rows of a masked pack) at the
    256-row tile: bitwise equal to the plain version, no dead winner."""
    from vector_database_tpu_torch.ops.packed_knn import _mask_vn

    g = torch.Generator(device=cuda_device).manual_seed(7)
    vn, vb, q = _exact_bf16(g, cuda_device, 5, 128, 1024, 512)
    n = 5 * 1024 - 100
    alive = torch.rand(n, generator=g, device=cuda_device) >= 0.1
    vn = _mask_vn(vn, alive, n)
    got = tbs.bucket_scan(vn, vb, q, m=512, bits=3)
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, m=512,
                                                      bits=3))
    assert bool((got < 1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d_pad", [(8, 32), (104, 96), (512, 128),
                                        (4096, 384), (512, 1536)])
def test_bf16_plan_matches_kernel_layout(cuda_device, rows, d_pad):
    """The plan's shared-memory sum (computed in Python, so the CPU tests
    can check it fits) is the size the kernel lays out and launches."""
    plan = tbs.scan_plan(rows, d_pad)
    lib = tbs._load()
    assert lib.bucket_scan_sm90_smem_bytes(plan.nq, d_pad, plan.kc,
                                           plan.stages, 2) == plan.smem


def _exact_int8f(g, dev, nb, d_pad, block, q_pad):
    """int8 blocks in [-127, 127], queries in multiples of 1/64 in [-2, 2],
    norms in multiples of 1/64 below 2^14: at d_pad <= 384 every sum is
    an exact multiple of 1/64 below 2^18, which f32 holds."""
    kw = dict(generator=g, device=dev)
    vb = torch.randint(-127, 128, (nb, d_pad, block), dtype=torch.int8, **kw)
    vn = torch.randint(0, 2 ** 20, (nb, 1, block), **kw) / 64.0
    q = (torch.randint(-128, 129, (q_pad, d_pad), **kw) / 64.0).bfloat16()
    return vn, vb, q


@pytest.mark.cuda
@pytest.mark.parametrize("d_pad,q_pad,m", [
    (96, 64, 512),     # one CTA row of 64 queries, a partial K box
    (128, 600, 256),   # 256-row CTAs, the third one ragged; 4 slices
    (384, 300, 512),   # 128-row int8 chunks, three a slice
])
def test_int8f_kernel_full_scan_on_card(cuda_device, d_pad, q_pad, m):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    vn, vb, q = _exact_int8f(g, cuda_device, 5, d_pad, 1024, q_pad)
    before = COUNTERS["scan.launches.int8f"]
    got = tbs.bucket_scan(vn, vb, q, m=m, bits=3)
    assert COUNTERS["scan.launches.int8f"] == before + 1
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, m=m, bits=3))


@pytest.mark.cuda
@pytest.mark.parametrize("q_tile,d_pad", [(104, 128), (256, 96), (512, 384)])
def test_int8f_kernel_pruned_on_card(cuda_device, q_tile, d_pad):
    """As the bf16 pruned test: two query groups walking 3 of 4 listed
    blocks, then every block, equal to the full scan bitwise."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    nb = 5
    vn, vb, q = _exact_int8f(g, cuda_device, nb, d_pad, 1024, 2 * q_tile)
    bmap = torch.tensor([[4, 0, 2, 1], [1, 3, 0, 4]], dtype=torch.int32,
                        device=cuda_device)
    args = dict(m=512, bits=3, bmap=bmap, nprobe=3, q_tile=q_tile)
    got = tbs.bucket_scan(vn, vb, q, **args)
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, **args))
    every = torch.stack([torch.randperm(nb, generator=g, device=cuda_device)
                         for _ in range(2)]).int()
    all_probes = tbs.bucket_scan(vn, vb, q, m=512, bits=3, bmap=every,
                                 nprobe=nb, q_tile=q_tile)
    assert torch.equal(all_probes, tbs.bucket_scan(vn, vb, q, m=512, bits=3))


@pytest.mark.cuda
@pytest.mark.parametrize("d_pad,q_pad,q_tile", [(96, 256, None),
                                                (128, 600, None),
                                                (384, 256, None),
                                                (128, 512, 256)])
def test_int8f_kernel_equals_bf16_kernel_on_widened_blocks(
        cuda_device, d_pad, q_pad, q_tile):
    """On random bf16 queries (sums that round): the int8 tiles, widened
    to bf16 in registers, give the bf16 kernel's output on the widened
    blocks bit for bit. Both walk the same k16 steps in the same order,
    whatever chunk size each plan takes (at d_pad 384 the bf16 plan
    stages 64-row chunks, the int8 plan 128-row ones)."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    kw = dict(generator=g, device=cuda_device)
    vb = torch.randint(-127, 128, (5, d_pad, 1024), dtype=torch.int8, **kw)
    vn = torch.rand((5, 1, 1024), **kw) * 100
    q = torch.randn((q_pad, d_pad), **kw).bfloat16()
    args = dict(m=512, bits=3)
    if q_tile:
        args.update(bmap=torch.tensor([[4, 0, 2], [1, 3, 0]],
                                      dtype=torch.int32, device=cuda_device),
                    nprobe=3, q_tile=q_tile)
    assert torch.equal(tbs.bucket_scan(vn, vb, q, **args),
                       tbs.bucket_scan(vn, vb.bfloat16(), q, **args))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d_pad", [(8, 32), (104, 96), (512, 128),
                                        (4096, 384), (512, 1536)])
def test_int8f_plan_matches_kernel_layout(cuda_device, rows, d_pad):
    plan = tbs.scan_plan(rows, d_pad, 1)
    assert tbs._load().bucket_scan_sm90_smem_bytes(
        plan.nq, d_pad, plan.kc, plan.stages, 1) == plan.smem


@pytest.mark.cuda
@pytest.mark.parametrize("q_pad", [104, 1024])
@pytest.mark.parametrize("mode", tab.MODES)
def test_probe_kernel_partial_and_full_tiles_on_card(cuda_device, mode,
                                                     q_pad):
    """104 queries: one 128-row CTA, partly empty; 1024: four full
    256-row CTAs. The probe's plan (with its query-norm tile) matches the
    kernel's layout."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    kw = dict(generator=g, device=cuda_device)
    vb = torch.randint(-2, 3, (3, tab.D_PAD, tab.BLOCK), **kw).bfloat16()
    vn = torch.randint(0, 9, (3, 1, tab.BLOCK), **kw).float()
    q = torch.randint(-2, 3, (q_pad, tab.D_PAD), **kw).bfloat16()
    qn = torch.randint(0, 9, (q_pad, 1), **kw).float()
    args = dict(m=tab.M, bits=tab.id_bits(3, tab.BLOCK // tab.M))
    before = tab.probe_kernel_ab.LAUNCHES
    got = tab.probe_kernel_ab(mode, vn, vb, q, qn, **args)
    assert tab.probe_kernel_ab.LAUNCHES == before + 1
    assert torch.equal(got, tab.probe_kernel_ab_reference(mode, vn, vb, q,
                                                          qn, **args))
    plan = tbs.scan_plan(q_pad, tab.D_PAD, qn_tile=True)
    assert tab._load().probe_kernel_ab_smem_bytes(
        plan.nq, tab.D_PAD, plan.kc, plan.stages) == plan.smem


@pytest.mark.cuda
@pytest.mark.parametrize("block,m,pruned", [(1000, 1000, False),
                                            (960, 96, False),
                                            (1000, 125, False),
                                            (960, 96, True)])
def test_bf16_kernel_any_bucket_count_on_card(cuda_device, block, m, pruned):
    """Bucket counts no 64-column tile divides: the last CTA of the grid's
    bucket axis stores only its columns below m, and its boxes (norms
    included) that run into the next slice, or past the block into TMA's
    zero fill, change nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    vn, vb, q = _exact_bf16(g, cuda_device, 5, 96, block, 256)
    args = dict(m=m, bits=3)
    if pruned:
        args.update(bmap=torch.tensor([[4, 0, 2], [1, 3, 0]],
                                      dtype=torch.int32, device=cuda_device),
                    nprobe=3, q_tile=128)
    got = tbs.bucket_scan(vn, vb, q, **args)
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, **args))


@pytest.mark.cuda
@pytest.mark.parametrize("block,m,pruned", [(1000, 1000, False),
                                            (960, 96, False),
                                            (1000, 125, True)])
def test_int8f_kernel_any_bucket_count_on_card(cuda_device, block, m,
                                               pruned):
    """As the bf16 test, on int8 blocks: 1000 one-byte columns are no
    16-byte row stride, so the blocks lie in rows padded to 1008
    (``pad_rows``, as ``pack_database`` lays them); the same blocks in
    contiguous rows of 1000 bytes are refused, not misread, where the
    kernel would read them as they lie (slices on 16-byte boundaries; m
    125 scans a copy in aligned slices)."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    vn, vb, q = _exact_int8f(g, cuda_device, 5, 128, block, 256)
    args = dict(m=m, bits=3)
    if pruned:
        args.update(bmap=torch.tensor([[4, 0, 2], [1, 3, 0]],
                                      dtype=torch.int32, device=cuda_device),
                    nprobe=3, q_tile=128)
    if block % 16 and tbs.slices_aligned(m, block, 1, 4):
        with pytest.raises(ValueError, match="16-byte boundaries"):
            tbs.bucket_scan(vn, vb, q, **args)
        vb = tbs.pad_rows(vb)
        assert tbs.row_stride(vb) == 1008
    got = tbs.bucket_scan(vn, vb, q, **args)
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, **args))


@pytest.mark.cuda
@pytest.mark.parametrize("block,m", [(1000, 1000), (960, 96), (1000, 250)])
@pytest.mark.parametrize("mode", tab.MODES)
def test_probe_kernel_any_bucket_count_on_card(cuda_device, mode, block, m):
    g = torch.Generator(device=cuda_device).manual_seed(14)
    kw = dict(generator=g, device=cuda_device)
    vb = torch.randint(-2, 3, (3, tab.D_PAD, block), **kw).bfloat16()
    vn = torch.randint(0, 9, (3, 1, block), **kw).float()
    q = torch.randint(-2, 3, (256, tab.D_PAD), **kw).bfloat16()
    qn = torch.randint(0, 9, (256, 1), **kw).float()
    args = dict(m=m, bits=tab.id_bits(3, block // m))
    got = tab.probe_kernel_ab(mode, vn, vb, q, qn, **args)
    assert torch.equal(got, tab.probe_kernel_ab_reference(mode, vn, vb, q,
                                                          qn, **args))


@pytest.mark.cuda
def test_build_gives_one_tree_per_input_on_card(cuda_device):
    """Two fused builds of one seeded 1M x 96 input: every float prefix
    sum runs in an order fixed by the shapes (``prefix_sum``), so the node
    tables are equal bit for bit."""
    from vector_database_tpu_torch import build_index_fused

    g = torch.Generator(device=cuda_device).manual_seed(15)
    centers = torch.rand((1000, 96), generator=g, device=cuda_device) * 2 - 1
    x = centers[torch.randint(0, 1000, (1_000_000,), generator=g,
                              device=cuda_device)]
    x += 0.05 * torch.randn(x.shape, generator=g, device=cuda_device)
    a = build_index_fused(x, leaf_size=16)
    b = build_index_fused(x, leaf_size=16)
    assert (a.depth, a.num_leaves) == (b.depth, b.num_leaves)
    for field in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                  "orig_row"):
        ta, tb = getattr(a, field), getattr(b, field)
        assert torch.equal(ta.view(torch.int32), tb.view(torch.int32)), field


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,s,k,order", with_orders([
    (1_000_000, 96, 1, 4),
    (1_000_000, 96, 2, 4),
    (1_000_000, 96, 1000, 4),
    (1_000_000, 96, 58_823, 4),  # ~17 rows a segment: the deepest levels
    (20_000, 128, 1, 1),
    (20_000, 200, 300, 4),
    (20_000, 2052, 300, 4),  # 1026 float4 columns of partials: two passes
    (20_000, 515, 300, 1),  # 1030 float columns of partials: two passes
    (20_000, 3, 300, 1),
    (20_000, 99, 300, 4),  # scalar lanes
    (5_000, 96, 50, 1),
    (100, 96, 7, 4),
]))
def test_segment_moments_kernel_on_card(cuda_device, n, d, s, k, order):
    """The segment-moments kernel on ragged segments with gaps, empty
    segments and segments holding no sample, against float64 sums. Each
    value reaches its segment's sum through at most 512 additions in its
    tile, one a later tile's partial and 1025 more in the combine, so the
    f32 error stays within (1540 + n_s / 512) ulps of the segment's sum of
    |x| (the bound of a summation tree of that height; the squares, formed
    in fused multiply-adds, within as many ulps of their sum). A second
    call gives the same bits. On integer-valued data (squares summing below
    2^24) it equals the plain version bit for bit. Through a row index
    (``order``: the build's, ascending inside each segment, or one in no
    order) it adds in the same order: its sums are its sums on the
    gathered rows, bit for bit, with the float4 lanes and the scalar
    ones."""
    rng = np.random.default_rng(n + d + s + k)
    start, cnt = ragged_segments(rng, n, s)
    st = torch.from_numpy(start).to(cuda_device)
    ct = torch.from_numpy(cnt).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(s + d)
    x = torch.randn((n, d), generator=g, device=cuda_device)
    rows = row_index(rng, start, cnt, n, order)
    rows = None if rows is None else rows.to(cuda_device)
    xr = x if rows is None else x[rows]
    sums, sumsq = tsb.segment_moments(x, st, ct, k, rows)
    torch.cuda.synchronize()
    ref, ref2, abs_sums, n_s = float64_moments(xr, start, cnt, k)
    ulps = (1540 + n_s[:, None] / 512) * 2.0 ** -24
    assert ((sums.cpu().double() - ref).abs() <= ulps * abs_sums).all()
    assert ((sumsq.cpu().double() - ref2).abs() <= ulps * ref2).all()
    again = tsb.segment_moments(x, st, ct, k, rows)
    assert torch.equal(again[0], sums) and torch.equal(again[1], sumsq)
    if rows is not None:
        want = tsb.segment_moments(xr, st, ct, k)
        assert torch.equal(want[0], sums) and torch.equal(want[1], sumsq)

    xi = torch.clamp(torch.round(x), -3, 3)
    got = tsb.segment_moments(xi, st, ct, k, rows)
    want = tsb.segment_moments_reference(xi, st, ct, k, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_fused_build_launches_the_moments_kernel_once_a_level_on_card(
        cuda_device):
    """Every level of a fused build on the card ranks its dimensions with
    the segment-moments kernel: its launch count rises by the depth. The
    levels move a row index, not the rows, and the kernel reads its
    samples through it: the build makes one tensor of whole rows, the
    leaf-major matrix, and none of the samples."""
    from vector_database_tpu_torch import build_index_fused

    n = 1_000_000
    x, _ = _clustered_96(cuda_device, n, 29)
    before = COUNTERS["build.moments.launches"]
    with TensorsMade() as made:
        index = build_index_fused(x, leaf_size=16)
    assert COUNTERS["build.moments.launches"] - before == index.depth > 0
    assert made.count[(n, 96)] == 1 and made.count[(n // 4, 96)] == 0
    assert torch.equal(index.vectors, x[index.orig_row.long()])


@pytest.mark.cuda
def test_fused_build_of_a_transposed_view_on_card(cuda_device):
    """A view whose columns are not adjacent (a transposed ``[D, N]``
    tensor) builds the tree that its contiguous copy builds, field by
    field: the moments kernel reads a copy with adjacent columns."""
    from vector_database_tpu_torch import build_index_fused

    x, _ = _clustered_96(cuda_device, 200_000, 31)
    xt = x.T.contiguous().T
    assert xt.stride(1) != 1
    a = build_index_fused(xt, leaf_size=16)
    b = build_index_fused(x, leaf_size=16)
    assert (a.depth, a.num_leaves) == (b.depth, b.num_leaves)
    for field in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                  "orig_row"):
        ta, tb = getattr(a, field), getattr(b, field)
        assert torch.equal(ta.view(torch.int32), tb.view(torch.int32)), field


@pytest.fixture(scope="module")
def chunked_96():
    """A ChunkedIndex of 3 chunks x 50,000 x 96 clustered rows on the card
    (block 8192, 4096 buckets, d_pad 96: the chunk path's shapes), with
    256 queries from the same distribution."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from vector_database_tpu_torch import ChunkedIndex

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    centers = torch.rand((150, 96), generator=g, device=dev) * 2 - 1

    def rows(n):
        pick = torch.randint(0, 150, (n,), generator=g, device=dev)
        return centers[pick] + 0.05 * torch.randn((n, 96), generator=g,
                                                  device=dev)

    index = ChunkedIndex(leaf_size=16)
    data = rows(150_000).cpu().numpy()
    for lo in range(0, 150_000, 50_000):
        index.add_chunk(data[lo:lo + 50_000])
    return index, data, rows(256).cpu().numpy()


@pytest.mark.cuda
def test_chunked_pinned_pipeline_equals_sequential_on_card(chunked_96,
                                                           monkeypatch):
    """The pipelined pinned loop (all scans launched, shortlists copied to
    pinned host memory behind events, then the host reranks) equals the
    sequential loop bit for bit, full and pruned, over 3 chunks; and both
    equal streamed serving."""
    index, _, q = chunked_96
    assert index.num_chunks == 3 and index._chunks[0]["vb"].shape[1] == 96
    modes = [dict(), dict(probes=4)]
    streamed = [index.knn(q, k=10, **mode) for mode in modes]
    index.pin()
    try:
        got = {}
        for flag in ("1", "0"):
            monkeypatch.setenv("VDB_PIN_PIPELINE", flag)
            before = COUNTERS["scan.launches.bf16"]
            got[flag] = [index.knn(q, k=10, **mode) for mode in modes]
            assert COUNTERS["scan.launches.bf16"] == before + 6
        for a, b, s in zip(got["1"], got["0"], streamed):
            for x, y, z in zip(a, b, s):
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, z)
    finally:
        index.unpin()


@pytest.mark.cuda
def test_chunked_pinned_buffers_bf16_and_host_rerank_on_card(chunked_96):
    index, data, q = chunked_96
    index.pin()
    try:
        assert len(index._pinned) == 3
        for vb, vn in index._pinned:
            assert vb.dtype == torch.bfloat16 and vb.is_cuda
            assert vn.dtype == torch.float32
        rh, dh = index.knn(q, k=10)
        rd, dd = index.knn(q, k=10, host_rerank=False)
    finally:
        index.unpin()
    # the two reranks sum in other orders: equal sets, close distances
    assert [set(r) for r in rh.tolist()] == [set(r) for r in rd.tolist()]
    np.testing.assert_allclose(dh, dd, rtol=1e-5, atol=1e-5)
    # every returned distance is the true one of the returned row
    true = ((data[rh] - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dh, true, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("pruned", [False, True])
def test_bf16_kernel_at_chunk_shape_on_card(cuda_device, pruned):
    """d_pad 96 (the chunk path's d_align 16), block 8192, m 4096: the
    kernel's 32-row contraction chunks and zero-filled second query box,
    bitwise equal to the plain version on exact inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    vn, vb, q = _exact_bf16(g, cuda_device, 7, 96, 8192, 512)
    assert tbs.scan_plan(512, 96).kc == 32
    args = dict(m=4096, bits=3)
    if pruned:
        args.update(bmap=torch.tensor([[6, 0, 2, 5], [1, 3, 0, 4]],
                                      dtype=torch.int32, device=cuda_device),
                    nprobe=4, q_tile=256)
    got = tbs.bucket_scan(vn, vb, q, **args)
    assert torch.equal(got, tbs.bucket_scan_reference(vn, vb, q, **args))


@pytest.mark.cuda
def test_store_to_device_equals_rows_on_card(cuda_device, tmp_path):
    from vector_database_tpu_torch import NativeVectorStore

    data = np.random.default_rng(18).random((70_001, 96), np.float32)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=96) as store:
        store.append(data)
        got = store.to_device(chunk_rows=20_000)
        assert got.is_cuda and got.shape == (70_001, 96)
        np.testing.assert_array_equal(got.cpu().numpy(), data)


@pytest.fixture(scope="module")
def nccl_mesh():
    """``make_mesh()`` on the card: a world of one rank over NCCL, torn
    down after the module's mesh tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh runs over NCCL")
    import torch.distributed as dist

    from vector_database_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    yield mesh
    dist.destroy_process_group()


def _clustered_96(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.rand((n // 1000, 96), generator=g, device=dev) * 2 - 1
    x = centers[torch.randint(0, n // 1000, (n,), generator=g, device=dev)]
    q = centers[torch.randint(0, n // 1000, (512,), generator=g, device=dev)]
    return (x + 0.05 * torch.randn(x.shape, generator=g, device=dev),
            q + 0.05 * torch.randn(q.shape, generator=g, device=dev))


@pytest.mark.cuda
def test_sharded_build_equals_fused_build_on_card(nccl_mesh):
    """At one rank every collective returns its input's bits: the sharded
    build of 1M x 96 float rows is the fused build, field by field."""
    from vector_database_tpu_torch import build_index_fused
    from vector_database_tpu_torch.parallel import build_index_sharded

    x, _ = _clustered_96(torch.device("cuda"), 1_000_000, 19)
    a = build_index_fused(x, leaf_size=16)
    b = build_index_sharded(x, nccl_mesh, leaf_size=16)
    assert (a.depth, a.num_leaves, a.leaf_cap) == \
        (b.depth, b.num_leaves, b.leaf_cap)
    for field in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                  "orig_row", "vectors"):
        ta, tb = getattr(a, field), getattr(b, field)
        assert torch.equal(ta.view(torch.int32), tb.view(torch.int32)), field


@pytest.mark.cuda
@pytest.mark.parametrize("probes", [None, 16])
def test_sharded_scan_equals_single_device_scan_on_card(nccl_mesh, probes):
    """The sharded scan of a world of one is the single-device scan: ids
    equal through ``orig_rows``, distances bitwise, full and pruned."""
    from vector_database_tpu_torch import pack_database, pallas_scan_knn_packed
    from vector_database_tpu_torch.ops import bucket_scan as bs
    from vector_database_tpu_torch.parallel import (
        pack_database_sharded,
        sharded_scan_knn,
    )

    x, q = _clustered_96(torch.device("cuda"), 1_000_000, 20)
    ids = torch.randperm(x.shape[0], device=x.device).to(torch.int32)
    db = pack_database_sharded(x, nccl_mesh, buckets=4096, orig_rows=ids)
    before = COUNTERS["scan.launches.bf16"]
    got_r, got_d = sharded_scan_knn(db, q, k=10, q_tile=256, probes=probes)
    torch.cuda.synchronize()
    assert COUNTERS["scan.launches.bf16"] > before
    r, d = pallas_scan_knn_packed(pack_database(x, buckets=4096), q, k=10,
                                  q_tile=256, probes=probes)
    assert torch.equal(got_r, torch.where(r >= 0, ids[r.clamp(min=0)].long(),
                                          -1))
    assert torch.equal(got_d.view(torch.int32), d.view(torch.int32))


def _same_index(a, b):
    assert (a.depth, a.num_leaves, a.leaf_cap) == \
        (b.depth, b.num_leaves, b.leaf_cap)
    for field in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                  "orig_row", "vectors"):
        ta, tb = getattr(a, field), getattr(b, field)
        assert torch.equal(ta.view(torch.int32), tb.view(torch.int32)), field


@pytest.mark.cuda
def test_argmax_argmin_keep_the_first_tie_on_card(cuda_device):
    """Rows of exact ties (the variances of permuted columns) at the
    widths the build meets: the first tied index, on the card as on the
    CPU."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    for s, d in ((1, 8), (4096, 96), (65536, 96), (3, 1000)):
        m2 = torch.randint(0, 3, (s, d), generator=g, device=cuda_device)
        m2 = m2.float()
        col = torch.arange(d, device=cuda_device)
        for fn, best in ((torch.argmax, m2.amax(dim=1, keepdim=True)),
                         (torch.argmin, m2.amin(dim=1, keepdim=True))):
            first = torch.where(m2 == best, col, d).amin(dim=1)
            got = fn(m2, dim=1)
            assert torch.equal(got, first)
            assert torch.equal(got.cpu(), fn(m2.cpu(), dim=1))


@pytest.mark.cuda
def test_host_loop_build_gives_one_tree_per_input_on_card(cuda_device):
    """Two host-loop builds of one seeded 1M x 96 input: the segment
    totals are float64 prefix differences in an order fixed by the shapes,
    so the indexes are equal bit for bit."""
    from vector_database_tpu_torch import build_index

    x, _ = _clustered_96(cuda_device, 1_000_000, 22)
    a = build_index(x, leaf_size=16)
    b = build_index(x, leaf_size=16)
    _same_index(a, b)


@pytest.mark.cuda
def test_build_stats_times_the_levels_on_the_card(cuda_device):
    """``BuildStats`` marks each level with a CUDA event: the fused
    build's levels (all but the pass after the last call) add up to
    within 10% of the whole build timed with events around it."""
    from vector_database_tpu_torch import build_index_fused
    from vector_database_tpu_torch.utils.profiling import BuildStats

    x, _ = _clustered_96(cuda_device, 1_000_000, 23)
    build_index_fused(x, leaf_size=4)  # warm
    torch.cuda.synchronize()
    stats = BuildStats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    index = build_index_fused(x, leaf_size=4, progress=stats)
    end.record()
    end.synchronize()
    whole = start.elapsed_time(end) / 1e3
    assert len(stats.levels) == index.depth
    assert all(s.seconds > 0 for s in stats.levels[1:])
    assert abs(stats.total_seconds - whole) <= 0.1 * whole, (
        stats.total_seconds, whole)


@pytest.mark.cuda
def test_host_loop_level_on_card_equals_cpu(cuda_device):
    """One level on integer rows: every output of the card's level equals
    the CPU's bit for bit."""
    from vector_database_tpu_torch.ops.level import level_math

    g = torch.Generator().manual_seed(23)
    v = torch.randint(-6, 7, (50_000, 96), generator=g).float()
    seg = torch.randint(-1, 300, (50_000,), generator=g).int()
    leaf = torch.where(seg < 0, 3, -1).int()
    ids = torch.arange(50_000)
    for use_max in (True, False):
        cpu = level_math(v, ids, seg, leaf, use_max, 9, num_segments=512,
                         leaf_size=4)
        card = level_math(v.to(cuda_device), ids.to(cuda_device),
                          seg.to(cuda_device), leaf.to(cuda_device), use_max,
                          9, num_segments=512, leaf_size=4)
        for k in cpu:
            assert torch.equal(card[k].cpu(), cpu[k]), k


@pytest.mark.cuda
def test_host_loop_build_on_nccl_mesh_equals_single_device(nccl_mesh):
    """World size 1 over NCCL: ``build_index(mesh=make_mesh())`` and
    ``build_index(mesh=make_mesh_2d(1, 1), dim_axis="model")`` equal the
    single-device host-loop build of 1M x 96 float rows bit for bit."""
    from vector_database_tpu_torch import build_index
    from vector_database_tpu_torch.parallel import make_mesh_2d

    x, _ = _clustered_96(torch.device("cuda"), 1_000_000, 24)
    one = build_index(x, leaf_size=16)
    _same_index(build_index(x, leaf_size=16, mesh=nccl_mesh), one)
    _same_index(build_index(x, leaf_size=16, mesh=make_mesh_2d(1, 1),
                            dim_axis="model"), one)


@pytest.mark.cuda
def test_delta_merge_on_card_equals_cpu(cuda_device):
    """``DynamicIndex.merge_delta`` on the card (the delta's distances,
    its tie-exact k best and the stable merge, all on the device) equals
    its CPU run bit for bit on integer rows, where many distances tie,
    with and without ``allowed``."""
    from vector_database_tpu_torch import DynamicIndex

    rng = np.random.default_rng(25)
    main = rng.integers(-4, 5, (20_000, 16)).astype(np.float32)
    delta = rng.integers(-2, 3, (3_000, 16)).astype(np.float32)
    q = rng.integers(-2, 3, (300, 16)).astype(np.float32)
    allowed = rng.choice(23_000, 5_000, replace=False)
    ref = DynamicIndex(main, leaf_size=16, device="cpu")
    top = ref.knn(q, k=10)
    out = {}
    for dev in ("cpu", cuda_device):
        idx = DynamicIndex(main, leaf_size=16, rebuild_fraction=100.0,
                           device=dev)
        idx.add(delta)
        qd = torch.as_tensor(q, device=dev)
        out[str(dev)] = [idx.merge_delta(qd, *top, 10),
                         idx.merge_delta(qd, *top, 10, allowed=allowed)]
    for (ci, cd), (gi, gd) in zip(out["cpu"], out["cuda"]):
        assert np.array_equal(ci, gi) and np.array_equal(cd, gd)
    ids, d2 = out["cpu"][0]
    assert (d2[:, :-1] == d2[:, 1:]).any() and (ids >= 20_000).any()


@pytest.mark.cuda
def test_dynamic_churn_on_card_holds_the_live_set(cuda_device):
    """``DynamicIndex`` at 1M x 96 on the card through a few churn cycles
    (1% removed, a 1,000-row delta, adds of 100, then the oldest add and
    10 built ids removed), served packed and held to the plain live-set
    reference: no removed id served, every probe near the last add finds
    its nearest live row, served distances exact (float32 differences,
    rtol 1e-5), recall@10 >= 0.97, and the dynamic counters rise by the
    cycles' counts."""
    from live_reference import LiveSet

    from vector_database_tpu_torch import DynamicIndex

    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(19)
    n, d, k, step, cycles = 1_000_000, 96, 10, 100, 4
    cent = torch.rand((1000, d), generator=g, device=dev) * 2 - 1

    def unit(x):
        return x / x.norm(dim=1, keepdim=True)

    def draw(m):
        pick = torch.randint(0, 1000, (m,), generator=g, device=dev)
        return unit(cent[pick] + 0.05 * torch.randn((m, d), generator=g,
                                                    device=dev))

    rows = draw(n)
    idx = DynamicIndex(rows, leaf_size=16)
    live = LiveSet(dev)
    live.add(rows)
    order = torch.randperm(n, generator=g, device=dev).cpu().numpy()
    assert idx.remove_ids(order[:10_000]) == live.remove_ids(order[:10_000])
    adds = []
    for _ in range(10):
        r = draw(step)
        ids = idx.add(r.cpu().numpy())
        assert np.array_equal(ids, live.add(r).cpu().numpy())
        adds.append((ids, r))
    before = dict(COUNTERS)
    hits = total = 0
    for c in range(cycles):
        near = adds[-1][1] + 0.002 * torch.randn((step, d), generator=g,
                                                 device=dev)
        q = torch.cat([draw(1900), unit(near)])
        ids, d2 = idx.knn(q.cpu().numpy(), k=k, exact=False, packed=True)
        served = torch.as_tensor(ids, device=dev)
        assert live.is_live(served).all(), "a removed id was served"
        want = live.distances(q, served).cpu().numpy()
        np.testing.assert_allclose(d2, want, rtol=1e-5, atol=0)
        truth_i, truth_d = live.knn(q, k)
        assert (served[1900:] == truth_i[1900:, :1]).any(dim=1).all()
        got_d = live.distances(q, served)
        hits += int((got_d <= truth_d[:, k - 1:k] * (1 + 1e-9)).sum())
        total += served.numel()
        r = draw(step)
        ids = idx.add(r.cpu().numpy())
        assert np.array_equal(ids, live.add(r).cpu().numpy())
        adds.append((ids, r))
        gone = np.concatenate([adds.pop(0)[0],
                               order[10_000 + 10 * c:10_000 + 10 * (c + 1)]])
        assert idx.remove_ids(gone) == live.remove_ids(gone) == step + 10
    assert hits / total >= 0.97
    got = {key: COUNTERS[key] - before[key] for key in COUNTERS
           if key.startswith("dynamic.")}
    assert got == {
        "dynamic.rows_added": cycles * step,
        "dynamic.rows_removed": cycles * (step + 10),
        "dynamic.main_views": cycles,  # one a request after a removal
        "dynamic.delta_rows": cycles * 10 * step,
        "dynamic.delta_slots": cycles * 1024,
        "dynamic.compactions": 0,
        "dynamic.delta_knn.launches": cycles * 2,  # a pass and its join
    }


def _int_delta_case(dev, seed, q, r, d, span, live_share):
    g = torch.Generator(device=dev).manual_seed(seed)
    queries = torch.randint(-span, span + 1, (q, d), generator=g,
                            device=dev).float()
    delta = torch.randint(-span, span + 1, (r, d), generator=g,
                          device=dev).float()
    live = (torch.rand(r, generator=g, device=dev) < live_share).cpu()
    return queries, delta, live.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("q,r,d,span,live_share,k", [
    (300, 3000, 16, 1, 0.6, 10),      # many ties, several straddling the k-th
    (1000, 16384, 96, 2, 0.61, 10),   # the churn cell's padded delta
    (77, 1000, 100, 3, 0.5, 32),      # the largest k
    (1, 5000, 130, 2, 1.0, 7),        # one query: the rows split 27 ways
    (4097, 100, 16, 1, 1.0, 10),      # one tile of rows: a single split
    (513, 129, 96, 1, 0.9, 1),        # a partial second tile
    (200, 64, 16, 2, 0.07, 10),       # fewer live rows than k
    (65, 300, 7, 2, 0.0, 10),         # no live row
    (40, 300, 0, 1, 0.5, 10),         # no dimension: every distance 0
    (100, 3000, 16, 1, 0.6, 40),      # two places a lane
    (64, 2000, 96, 2, 0.8, 100),      # four places a lane
    (33, 1500, 20, 1, 0.9, 300),      # three passes, ties at the seams
    (10, 200, 16, 1, 0.5, 150),       # a second pass past the live rows
    (5, 1000, 8, 1, 1.0, 1000),       # k = R: eight passes
])
def test_delta_knn_kernel_equals_plain_on_integer_rows(
        cuda_device, q, r, d, span, live_share, k):
    """The delta k-NN kernel against its plain version on integer rows,
    where every f32 distance is exact: the distances bit for bit, and the
    slots wherever the place is filled (a live row), through ties that
    straddle the k-th place, dead slots, fewer live rows than ``k``,
    ``D`` off the 32-dimension chunk and off 4 (4-byte copies) and 0,
    ``Q`` off the 64-query CTA and ``R`` off the 128-row tile and the
    split, and ``k`` of one, two and four places a lane and past a pass
    of 128 places (each pass after the first takes the pairs after the
    last place of the one before). The places past the live rows hold
    (+inf, -1). A second call gives the same bits."""
    from vector_database_tpu_torch.ops import delta_knn as tdk

    queries, delta, live = _int_delta_case(cuda_device, q + r + d, q, r, d,
                                           span, live_share)
    before = COUNTERS["dynamic.delta_knn.launches"]
    got_d, got_s = tdk.delta_knn(queries, delta, live, k)
    torch.cuda.synchronize()
    passes = -(-min(k, r) // 128)
    assert COUNTERS["dynamic.delta_knn.launches"] - before == 2 * passes
    want_d, want_s = tdk.delta_knn_reference(queries, delta, live, k)
    assert got_d.shape == got_s.shape == (q, min(k, r))
    assert torch.equal(got_d, want_d)
    filled = torch.isfinite(want_d)
    assert torch.equal(got_s[filled], want_s[filled])
    assert (got_s[~filled] == -1).all()
    assert int(filled.sum(1).min()) == min(k, int(live.sum()))
    again = tdk.delta_knn(queries, delta, live, k)
    assert torch.equal(again[0], got_d) and torch.equal(again[1], got_s)


@pytest.mark.cuda
def test_delta_knn_kernel_on_float_rows_on_card(cuda_device):
    """10,000 queries against the churn cell's delta (16,384 slots,
    10,000 live) of float rows, k = 10, half the queries near-duplicates
    of live rows (noise 0.002 a dimension, where the matrix-product
    expansion cancels): each served distance within 2e-5 relative of the
    float64 difference form of its row, and the ids those of the plain
    version wherever the k-th and (k+1)-th plain distances differ by
    more than that."""
    from vector_database_tpu_torch.ops import delta_knn as tdk

    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(20)
    q, r, n_live, d, k = 10_000, 16_384, 10_000, 96, 10
    rows = torch.randn((n_live, d), generator=g, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    delta = torch.zeros((r, d), device=dev)
    delta[:n_live] = rows
    live = np.zeros(r, bool)
    live[:n_live] = True
    pick = torch.randint(0, n_live, (q // 2,), generator=g, device=dev)
    queries = torch.cat([
        rows[pick] + 0.002 * torch.randn((q // 2, d), generator=g,
                                         device=dev),
        torch.randn((q - q // 2, d), generator=g, device=dev) * 0.1])
    got_d, got_s = tdk.delta_knn(queries, delta, live, k)
    assert (got_s >= 0).all() and (got_s < n_live).all()
    exact = ((queries.double()[:, None, :] - delta.double()[got_s]) ** 2
             ).sum(-1)
    assert ((got_d.double() - exact).abs() <= 2e-5 * exact).all()
    want_d, want_s = tdk.delta_knn_reference(queries, delta, live, k + 1)
    clear = (want_d[:, k] - want_d[:, k - 1]) > 2e-5 * want_d[:, k]
    assert float(clear.float().mean()) > 0.99
    assert torch.equal(got_s[clear].sort(1).values,
                       want_s[clear, :k].sort(1).values)
    assert torch.equal(got_s[:q // 2, 0], pick)


@pytest.mark.cuda
def test_delta_knn_launches_count_the_card_merges(cuda_device):
    """``dynamic.delta_knn.launches`` rises on a merge on the card, by two
    (a pass and its join) at k = 10 and by four (two passes) at k = 200,
    and not on a CPU merge; the card merge serves the delta rows the CPU
    merge serves, at both."""
    from vector_database_tpu_torch import DynamicIndex

    rng = np.random.default_rng(20)
    main = rng.integers(-4, 5, (5_000, 16)).astype(np.float32)
    delta = rng.integers(-2, 3, (300, 16)).astype(np.float32)
    q = rng.integers(-2, 3, (100, 16)).astype(np.float32)
    counts, merged = {}, {}
    for dev in ("cpu", cuda_device):
        idx = DynamicIndex(main, leaf_size=16, rebuild_fraction=100.0,
                           device=dev)
        idx.add(delta)
        for k in (10, 200):
            before = COUNTERS["dynamic.delta_knn.launches"]
            ids = np.full((len(q), k), -1, np.int64)
            d2 = np.full((len(q), k), np.inf, np.float32)
            merged[str(dev), k] = idx.merge_delta(q, ids, d2, k)
            counts[str(dev), k] = (COUNTERS["dynamic.delta_knn.launches"]
                                   - before)
    assert counts["cpu", 10] == counts["cpu", 200] == 0
    assert counts["cuda", 10] == 2 and counts["cuda", 200] == 4
    for k in (10, 200):
        (ci, cd), (gi, gd) = merged["cpu", k], merged["cuda", k]
        assert np.array_equal(np.asarray(cd), np.asarray(gd))
        assert np.array_equal(np.asarray(ci), np.asarray(gi))


def _harness_lines(name, argv):
    import contextlib
    import importlib
    import io
    import json

    mod = importlib.import_module(
        f"vector_database_tpu_torch.benchmarks.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    return [json.loads(x) for x in out.getvalue().splitlines()
            if x.startswith("{")]


@pytest.mark.cuda
def test_recall_qps_harness_on_card(cuda_device):
    """``recall_qps`` at 100k x 96 on the card: the packed scan's recall@10
    against the exact oracle, and the kernel launched."""
    COUNTERS["scan.launches.bf16"] = 0
    lines = _harness_lines("recall_qps", ["--n", "100000", "--q", "1024",
                                          "--reps", "2", "--probes", "8"])
    report = lines[-1]
    assert lines[0]["device"] == report["device"] != "cpu"
    assert report["pallas_recall"] >= 0.98, report
    # the streaming bf16 scan_knn shortlists 4 x 256 buckets a block of
    # 65536 rows: 0.977 at 1M (chip_smoke.py phase 14)
    assert report["scan_bf16_recall"] >= 0.95, report
    assert report["pallas_qps"] > 0 and report["build_vps"] > 0
    assert lines[1]["probes"]["probes"] == 8
    assert COUNTERS["scan.launches.bf16"] > 0


@pytest.mark.cuda
def test_latency_harness_on_card(cuda_device, monkeypatch):
    """``latency`` at 100k x 96: full-mode recall@10 >= 0.98 at every batch
    size, p99 >= p50 > 0, and a request's window ends with the rows on
    the host."""
    from vector_database_tpu_torch import PackedServer, pack_database
    from vector_database_tpu_torch.benchmarks import latency

    monkeypatch.setenv("VDB_LAT_BATCHES", "32,1024")
    lines = _harness_lines("latency", ["--n", "100000", "--calls", "5",
                                       "--reps", "3", "--probes", "4"])
    assert lines[0]["blocks"] == 13
    full = [x for x in lines[1:] if x["mode"] == "full"]
    assert [x["batch"] for x in full] == [32, 1024]
    for x in lines[1:]:
        assert x["lat_p99_ms"] >= x["lat_p50_ms"] > 0
    assert all(x["recall"] >= 0.98 for x in full)
    srv = PackedServer(pack_database(torch.rand((5000, 16), device="cuda")),
                       k=5, batch=8)
    rows, d2 = latency._request(srv, np.random.rand(8, 16).astype(np.float32))
    assert rows.device.type == d2.device.type == "cpu"


@pytest.mark.cuda
def test_perm_meanid_and_sharded_mem_harnesses_on_card(cuda_device):
    """``probe_perm``, ``probe_meanid`` and ``probe_sharded_mem`` on the
    card: each asserts its own equalities (three equal inverses, every
    id-sum formulation exact, one tree single-device and sharded); the
    peaks come from the allocator."""
    perm = _harness_lines("probe_perm", ["1000000"])
    assert perm[0]["device"] != "cpu" and perm[1]["scatter_ms"] > 0
    meanid = _harness_lines("probe_meanid", ["--n", "1000000", "--reps",
                                             "2"])[-1]
    assert meanid["variants_exact"] and meanid["int64_ms"] > 0
    mem = _harness_lines("probe_sharded_mem", ["--n", "200000"])[1:]
    assert [x["variant"] for x in mem] == ["single_donate", "sharded_donate"]
    assert all(x["peak_gib"] > 0 for x in mem)


@pytest.mark.cuda
def test_headline_bench_on_card(cuda_device):
    """``vector_database_tpu_torch.bench`` at 200k x 96 on the card
    (q=1024, probes 4 and 8, every leg): one JSON line, return value 0,
    no error field, full recall@10 >= 0.98, the world-of-one sharded rows
    bitwise the single-device rows, the scan kernel launched."""
    import contextlib
    import io
    import json

    from vector_database_tpu_torch import bench

    COUNTERS["scan.launches.bf16"] = 0
    rows, out = {}, io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = bench.main(env=dict(VDB_BENCH_N="200000", VDB_BENCH_Q="1024",
                                  VDB_BENCH_PROBES="4,8"), rows_out=rows)
    (line,) = [json.loads(x) for x in out.getvalue().splitlines()]
    assert ret == 0 and not [k for k in line if k.endswith("_error")], line
    assert line["serve_full_recall"] >= 0.98, line
    assert [x["probes"] for x in line["serve_pruned"]] == [4, 8]
    assert line["serve_sharded_full_recall"] == line["serve_full_recall"]
    p = line["serve_sharded_pruned"]["probes"]
    for sharded, single in (("sharded_full", "full"),
                            ("sharded_pruned", f"pruned_{p}")):
        for got, want in zip(rows[sharded], rows[single]):
            assert torch.equal(got, want), sharded
    assert COUNTERS["scan.launches.bf16"] > 0
