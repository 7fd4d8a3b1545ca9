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
Two builds of one input give the same tree. A ``ChunkedIndex`` of three
chunks serves pinned, pipelined or not, and streamed, with equal results.
On ``make_mesh()``, a world of one rank over NCCL, the sharded build and
the sharded scan of 1M x 96 float rows equal the single-device ones bit
for bit (every collective of one rank returns its input's bits). The
host-loop ``build_index`` gives one tree per input at 1M x 96, the same
tree over ``make_mesh()`` and over ``make_mesh_2d(1, 1)`` with
``dim_axis``, and ``argmax``/``argmin`` on the card keep the first index
of a tie, as the split-dimension choice needs.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu_torch.benchmarks import probe_kernel_ab as tab
from vector_database_tpu_torch.ops import bucket_scan as tbs
from vector_database_tpu_torch.ops import bucket_scan_i8 as tbi


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
    before = tbi.bucket_scan_i8.LAUNCHES
    scores, ids = tbi.bucket_scan_i8(vn, vb, q, m=m)
    assert tbi.bucket_scan_i8.LAUNCHES == before + 1
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
    before = tbs.bucket_scan.LAUNCHES
    got = tbs.bucket_scan(vn, vb, q, m=m, bits=3)
    assert tbs.bucket_scan.LAUNCHES == before + 1
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
    before = tbs.bucket_scan.LAUNCHES_INT8F
    got = tbs.bucket_scan(vn, vb, q, m=m, bits=3)
    assert tbs.bucket_scan.LAUNCHES_INT8F == before + 1
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
            before = tbs.bucket_scan.LAUNCHES
            got[flag] = [index.knn(q, k=10, **mode) for mode in modes]
            assert tbs.bucket_scan.LAUNCHES == before + 6
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
    before = bs.bucket_scan.LAUNCHES
    got_r, got_d = sharded_scan_knn(db, q, k=10, q_tile=256, probes=probes)
    torch.cuda.synchronize()
    assert bs.bucket_scan.LAUNCHES > before
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
