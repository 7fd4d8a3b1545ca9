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
"""

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
@pytest.mark.parametrize("q_pad,d_pad,m,span", [
    (64, 96, 512, 127),    # 64-row tile: 4 warp rows, 64 columns a CTA
    (24, 160, 256, 127),   # 8-row tile, two contraction chunks
    (8, 64, 128, 127),     # m 128: 2 warp rows, 128 columns a CTA
    (64, 32, 256, 2),      # small values: many ties between blocks
])
def test_i8_kernel_matches_plain_on_card(cuda_device, q_pad, d_pad, m, span):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    kw = dict(generator=g, device=cuda_device)
    vb = torch.randint(-span, span + 1, (5, d_pad, 1024), dtype=torch.int8,
                       **kw)
    vn = torch.randint(0, 2 * span * span + 1, (5, 1, 1024),
                       dtype=torch.int32, **kw)
    q = torch.randint(-span, span + 1, (q_pad, d_pad), dtype=torch.int8,
                      **kw)
    scores, ids = tbi.bucket_scan_i8(vn, vb, q, m=m)
    want_s, want_b = tbi.bucket_scan_i8_reference(vn, vb, q, m=m)
    assert torch.equal(scores, want_s)
    assert torch.equal(ids, want_b)


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
