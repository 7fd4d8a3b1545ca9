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
