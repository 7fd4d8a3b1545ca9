"""The scan kernels' host-side contracts, on the CPU.

The kernels (``csrc/bucket_scan_sm90.cu`` for bf16 and int8f packs and
``csrc/bucket_scan_i8.cu`` for pure-int8 packs, on the skeleton of
``csrc/sm90.cuh``) run only on the card (``tests/test_torch_cuda.py``);
what they rest on is checked here:

- the fold identity that lets the float scan keep one running minimum per
  output element instead of per-slice minima, and the strict per-slice
  fold of the exact scan, mirrored in numpy against its plain version;
- the tile and shared-memory plans that size their CTAs (``scan_plan``,
  for bf16 and int8 tiles; ``i8_plan``) and the rows each CTA takes, as
  the kernel derives them, the shapes the kernels take
  (``check_kernel_shape``) and the row layout their TMA maps read
  (``row_stride``, ``pad_rows``);
- the int8 tiles' path into the tensor cores, mirrored in numpy: the
  widening of int8 to bf16, and the fragments each thread loads from the
  swizzled tile, whose rows stand for the bucket columns that the norm
  read and the store use;
- the default device of the port's entry points (``resolve_device``),
  without touching a card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vector_database_tpu_torch.ops import bucket_scan as tbs
from vector_database_tpu_torch.ops import bucket_scan_i8 as tbi
from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)


def _enc(x, b, bits):
    """The kernel's encode: the score's low ``bits`` bits replaced by
    the block id ``b``."""
    keep = np.uint32(~((1 << bits) - 1) & 0xFFFFFFFF)
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u & keep) | np.uint32(b)).view(np.float32)


def _cta_rows(plan, q_pad, q_tile):
    """``(first row, rows)`` of each CTA along the grid's x axis, as
    ``bucket_scan_sm90.cu`` derives them: ``ceil(q_tile / plan.rows)``
    CTAs per group of ``q_tile`` rows (``q_pad`` for a full scan), the
    last one ragged."""
    q_tile = q_tile or q_pad
    cpg = -(-q_tile // plan.rows)
    out = []
    for x in range((q_pad // q_tile) * cpg):
        group, i = divmod(x, cpg)
        row0 = group * q_tile + i * plan.rows
        out.append((row0, min(plan.rows, group * q_tile + q_tile - row0,
                              q_pad - row0)))
    return out


# f32 scores of both signs, and the 3e38 masked norm a dead row scores.
# Signed zeros are excluded: enc(-0.0, b) is a negative denormal and
# enc(+0.0, b) a positive one, while min(-0.0, +0.0) may return either
# zero, so the identity holds for them only up to that choice. No score
# of the scan is -0.0 (norms are >= +0.0, and +0.0 + -0.0 is +0.0).
_MASKED = float(np.float32(3.0e38))
_scores = st.one_of(
    st.floats(-1e6, 1e6, width=32, allow_nan=False, allow_infinity=False),
    st.just(_MASKED),
    st.floats(float(np.float32(2.9e38)), _MASKED, width=32),
).filter(lambda x: x != 0.0)


@settings(max_examples=300, deadline=None)
@given(scores=st.lists(_scores, min_size=1, max_size=8),
       bits=st.integers(1, 16), data=st.data())
def test_fold_identity(scores, bits, data):
    """``min_j enc(s_j, b) == enc(min_j s_j, b)`` bit for bit: ``enc``
    is monotone non-decreasing in the score for a fixed block id, so each
    slice's score can fold straight into the running minimum."""
    b = data.draw(st.integers(0, (1 << bits) - 1))
    s = np.asarray(scores, np.float32)
    folded = np.float32(3.0e38)
    for x in s:
        folded = min(folded, _enc(x, b, bits)[()])
    want = min(np.float32(3.0e38), _enc(s.min(), b, bits)[()])
    assert np.float32(folded).view(np.uint32) == \
        np.float32(want).view(np.uint32)


@pytest.mark.parametrize("esize", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("q_tile", [8, 104, 256, 512])
@pytest.mark.parametrize("d_pad", [32, 96, 128, 384, 1536])
def test_plan_fits_and_never_straddles_a_group(q_tile, d_pad, esize):
    plan = tbs.scan_plan(q_tile, d_pad, esize)
    assert plan.smem <= cuda_build.SMEM_LIMIT
    assert plan.nq in (16, 32, 64, 128) and plan.rows == 2 * plan.nq
    # int8 stages keep their A fragments in registers: kc <= 128
    assert plan.kc in (16, 32, 64, 128, 256)[esize - 1:]
    assert d_pad % plan.kc == 0
    assert tbs.MIN_STAGES <= plan.stages <= tbs.MAX_STAGES
    assert plan.smem == tbs._smem_bytes(plan.nq, d_pad, plan.kc,
                                        plan.stages, esize)
    # the ring does not fit one more stage, or is at its cap
    assert plan.stages == tbs.MAX_STAGES or tbs._smem_bytes(
        plan.nq, d_pad, plan.kc, plan.stages + 1, esize) > \
        cuda_build.SMEM_LIMIT
    if d_pad <= 128:  # narrow rows: the tallest tile that covers a group
        assert plan.rows == min(256, max(32, 1 << (q_tile - 1).bit_length()))
    groups = 3
    ctas = _cta_rows(plan, groups * q_tile, q_tile)
    covered = np.zeros(groups * q_tile, np.int64)
    for row0, rows in ctas:
        assert 1 <= rows <= plan.rows
        assert row0 // q_tile == (row0 + rows - 1) // q_tile  # one group
        covered[row0:row0 + rows] += 1
    assert (covered == 1).all()  # every row exactly once


def test_plan_of_the_main_path():
    """10M x 96 padded to 128 at q=4096 (full) and q_tile 512 (pruned):
    256-row CTAs, one 128-row chunk a slice, an 8-deep ring."""
    for rows in (4096, 512):
        assert tbs.scan_plan(rows, 128) == tbs.ScanPlan(128, 128, 8, 199816)
    assert len(_cta_rows(tbs.scan_plan(4096, 128), 4096, None)) == 16


def test_int8_plan_of_the_main_path():
    """The int8f pack of the same matrix: the same 256-row CTAs and
    128-row chunks, and stages of half the bytes (8 KB of int8 against
    16 KB of bf16) in the same 8-deep ring."""
    for rows in (4096, 512):
        assert tbs.scan_plan(rows, 128, 1) == tbs.ScanPlan(128, 128, 8,
                                                           134280)
    bf16 = tbs.scan_plan(4096, 128)
    assert bf16.smem - tbs.scan_plan(4096, 128, 1).smem == 8 * 128 * 64


@pytest.mark.parametrize("d_pad,m", [(128, 64), (96, 192), (128, 4096),
                                     (16, 128), (128, 96), (128, 32),
                                     (128, 1000), (128, 125)])
def test_kernel_shape_check_takes_64_column_tiles(d_pad, m):
    """A CTA owns 64 bucket columns and the grid takes ceil(m / 64) of
    them, the last one partial, so any bucket count is served on the card:
    multiples of 64 as before, and 96, 32, 1000 (the default block of
    ``buckets=1000``) or 125 (which no power of two divides)."""
    tbs.check_kernel_shape(d_pad, m)


@pytest.mark.parametrize("d_pad,m,msg", [
    (100, 64, "d_pad % 16 == 0"), (8, 64, "d_pad % 16 == 0"),
    (128, 0, "1 <= m"), (128, 64 * 65535 + 1, "1 <= m")])
def test_kernel_shape_check_refuses_what_the_kernel_cannot_take(d_pad, m,
                                                                 msg):
    """Partial 16-deep K steps, and bucket counts the grid's bucket axis
    (at most 65535 CTAs) cannot hold."""
    with pytest.raises(ValueError, match=msg):
        tbs.check_kernel_shape(d_pad, m)


@pytest.mark.parametrize("dtype,width", [
    (torch.int8, 1000), (torch.bfloat16, 1000), (torch.float32, 125),
    (torch.int32, 8192), (torch.int8, 96)])
def test_pad_rows_starts_every_row_on_16_bytes(dtype, width):
    """``pad_rows`` keeps the values and gives rows of ``row_pitch`` (a
    multiple of 16) elements, which ``row_stride`` accepts; a tensor whose
    rows already qualify comes back as it is."""
    x = torch.arange(2 * 3 * width).reshape(2, 3, width).to(dtype)
    p = tbs.pad_rows(x)
    assert torch.equal(p, x)
    assert tbs.row_stride(p) == tbs.row_pitch(width) == -(-width // 16) * 16
    assert tbs.row_stride(p) * p.element_size() % 16 == 0
    assert (p is x) == (width % 16 == 0)


@pytest.mark.parametrize("x", [
    torch.zeros((2, 3, 1000), dtype=torch.int8),    # rows of 1000 bytes
    torch.zeros((2, 1, 125), dtype=torch.float32),  # norm rows of 500 bytes
    torch.zeros((2, 1000, 3), dtype=torch.int8).transpose(1, 2),
    torch.zeros((2, 3, 1000), dtype=torch.bfloat16)[:, :, 1:],
])
def test_row_stride_refuses_rows_tma_cannot_read(x):
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tbs.row_stride(x)


@pytest.mark.parametrize("m,block,esizes,aligned", [
    (4096, 8192, (2, 4), True), (96, 960, (1, 4), True),
    (1000, 1000, (1, 4), True), (125, 1000, (2, 4), False),
    (200, 1000, (2, 4), True), (250, 1000, (4,), False),
    (8, 8192, (1, 4), False), (8, 8192, (2, 4), True), (4, 64, (4,), True)])
def test_slices_aligned(m, block, esizes, aligned):
    """A slice starts at j * m columns: on a 16-byte boundary for every
    element size along the block axis, or the kernels' TMA boxes cannot
    start there (m 125 and 250 in blocks of 1000 fault on the card, 200
    and 500 do not). A lone slice starts at 0."""
    assert tbs.slices_aligned(m, block, *esizes) is aligned


@pytest.mark.parametrize("m,block", [(125, 1000), (250, 1000), (4, 16),
                                     (6, 48)])
def test_pad_slices_keeps_every_bucket(m, block):
    """Where slices are off 16-byte boundaries the wrappers scan a copy in
    slices of ``row_pitch(m)`` columns at that bucket count: its first m
    columns equal the scan of the original bit for bit, for the float
    scan (full and pruned), the exact int8 scan (K-major: the block axis
    is 1) and the A/B probe's modes."""
    from vector_database_tpu_torch.benchmarks import probe_kernel_ab as tab

    rng = np.random.default_rng(m)
    nb, d, q = 3, 32, 16
    mp = tbs.row_pitch(m)
    vb = torch.from_numpy(rng.integers(-3, 4, (nb, d, block), dtype=np.int8))
    vn = torch.from_numpy(rng.integers(0, 20, (nb, 1, block))).float()
    qb = torch.from_numpy(rng.integers(-3, 4, (q, d))).bfloat16()
    pv, pb = tbs.pad_slices(vn, m, 2), tbs.pad_slices(vb.bfloat16(), m, 2)
    assert pb.shape == (nb, d, block // m * mp)
    assert torch.equal(pb.unflatten(2, (block // m, mp))[..., :m],
                       vb.bfloat16().unflatten(2, (block // m, m)))
    bmap = torch.tensor([[2, 0], [1, 2]], dtype=torch.int32)
    for kw in (dict(bits=2), dict(bits=2, bmap=bmap, nprobe=2, q_tile=8)):
        want = tbs.bucket_scan_reference(vn, vb.bfloat16(), qb, m=m, **kw)
        got = tbs.bucket_scan_reference(pv, pb, qb, m=mp, **kw)[:, :m]
        assert torch.equal(got, want)
    vk = vb.transpose(1, 2).contiguous()  # a K-major pure-int8 pack
    vn2 = vn.int()
    qi = torch.from_numpy(rng.integers(-3, 4, (q, d), dtype=np.int8))
    want = tbi.bucket_scan_i8_reference(vn2, vk, qi, m=m)
    got = tbi.bucket_scan_i8_reference(tbs.pad_slices(vn2, m, 2),
                                       tbs.pad_slices(vk, m, 1), qi, m=mp)
    assert all(torch.equal(g[:, :m], w) for g, w in zip(got, want))
    qn = torch.from_numpy(rng.integers(0, 9, (q, 1))).float()
    bits = tab.id_bits(nb, block // m)
    for mode in tab.MODES:
        want = tab.probe_kernel_ab_reference(mode, vn, vb.bfloat16(), qb, qn,
                                             m=m, bits=bits)
        got = tab.probe_kernel_ab_reference(mode, pv, pb, qb, qn, m=mp,
                                            bits=bits)
        assert torch.equal(got[:, :m], want), mode


@pytest.mark.parametrize("rows", [8, 104, 256, 4096])
@pytest.mark.parametrize("d_pad", [32, 96, 128, 160, 1536])
def test_i8_plan_fits_and_matches_its_smem_sum(rows, d_pad):
    """The exact scan's plan: [64][128 B] int8 tiles (a chunk past d_pad
    reads TMA's zero fill, so any d_pad % 16 == 0 is taken) and int8
    query rows of 128 columns; the sum is ``smem_bytes`` of
    ``csrc/sm90.cuh`` with 1-byte query elements."""
    plan = tbi.i8_plan(rows, d_pad)
    assert plan.kc == tbi.KC == 128
    assert plan.smem <= cuda_build.SMEM_LIMIT
    assert tbs.MIN_STAGES <= plan.stages <= tbs.MAX_STAGES
    nkq = -(-d_pad // 128)
    assert plan.smem == (1024 + nkq * plan.rows * 128 + plan.stages * 8192
                         + plan.stages * 256 + (2 * plan.stages + 1) * 8)
    assert plan.smem == tbs._smem_bytes(plan.nq, d_pad, 128, plan.stages, 1,
                                        qsize=1)
    assert plan.stages == tbs.MAX_STAGES or tbs._smem_bytes(
        plan.nq, d_pad, 128, plan.stages + 1, 1, qsize=1) > \
        cuda_build.SMEM_LIMIT
    if d_pad <= 256:  # narrow rows: the tallest tile that covers the rows
        assert plan.rows == min(256, max(32, 1 << (rows - 1).bit_length()))


def test_i8_plan_of_the_main_path():
    """10M x 96 padded to 128 at q=4096: 256-row CTAs (16 per 64 bucket
    columns, so the blocks cross L2 -> shared memory 16 times: 20.5 GB), one
    8 KB tile a slice in an 8-deep ring, a 32 KB query tile."""
    plan = tbi.i8_plan(4096, 128)
    assert plan == tbs.ScanPlan(128, 128, 8, 101512)
    assert len(_cta_rows(plan, 4096, None)) == 16
    with pytest.raises(ValueError, match="d_pad % 16"):
        tbi.i8_plan(64, 100)


def _strict_fold(vn, vb, q, m):
    """Mirror of ``bucket_scan_i8.cu``'s epilogue: every slice of every
    block folds straight into the running minimum in walk order (block by
    block, slice by slice), and only a strictly smaller score moves the
    block id: ``x = prod + vn2; better = x < acc; acc = better ? x : acc;
    id = better ? b : id``. int64 holds every sum exactly."""
    vn, vb, q = (np.asarray(a, np.int64) for a in (vn, vb, q))
    nb, block, _ = vb.shape
    acc = np.full((q.shape[0], m), 2 ** 31 - 1, np.int64)
    ids = np.zeros((q.shape[0], m), np.int64)
    for b in range(nb):
        s = q @ vb[b].T + vn[b]  # [q, block]
        for j in range(block // m):
            x = s[:, j * m:(j + 1) * m]
            better = x < acc
            acc = np.where(better, x, acc)
            ids = np.where(better, b, ids)
    return acc, ids


@pytest.mark.parametrize("m,block,d_pad", [(64, 256, 32), (125, 1000, 32),
                                           (96, 384, 160)])
def test_strict_slice_fold_equals_the_plain_version(m, block, d_pad):
    """On tie-heavy data (values in [-2, 2]: many blocks reach a bucket's
    minimum) the per-slice strict fold gives ``bucket_scan_i8_reference``'s
    min over slices, then strict compare per block, bit for bit: the first
    (block, slice) in walk order to reach the minimum lies in the first
    block whose own minimum equals it."""
    rng = np.random.default_rng(m + block)
    nb = 5
    vb = rng.integers(-2, 3, (nb, block, d_pad), dtype=np.int8)
    vn = rng.integers(0, 9, (nb, 1, block), dtype=np.int32)
    q = rng.integers(-2, 3, (24, d_pad), dtype=np.int8)
    scores, ids = tbi.bucket_scan_i8_reference(
        torch.from_numpy(vn), torch.from_numpy(vb), torch.from_numpy(q), m=m)
    want_s, want_b = _strict_fold(vn, vb, q, m)
    np.testing.assert_array_equal(scores.numpy(), want_s)
    np.testing.assert_array_equal(ids.numpy(), want_b)
    # ties are real here: some minimum is reached by more than one block
    s = (q.astype(np.int64) @ vb.astype(np.int64).transpose(0, 2, 1)
         + vn.astype(np.int64))  # [nb, q, block]
    per_block = s.reshape(nb, 24, block // m, m).min(axis=2)
    assert ((per_block == want_s[None]).sum(axis=0) > 1).any()
    assert len(np.unique(want_b)) > 1


# ---- numpy mirrors of the int8 tile path (csrc/sm90.cuh) ----------------

def _bf16_bits(x):
    """bf16 bit patterns of f32 values that bf16 holds exactly."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    assert not (bits & np.uint32(0xFFFF)).any(), "not exact in bf16"
    return bits >> np.uint32(16)


def _s8x2_to_bf16x2(w):
    """``s8x2_to_bf16x2``: the int8 bytes 0 and 2 of ``w`` -> a bf16
    pair: ``l * 1.0 + s`` per half with ``l = 0x4300 | low7`` (128 +
    low7) and ``s = 0xc300 | sign << 7`` (-128 (1 + sign)). The sum is
    taken exactly here and must be a bf16, so the card's rounding of the
    multiply-add cannot change it."""
    w = np.asarray(w, np.uint32)
    l = (w & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    s = (w & np.uint32(0x00800080)) | np.uint32(0xC300C300)
    lo = _bf16_halves(l)[0] + _bf16_halves(s)[0]
    hi = _bf16_halves(l)[1] + _bf16_halves(s)[1]
    return _bf16_bits(lo) | (_bf16_bits(hi) << np.uint32(16))


def _bf16_halves(word):
    """The two bf16 values of a packed word as f32: ``(low, high)``."""
    word = np.asarray(word, np.uint32)
    return ((word << np.uint32(16)).view(np.float32),
            (word & np.uint32(0xFFFF0000)).view(np.float32))


def _tile_col(esize, warp, g, h):
    """``tile_col``: the bucket column of accumulator row g + 8h of a
    warp (bf16: the descriptor's own rows; int8: adjacent columns for a
    thread's two rows)."""
    return 16 * warp + g + 8 * h if esize == 2 else 16 * warp + 2 * g + h


def _sw64(k, col):
    """Byte offset of element ``(k, col)`` of a ``[KC, 64]`` int8 tile as
    TMA's 64-byte swizzle lays it out: 16-byte chunk ``c`` of row ``k`` at
    chunk ``c ^ ((k >> 1) & 3)``."""
    return k * 64 + (((col >> 4) ^ ((k >> 1) & 3)) << 4) + (col & 15)


def test_int8_widening_is_exact_on_every_byte():
    """Every int8 value in byte 0 and in byte 2, next to every value in
    the odd bytes (which the widening ignores), gives float(x)."""
    x = np.arange(-128, 128)
    b = [np.roll(x, 37 * i) for i in range(4)]
    w = sum((v.astype(np.uint32) & np.uint32(0xFF)) << np.uint32(8 * i)
            for i, v in enumerate(b))
    lo, hi = _bf16_halves(_s8x2_to_bf16x2(w))
    np.testing.assert_array_equal(lo, b[0].astype(np.float32))
    np.testing.assert_array_equal(hi, b[2].astype(np.float32))
    lo, hi = _bf16_halves(_s8x2_to_bf16x2(w >> np.uint32(8)))
    np.testing.assert_array_equal(lo, b[1].astype(np.float32))
    np.testing.assert_array_equal(hi, b[3].astype(np.float32))


def _ldmatrix_x4_trans(smem, addrs):
    """``ldmatrix .x4 .trans`` of 8x8 16-bit matrices from byte array
    ``smem``: lane ``8j + r`` gives the byte address of row ``r`` of
    matrix ``j``; lane ``(g, tq)`` receives, per matrix, the element at
    (row 2 tq, column g) in the low half and (row 2 tq + 1, column g) in
    the high half. Returns ``[32 lanes, 4]`` uint32."""
    rows = [[smem[a:a + 16].view(np.uint16) for a in addrs[8 * j:8 * j + 8]]
            for j in range(4)]
    out = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, tq = lane // 4, lane % 4
        for j in range(4):
            out[lane, j] = np.uint32(rows[j][2 * tq][g]) | \
                (np.uint32(rows[j][2 * tq + 1][g]) << np.uint32(16))
    return out


@pytest.mark.parametrize("kc", [32, 128])
def test_int8_fragments_follow_the_column_map(kc):
    """Mirror of ``int8_fragments`` and the epilogue: each warp's
    transposed matrix loads from the swizzled tile, widened, fill the
    wgmma A operand (the m16n8k16 layout per warp) with the tile's
    transpose with rows in ``tile_col`` order, which is a bijection on
    the 64 columns; every matrix's 8 rows fall on 32 distinct banks; and
    adding the norms read at ``tile_col`` and storing at ``tile_col`` gives
    the scan's slice ``vn + q . v`` column by column."""
    rng = np.random.default_rng(kc)
    tile = rng.integers(-128, 128, (kc, 64)).astype(np.int8)
    smem = np.zeros(kc * 64, np.uint8)
    for k in range(kc):
        for col in range(64):
            smem[_sw64(k, col)] = tile[k, col].view(np.uint8)

    a = np.full((64, kc), np.nan, np.float32)  # fragment row x k
    for warp in range(4):
        base = np.array([lane * 64 + ((warp ^ ((lane >> 1) & 3)) << 4)
                         for lane in range(32)])
        for s in range(0, kc // 16, 2):
            addrs = base + s * 16 * 64
            for j in range(4):  # a matrix's 8 rows of 4 words each
                rows = addrs[8 * j:8 * j + 8]
                assert len({(a // 4 + i) % 32 for a in rows
                            for i in range(4)}) == 32
            r = _ldmatrix_x4_trans(smem, addrs)
            for lane in range(32):
                g, tq = lane // 4, lane % 4
                for i in range(4):
                    k = 16 * (s + i // 2) + 8 * (i % 2) + 2 * tq
                    for h, word in ((0, r[lane, i]),
                                    (1, r[lane, i] >> np.uint32(8))):
                        a[16 * warp + g + 8 * h, k:k + 2] = _bf16_halves(
                            _s8x2_to_bf16x2(word))

    cols = np.array([_tile_col(1, r // 16, r % 8, (r % 16) // 8)
                     for r in range(64)])
    assert sorted(cols.tolist()) == list(range(64))
    np.testing.assert_array_equal(a, tile.T[cols].astype(np.float32))

    nq = 16
    q = rng.standard_normal((kc, nq))
    vn = rng.standard_normal(64)
    prod = a.astype(np.float64) @ q  # [fragment row, query]
    out = np.full((nq, 64), np.nan)
    for warp in range(4):
        for g in range(8):
            v = (vn[_tile_col(1, warp, g, 0)], vn[_tile_col(1, warp, g, 1)])
            for h in (0, 1):
                out[:, _tile_col(1, warp, g, h)] = \
                    prod[16 * warp + g + 8 * h] + v[h]
    np.testing.assert_allclose(out, q.T @ tile.astype(np.float64) + vn,
                               rtol=1e-12, atol=1e-9)


def test_bf16_column_map_is_the_descriptors_rows():
    rows = [_tile_col(2, r // 16, r % 8, (r % 16) // 8) for r in range(64)]
    assert rows == list(range(64))


@pytest.mark.parametrize("rows,d_pad", [(64, 100), (64, 8), (0, 128),
                                        (256, 4096)])
def test_plan_rejects_shapes_it_cannot_take(rows, d_pad):
    with pytest.raises(ValueError):
        tbs.scan_plan(rows, d_pad)


@pytest.mark.parametrize("device,like,want", [
    (None, np.zeros(3, np.float32), "cuda"),
    (None, None, "cuda"),
    (None, [1.0, 2.0], "cuda"),
    (None, torch.zeros(3), "cpu"),
    ("cpu", np.zeros(3, np.float32), "cpu"),
    ("cuda", torch.zeros(3), "cuda"),
    (torch.device("cpu"), None, "cpu"),
])
def test_resolve_device(device, like, want):
    """An explicit device wins, then a tensor argument's, then the card;
    resolving allocates nothing, so it runs without a card."""
    assert resolve_device(device, like) == torch.device(want)


def test_entry_points_default_to_the_card(monkeypatch):
    """Host data with no ``device`` targets ``cuda``: on a machine without
    a card that is PyTorch's own error, never a move to the CPU."""
    from vector_database_tpu_torch import (
        BSPIndex,
        DocumentStore,
        DynamicIndex,
        PackedDB,
        build_index_fused,
        pack_database,
    )
    from vector_database_tpu_torch.ops.exact import as_f32

    seen = []

    def spy(device=None, like=None):
        out = resolve_device(device, like)
        seen.append(out)
        if out.type == "cuda":
            raise RuntimeError("would go to the card")
        return out

    for mod in ("ops.exact", "ops.packed_knn", "models.bsp", "dynamic",
                "document_store"):
        monkeypatch.setattr(f"vector_database_tpu_torch.{mod}.resolve_device",
                            spy)
    v = np.zeros((4, 2), np.float32)
    for call in (lambda: as_f32(v), lambda: build_index_fused(v),
                 lambda: pack_database(v), lambda: DynamicIndex(v),
                 lambda: DocumentStore(),
                 lambda: BSPIndex.from_numpy({}, [0, 0, 0]),
                 lambda: PackedDB.from_numpy({}, {})):
        with pytest.raises(RuntimeError, match="would go to the card"):
            call()
    assert all(d.type == "cuda" for d in seen)
    assert as_f32(v, "cpu").device.type == "cpu"
    assert DocumentStore(device="cpu")._device.type == "cpu"
