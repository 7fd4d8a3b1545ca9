"""The scan kernel's host-side contracts, on the CPU.

The kernel itself (``csrc/bucket_scan_sm90.cu`` on the skeleton of
``csrc/sm90.cuh``, for bf16 and int8f packs) runs only on the card
(``tests/test_torch_cuda.py``); what it rests on is checked here:

- the fold identity that lets it keep one running minimum per output
  element instead of per-slice minima;
- the tile and shared-memory plan that sizes its CTAs (``scan_plan``, for
  bf16 and int8 tiles) and the rows each CTA takes, as the kernel derives
  them, and the shapes the kernel takes (``check_kernel_shape``);
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
                                     (16, 128)])
def test_kernel_shape_check_takes_64_column_tiles(d_pad, m):
    """A CTA owns 64 bucket columns, so ``buckets`` counts such as 64 and
    192 are served on the card (the first int8f kernel wanted 128)."""
    tbs.check_kernel_shape(d_pad, m)


@pytest.mark.parametrize("d_pad,m", [(128, 96), (128, 32), (100, 64),
                                     (8, 64)])
def test_kernel_shape_check_refuses_what_the_kernel_cannot_take(d_pad, m):
    with pytest.raises(ValueError, match="m % 64 == 0"):
        tbs.check_kernel_shape(d_pad, m)


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
