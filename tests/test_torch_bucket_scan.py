"""The bf16 scan kernel's host-side contracts, on the CPU.

The kernel itself (``csrc/bucket_scan_sm90.cu``) runs only on the card
(``tests/test_torch_cuda.py``); what it rests on is checked here:

- the fold identity that lets it keep one running minimum per output
  element instead of per-slice minima;
- the tile and shared-memory plan that sizes its CTAs (``scan_plan``)
  and the rows each CTA takes, as the kernel derives them;
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


@pytest.mark.parametrize("q_tile", [8, 104, 256, 512])
@pytest.mark.parametrize("d_pad", [32, 96, 128, 384, 1536])
def test_plan_fits_and_never_straddles_a_group(q_tile, d_pad):
    plan = tbs.scan_plan(q_tile, d_pad)
    assert plan.smem <= cuda_build.SMEM_LIMIT
    assert plan.nq in (16, 32, 64, 128) and plan.rows == 2 * plan.nq
    assert plan.kc in (16, 32, 64, 128, 256) and d_pad % plan.kc == 0
    assert tbs.MIN_STAGES <= plan.stages <= tbs.MAX_STAGES
    assert plan.smem == tbs._smem_bytes(plan.nq, d_pad, plan.kc,
                                        plan.stages)
    # the ring does not fit one more stage, or is at its cap
    assert plan.stages == tbs.MAX_STAGES or tbs._smem_bytes(
        plan.nq, d_pad, plan.kc, plan.stages + 1) > cuda_build.SMEM_LIMIT
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
