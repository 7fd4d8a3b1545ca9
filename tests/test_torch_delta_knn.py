"""``ops.delta_knn``, the delta merge's k best, on the CPU.

On CPU tensors the wrapper runs its plain version: the blocked
difference-form distances (``exact_d2_blocked``), +inf on dead slots,
``scan_knn._lowest_k``. These tests hold that path to the composition it
replaced in ``merge_delta`` and to a numpy oracle that sorts the live
rows by (distance, slot), on integer rows where every distance is exact
and many tie, also at the k-th place, for k within a pass of the kernel
(128 places) and past it. They check that a CPU call never loads the
kernel's library, whatever ``k``, that live slots give the live mask's
answer, and the arguments the wrapper refuses.
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from vector_database_tpu_torch import DynamicIndex
from vector_database_tpu_torch.ops import delta_knn as tdk
from vector_database_tpu_torch.ops.exact import exact_d2_blocked
from vector_database_tpu_torch.ops.scan_knn import _lowest_k
from vector_database_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(2)


def _case(seed, q, r, d, span, live_share):
    rng = np.random.default_rng(seed)
    queries = rng.integers(-span, span + 1, (q, d)).astype(np.float32)
    delta = rng.integers(-span, span + 1, (r, d)).astype(np.float32)
    live = rng.random(r) < live_share
    return torch.from_numpy(queries), torch.from_numpy(delta), live


def _oracle(queries, delta, live, k):
    """The k smallest (distance, slot) pairs over the live rows, by a
    lexicographic sort of exact integer distances."""
    diff = queries.double()[:, None, :] - delta.double()[None, :, :]
    d2 = (diff * diff).sum(-1).numpy()
    slots = np.flatnonzero(live)
    out = []
    for row in d2:
        order = np.lexsort((slots, row[slots]))[:k]
        out.append((row[slots][order], slots[order]))
    return out


@pytest.mark.parametrize("q,r,d,span,live_share,k", [
    (37, 300, 16, 1, 0.6, 10),   # many equal distances, ties at the k-th
    (5, 64, 96, 2, 1.0, 32),     # every slot live, the kernel's largest k
    (64, 130, 100, 3, 0.3, 7),
    (9, 257, 130, 2, 0.8, 1),
    (12, 64, 16, 1, 0.05, 10),   # fewer live rows than k
    (11, 160, 8, 1, 1.0, 64),    # two places a lane
    (7, 300, 24, 2, 0.9, 129),   # one place past a pass
    (20, 700, 16, 1, 0.7, 200),  # ties across the two passes' seam
])
def test_plain_path_equals_blocked_mask_and_lowest_k(q, r, d, span,
                                                     live_share, k):
    queries, delta, live = _case(q + r + d, q, r, d, span, live_share)
    got_d, got_s = tdk.delta_knn(queries, delta, live, k)
    want_d, want_s = _lowest_k(torch.where(
        torch.from_numpy(live), exact_d2_blocked(queries, delta),
        float("inf")), k)
    assert torch.equal(got_d, want_d) and torch.equal(got_s, want_s)
    assert got_d.shape == (q, k) and got_s.dtype == torch.int64
    n_live = int(live.sum())
    for i, (od, os) in enumerate(_oracle(queries, delta, live, k)):
        assert np.array_equal(got_d[i, :od.size].numpy(), od.astype(
            np.float32))
        assert np.array_equal(got_s[i, :os.size].numpy(), os)
        assert torch.isinf(got_d[i, n_live:]).all()
    if span == 1 and live_share > 0.5:
        # the case holds ties that straddle the k-th place
        assert bool((got_d[:, k - 1] == got_d[:, k - 2]).any())


def test_empty_live_set_gives_only_empty_places():
    queries, delta, _ = _case(1, 6, 64, 8, 2, 1.0)
    d2, slots = tdk.delta_knn(queries, delta, np.zeros(64, bool), 10)
    assert torch.isinf(d2).all() and d2.shape == (6, 10)
    assert ((slots >= 0) & (slots < 64)).all()


@pytest.mark.parametrize("k", [3, 40])
def test_live_slots_equal_the_live_mask(k):
    """``live`` given as the ascending int32 slots, as ``merge_delta``
    passes them, gives the mask's answer bit for bit."""
    queries, delta, live = _case(3 + k, 9, 200, 12, 1, 0.4)
    slots = torch.from_numpy(np.flatnonzero(live).astype(np.int32))
    got = tdk.delta_knn(queries, delta, slots, k)
    want = tdk.delta_knn(queries, delta, live, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k_over_the_slots_gives_one_place_a_slot():
    queries, delta, live = _case(2, 4, 20, 8, 2, 0.5)
    d2, slots = tdk.delta_knn(queries, delta, live, 50)
    assert d2.shape == slots.shape == (4, 20)
    want = tdk.delta_knn_reference(queries, delta, live, 50)
    assert torch.equal(d2, want[0]) and torch.equal(slots, want[1])


@pytest.mark.parametrize("k", [1, 10, 32, 33, 129, 300])
def test_a_cpu_call_never_loads_the_kernel(monkeypatch, k):
    def refuse():
        raise AssertionError("the kernel's library was loaded")

    monkeypatch.setattr(tdk, "_load", refuse)
    queries, delta, live = _case(4 + k, 3, 256, 8, 2, 0.7)
    d2, slots = tdk.delta_knn(queries, delta, live, k)
    want = tdk.delta_knn_reference(queries, delta, live, k)
    assert torch.equal(d2, want[0]) and torch.equal(slots, want[1])


@pytest.mark.parametrize("what", ["dtype", "rank", "dims", "devices",
                                  "delta_rank", "live_shape", "live_2d",
                                  "live_dtype", "k", "k_negative",
                                  "not_a_tensor", "slots_dtype",
                                  "slots_2d"])
def test_bad_arguments_raise(what):
    queries, delta, live = _case(6, 4, 32, 8, 2, 0.5)
    k = 3
    if what == "dtype":
        queries = queries.double()
    elif what == "rank":
        queries = queries[0]
    elif what == "dims":
        queries = queries[:, :7]
    elif what == "devices":
        queries = torch.empty(queries.shape, device="meta")
    elif what == "delta_rank":
        delta = delta[None]
    elif what == "live_shape":
        live = live[:-1]
    elif what == "live_2d":
        live = live[None]
    elif what == "live_dtype":
        live = live.astype(np.int32)
    elif what == "k":
        k = 0
    elif what == "k_negative":
        k = -4
    elif what == "slots_dtype":
        live = torch.from_numpy(np.flatnonzero(live))
    elif what == "slots_2d":
        live = torch.from_numpy(np.flatnonzero(live).astype(np.int32))[None]
    else:
        queries = queries.numpy()
    with pytest.raises((ValueError, TypeError)):
        tdk.delta_knn(queries, delta, live, k)


def test_cpu_merge_launches_no_kernel():
    rng = np.random.default_rng(8)
    idx = DynamicIndex(rng.integers(-3, 4, (500, 8)).astype(np.float32),
                       leaf_size=8, rebuild_fraction=100.0, device="cpu")
    idx.add(rng.integers(-3, 4, (40, 8)).astype(np.float32))
    before = COUNTERS["dynamic.delta_knn.launches"]
    ids, d2 = idx.knn(rng.integers(-3, 4, (6, 8)).astype(np.float32), k=5)
    assert COUNTERS["dynamic.delta_knn.launches"] == before
    assert ids.shape == d2.shape == (6, 5)
