"""Segment layouts and a float64 reference for the build's segment moments
(``sorted_build.segment_moments``), shared by the CPU tests and the card
tests (this module imports no JAX)."""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def ragged_segments(rng, n, s):
    """``s`` segments over ``n`` rows as ``(start, cnt)`` int64 arrays,
    ascending and not overlapping, as the build keeps them: ragged lengths
    with gaps between them (retired leaves), about a tenth empty and a
    tenth of one to three rows starting one past a multiple of 4 (no
    sample in them where k = 4). One segment is every row (the build's
    first level)."""
    if s == 1:
        return np.zeros(1, np.int64), np.full(1, n, np.int64)
    kind = rng.random(s)
    cnt = np.zeros(s, np.int64)
    tiny = (kind >= 0.1) & (kind < 0.2)
    cnt[tiny] = rng.integers(1, 4, int(tiny.sum()))
    big = kind >= 0.2
    nb = int(big.sum())
    w = np.concatenate([rng.pareto(1.0, nb) + 1,
                        rng.pareto(1.0, s) * (rng.random(s) < 0.5)])
    room = n - 6 * int(tiny.sum())  # a tiny segment and its alignment
    parts = np.floor(w / w.sum() * room).astype(np.int64)
    cnt[big] = parts[:nb]
    gaps = parts[nb:]
    start = np.empty(s, np.int64)
    pos = 0
    for i in range(s):
        pos += gaps[i]
        if tiny[i]:
            pos += (1 - pos) % 4
        start[i] = pos
        pos += cnt[i]
    assert pos <= n
    return start, cnt


def with_orders(cases):
    """Each case (a tuple of parameters) read without a row index, under
    its own id, and through each kind of row index (``row_index``), the
    kind added to its id: ``pytest.param``s whose last value is the kind
    (None without an index)."""
    return [pytest.param(*case, order, id="-".join(
                map(str, case if order is None else case + (order,))))
            for case in cases for order in (None, "ascending", "shuffled")]


def row_index(rng, start, cnt, n, order):
    """A row index for the moments to read their rows through: None
    (``order`` None), or a permutation of the ``n`` rows as an int64
    tensor, in no order ("shuffled") or sorted inside each segment
    ("ascending", the build's: its partition is stable)."""
    if order is None:
        return None
    perm = rng.permutation(n)
    if order == "ascending":
        for a, c in zip(start, cnt):
            perm[a:a + c].sort()
    return torch.from_numpy(perm)


def float64_moments(x, start, cnt, k):
    """``(sums, sumsq, abs_sums, n_samples)`` of each segment's samples
    (rows ``j * k`` inside it) in float64 from a ``[N, D]`` f32 tensor:
    sums and sums of squares, the sums of |x| behind a summation error
    bound, and the sample counts, all on the CPU."""
    xs = x[::k].double().cpu()
    start, cnt = torch.as_tensor(start), torch.as_tensor(cnt)
    lo, hi = -(-start // k), -(-(start + cnt) // k)
    n_s = hi - lo
    seg = torch.repeat_interleave(torch.arange(len(n_s)), n_s)
    first = torch.repeat_interleave(torch.cumsum(n_s, 0) - n_s, n_s)
    rows = torch.arange(int(n_s.sum())) - first + lo[seg]
    v = xs[rows]
    out = [torch.zeros((len(n_s), xs.shape[1]), dtype=torch.float64)
           for _ in range(3)]
    for acc, part in zip(out, (v, v * v, v.abs())):
        acc.index_add_(0, seg, part)
    return (*out, n_s)


class TensorsMade(TorchDispatchMode):
    """Counts the tensors that the operations run under it make, by shape
    (views left out; an in-place write counts as its target):
    ``with TensorsMade() as made: ...``, then ``made.count[(n, d)]``."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and not func.is_view:
            self.count[tuple(out.shape)] += 1
        return out
