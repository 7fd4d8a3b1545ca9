"""``DynamicIndex`` through a seeded sequence of churn cycles, held to the
plain live-set reference (``tests/live_reference.py``).

A cycle is the benchmark cell ``deep96.churn``'s, scaled down: a request
of fresh queries and of probes near the rows added and removed in the
cycle before, an add of fresh rows, and a ``remove_ids`` of the oldest
added ids (so the delta keeps its size) and of a few built ids. The rows
are clustered and of unit length, as the cell's are; the reference is
exact float64 over the rows live when each request was sent.

Tolerances, and why:

- distances in packed mode: ``rtol`` 1e-5. The packed rerank and the
  delta merge sum 96 squared differences in float32, whose rounding
  stays below ``D * eps`` = 96 x 6e-8 of the distance; the reference's
  are float64.
- distances in exact mode: ``atol`` 1.2e-5. The exact scan of the main
  segment scores ``|x|^2 + |q|^2 - 2 q.x`` in float32, whose rounding is
  bounded by ``D * eps * (|x|^2 + |q|^2)`` = 96 x 6e-8 x 2 on unit rows,
  however small the distance.
- ids in exact mode: the same set, except where the reference's ``k``-th
  and ``k + 1``-th distances lie within twice that tolerance (a tie at
  the cut, which float32 may break either way).
- recall@10 in packed mode: at least ``PACKED_RECALL`` (0.98). The bf16
  bucketed scan loses a true neighbour when a closer one shares its
  bucket or rounding pushes its bucket below the shortlist's cut; read at
  0.995-0.997 on seeds 1-4 and 11, at 20,000 rows and 4,096 buckets.
"""

import numpy as np
import pytest
import torch

from live_reference import LiveSet
from vector_database_tpu_torch import DynamicIndex
from vector_database_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(2)

N, D, K = 20_000, 96, 10
REMOVED_AT_START = 200  # 1%
STEP = 20  # rows an add; the delta holds DELTA rows
DELTA = 200
REMOVE_MAIN = 2
QUERIES, PROBES = 200, 10  # a request: fresh queries + probes near adds
SIGMA = 0.002  # the probes' noise, per dimension
RTOL = 1e-5
ATOL_EXACT = 1.2e-5
PACKED_RECALL = 0.98


def _unit(x):
    return x / x.norm(dim=1, keepdim=True)


class Data:
    """Clustered unit rows and queries from one seed."""

    def __init__(self, seed):
        self.g = torch.Generator().manual_seed(seed)
        self.cent = torch.rand((64, D), generator=self.g) * 2 - 1

    def draw(self, count):
        pick = torch.randint(0, 64, (count,), generator=self.g)
        return _unit(self.cent[pick] + 0.05 * torch.randn(
            (count, D), generator=self.g))

    def near(self, rows, count):
        pick = torch.randperm(rows.shape[0], generator=self.g)[:count]
        return _unit(rows[pick] + SIGMA * torch.randn(
            (count, D), generator=self.g))


class Churn:
    """The program and the reference, driven through the same cycles."""

    def __init__(self, seed):
        self.data = Data(seed)
        rows = self.data.draw(N)
        self.index = DynamicIndex(rows, leaf_size=16, device="cpu")
        self.live = LiveSet("cpu")
        self.live.add(rows)
        rng = np.random.default_rng(seed)
        self.main_order = rng.permutation(N)
        self.main_next = REMOVED_AT_START
        self._remove(self.main_order[:REMOVED_AT_START])
        self.removed_rows = rows[self.main_order[:REMOVED_AT_START]]
        self.adds = []  # (ids, rows) of the live adds, oldest first
        for _ in range(DELTA // STEP):
            self._add(self.data.draw(STEP))

    def _add(self, rows):
        ids = self.index.add(rows.numpy())
        np.testing.assert_array_equal(ids, self.live.add(rows).numpy())
        self.adds.append((ids, rows))

    def _remove(self, ids):
        assert self.index.remove_ids(ids) == self.live.remove_ids(
            torch.as_tensor(ids))

    def request(self):
        """``(queries, number of fresh queries)``: fresh queries, then
        probes near the last add and near the last removal."""
        fresh = self.data.draw(QUERIES - 2 * PROBES)
        return torch.cat([fresh, self.data.near(self.adds[-1][1], PROBES),
                          self.data.near(self.removed_rows, PROBES)]), \
            fresh.shape[0]

    def mutate(self):
        """An add, then the oldest add and a few built ids removed."""
        self._add(self.data.draw(STEP))
        old_ids, old_rows = self.adds.pop(0)
        main = self.main_order[self.main_next:self.main_next + REMOVE_MAIN]
        self.main_next += REMOVE_MAIN
        self._remove(np.concatenate([old_ids, main]))
        self.removed_rows = torch.cat([old_rows, self.live.rows()[main]])


def _served_distances_are_exact(live, queries, ids, d2, **tol):
    want = live.distances(queries, torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(d2, want, **tol)


@pytest.mark.parametrize("seed", [3, 11])
def test_exact_mode_matches_the_live_set(seed):
    c = Churn(seed)
    for _ in range(4):
        q, _ = c.request()
        ids, d2 = c.index.knn(q.numpy(), k=K)
        want_i, want_d = c.live.knn(q, K + 1)
        tol = dict(rtol=0, atol=ATOL_EXACT)
        _served_distances_are_exact(c.live, q, ids, d2, **tol)
        np.testing.assert_allclose(d2, want_d[:, :K].numpy(), **tol)
        assert c.live.is_live(torch.as_tensor(ids)).all()
        tie = (want_d[:, K] - want_d[:, K - 1]) <= 2 * ATOL_EXACT
        for i in np.nonzero(~tie.numpy())[0]:
            assert set(ids[i]) == set(want_i[i, :K].tolist()), i
        c.mutate()


@pytest.mark.parametrize("seed", [3, 11])
def test_packed_mode_holds_the_live_set(seed):
    c = Churn(seed)
    hits = total = 0
    for _ in range(4):
        q, nf = c.request()
        ids, d2 = c.index.knn(q.numpy(), k=K, exact=False, packed=True)
        served = torch.as_tensor(ids)
        assert c.live.is_live(served).all(), "a removed id was served"
        _served_distances_are_exact(c.live, q, ids, d2, rtol=RTOL, atol=0)
        want_i, want_d = c.live.knn(q, K)
        # every probe near the last add finds its nearest live row
        probes = slice(nf, nf + PROBES)
        assert (served[probes] == want_i[probes, :1]).any(dim=1).all()
        got_d = c.live.distances(q, served)
        hits += int((got_d <= want_d[:, K - 1:K] * (1 + 1e-9)).sum())
        total += served.numel()
        c.mutate()
    assert hits / total >= PACKED_RECALL


def test_counters_rise_by_the_cycles_counts():
    c = Churn(5)
    c.index.knn(c.request()[0].numpy(), k=K, exact=False, packed=True)
    cycles = 3
    before = dict(COUNTERS)
    for _ in range(cycles):
        c.index.knn(c.request()[0].numpy(), k=K, exact=False, packed=True)
        c.mutate()
    got = {key: COUNTERS[key] - before[key] for key in COUNTERS
           if key.startswith("dynamic.")}
    assert got == {
        "dynamic.rows_added": cycles * STEP,
        "dynamic.rows_removed": cycles * (STEP + REMOVE_MAIN),
        # every removal of a built id rebuilds the main view once, at the
        # next request; the first request found it built
        "dynamic.main_views": cycles - 1,
        "dynamic.delta_rows": cycles * DELTA,
        "dynamic.delta_slots": cycles * 256,  # the next power of two
        "dynamic.compactions": 0,
        "dynamic.delta_knn.launches": 0,  # the CPU merge is the plain one
    }
    before = COUNTERS["dynamic.compactions"]
    c.index.compact()
    assert COUNTERS["dynamic.compactions"] == before + 1


def _spans(prof):
    return sorted(((ev.name(), ev.start_ns(), ev.start_ns()
                    + ev.duration_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith("vdb_torch.dynamic.")),
                  key=lambda sp: sp[1])


def test_spans_appear_under_the_profiler():
    c = Churn(7)
    q = c.request()[0].numpy()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        c.mutate()
        c.index.knn(q, k=K, exact=False, packed=True)
        c.index.compact()
    spans = _spans(prof)
    names = {name for name, _, _ in spans}
    assert names == {f"vdb_torch.dynamic.{s}" for s in (
        "add", "remove", "knn", "main_view", "delta_view", "merge",
        "compact")}
    knn = next(sp for sp in spans if sp[0] == "vdb_torch.dynamic.knn")
    for name, s, e in spans:
        if name in ("vdb_torch.dynamic.merge", "vdb_torch.dynamic.main_view",
                    "vdb_torch.dynamic.delta_view"):
            assert knn[1] <= s and e <= knn[2], name


def test_remove_ids_across_a_compaction_epoch():
    """``remove_ids`` counts only live ids (negative, never given out,
    repeated or already removed ones are not), in the main segment and in
    the delta, before and after a compaction moves the delta's rows into
    a new main segment; the exact answers stay those of the live set."""
    c = Churn(13)
    q = c.request()[0]
    for step in range(2):
        # a built id, an added one (in the delta, then in the new main
        # segment), and ids that remove nothing
        gone = np.array([-5, N + 10**6, 17 + step, 17 + step, 17,
                         int(c.adds[-1][0][step]), int(c.main_order[0])])
        assert c.index.remove_ids(gone) == c.live.remove_ids(
            torch.as_tensor(gone)) == 2
        ids, d2 = c.index.knn(q.numpy(), k=K)
        want_i, want_d = c.live.knn(q, K)
        assert c.live.is_live(torch.as_tensor(ids)).all()
        np.testing.assert_allclose(d2, want_d.numpy(), rtol=0,
                                   atol=ATOL_EXACT)
        c.index.compact()  # the delta joins the main segment
