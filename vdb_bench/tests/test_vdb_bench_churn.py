"""The churn cell (``traffic/churn.py``) on the CPU at a small size: its
result line, a sound run correct, each fault not correct, its four
readers on a traced run and on a summary whose answers are known, and
its live-set reference the same as the tier-1 tests' copy."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vdb_bench import core
from vdb_bench.reference.live import LiveSet
from vdb_bench.run import run_cell
from vdb_bench.trace import Summary
from vdb_bench.tests.cpu_sizes import CPU

NAME = "deep96.churn"
# the cell scaled down in proportion: 20,000 rows, 1% removed, a delta of
# 200 rows, 200-query requests with 20 probes of each kind, adds of 20
SMALL = {"config": {"n": 20000, "removed_at_start": 200, "delta_rows": 200},
         "mix": {"request_queries": 200, "fresh_probes": 20,
                 "removed_probes": 20, "add_rows": 20, "remove_main": 2}}
SECONDS = 0.5
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CHECKS = {"missing_answers", "removed_served", "dist_rel_err",
          "recall_at_10", "nn_missed", "fresh_nn_missed"}
READERS = ["merge_us_per_q", "merge_roofline_pct", "mutation_ms",
           "delta_fill_pct"]
MS = 1_000_000  # nanoseconds


def _small():
    return {part: dict(keys) for part, keys in SMALL.items()}


def _kind():
    return core.load_cell(NAME).kind()


def test_untraced_line():
    cell = core.load_cell(NAME)
    line = run_cell(NAME, 2**31 + 19, SECONDS, False, CPU,
                    overrides=_small())
    assert list(line) == KEYS
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) >= {"qps", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    # a request, an add and a remove a cycle
    assert line["attempted"] >= 3 and line["attempted"] % 3 == 0
    assert line["failed"] == 0
    assert set(line["checks"]) == CHECKS
    assert line["checks"]["removed_served"]["value"] == 0
    assert line["checks"]["fresh_nn_missed"]["value"] == 0


def test_traced_line_reads_the_host_spans():
    line = run_cell(NAME, 13, SECONDS, True, CPU, overrides=_small())
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["correct"] is True
    # no device here: the device-trace readers and the counter reader,
    # which needs a traced window on a device, find nothing to read
    assert set(line["metrics"]) == {"mutation_ms"}
    assert line["metrics"]["mutation_ms"]["value"] > 0


class _Stale:
    """The state returned unchanged: every request after the first gets
    the first one's answer."""

    def __init__(self, inner):
        self.inner, self.first = inner, None
        self.add, self.remove_ids = inner.add, inner.remove_ids

    def query(self, queries):
        if self.first is None:
            self.first = self.inner.query(queries)
        return self.first


@pytest.mark.parametrize("fault", ["no-delta", "no-tombstones", "late",
                                   "int8", "fp8", "stale"])
def test_fault_is_not_correct(fault):
    kind = _kind()
    hook = ((lambda state: _Stale(state.system)) if fault == "stale"
            else (lambda state: kind.control_system(state, fault)))
    line = run_cell(NAME, 23, SECONDS, False, CPU, overrides=_small(),
                    system_hook=hook)
    assert line["attempted"] >= 6
    assert line["correct"] is False
    checks = {k: v["value"] for k, v in line["checks"].items()}
    if fault in ("no-tombstones", "late"):
        assert checks["removed_served"] > 0
    if fault in ("no-delta", "late"):
        assert checks["fresh_nn_missed"] > 0.5


def _live_reference_of_the_tests():
    path = core.ROOT / "tests" / "live_reference.py"
    spec = importlib.util.spec_from_file_location("_tests_live_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_live_set_is_the_tests_reference():
    """One seeded sequence of adds, removals and queries at several
    versions: the same ids and distances from both copies."""
    other = _live_reference_of_the_tests().LiveSet
    g = torch.Generator().manual_seed(17)
    ours, theirs = LiveSet("cpu"), other("cpu")
    answers = []
    for step in range(6):
        rows = torch.randn((500 if step == 0 else 40, 12), generator=g)
        assert torch.equal(ours.add(rows), theirs.add(rows))
        gone = torch.randint(0, ours.size, (30,), generator=g)
        assert ours.remove_ids(gone) == theirs.remove_ids(gone)
        q = torch.randn((16, 12), generator=g)
        at = torch.randint(0, ours.version + 1, (16,), generator=g)
        for live in (ours, theirs):
            answers.append(live.knn(q, 5, at=at, chunk=97)
                           + (live.is_live(torch.arange(live.size), 3),))
    for a, b in zip(answers[::2], answers[1::2]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_live_set_knn_is_brute_force_at_each_version():
    g = torch.Generator().manual_seed(2)
    live = LiveSet("cpu")
    rows = torch.randn((300, 6), generator=g)
    live.add(rows)
    live.remove_ids(torch.arange(0, 300, 4))
    live.add(rows[:10] + 0.0)  # duplicates of rows 0..9, 1 and 5 dead
    q = torch.cat([torch.randn((20, 6), generator=g), rows[:3]])
    for v in range(live.version + 1):
        ids, dist = live.knn(q, 8, at=v, chunk=50)
        x = live.rows().double()
        d = ((q.double()[:, None] - x[None]) ** 2).sum(-1)
        d[:, ~live.live(v)] = float("inf")
        want = torch.sort(d, dim=1, stable=True)
        n_live = int(live.live(v).sum())
        assert torch.equal(ids[:, :n_live], want.indices[:, :8][:, :n_live])
        assert torch.equal(dist[:, :n_live], want.values[:, :8][:, :n_live])
        assert (ids[:, n_live:] == -1).all()


def _reader(name):
    return core.load_cell(NAME).metric_reader(name)


def _churn_summary(**kw):
    """Two cycles: in each, the knn's scan and its merge (one launch and
    one operation each, a host sync after each), then the mutations' host
    spans, the second add nested in nothing, a main view inside the knn."""
    host, ops = [], []
    for c in range(2):
        t = c * 10 * MS
        host += [
            ("vdb_torch.dynamic.knn", t, t + 6 * MS),
            ("vdb_torch.dynamic.main_view", t + MS // 2, t + MS),
            ("cudaLaunchKernel", t + MS, t + MS + 1),  # the scan
            ("cudaStreamSynchronize", t + MS + 2, t + 3 * MS),
            ("vdb_torch.dynamic.merge", t + 3 * MS, t + 6 * MS),
            ("vdb_torch.dynamic.delta_view", t + 3 * MS, t + 3 * MS + MS // 4),
            ("cudaLaunchKernel", t + 4 * MS, t + 4 * MS + 1),  # the merge's
            ("cudaStreamSynchronize", t + 4 * MS + 2, t + 6 * MS),
            ("vdb_torch.dynamic.add", t + 7 * MS, t + 8 * MS),
            ("vdb_torch.dynamic.remove", t + 8 * MS, t + 9 * MS),
        ]
        ops += [("bucket_scan", t + MS + 5, t + 3 * MS - 5),
                ("cdist", t + 4 * MS + 5, t + 5 * MS + 5)]
    base = dict(device_ops=ops, host_ops=host, window_ns=(0, 20 * MS),
                kind="churn", queries=2000, requests=2,
                work={"d": 96, "k": 10, "merges": [(1000, 500), (1000, 500)]})
    base.update(kw)
    return Summary(**base)


def test_readers_on_a_handmade_summary(monkeypatch):
    t = _churn_summary()
    # the merge's two operations, 1 ms each, over 2,000 queries
    assert _reader("merge_us_per_q").read(t) == pytest.approx(1.0)
    roof = _reader("merge_roofline_pct")
    least = 2 * max(3 * 1000 * 96 * 500 / roof.PEAK_F32_FLOPS,
                    ((1000 * 96 + 500 * 96) * 4 + 1000 * 10 * 12) / 3.35e12)
    assert roof.read(t) == pytest.approx(100 * least / 2e-3)
    # per cycle: the main view 0.5 ms, the delta view 0.25, add 1, remove 1
    assert _reader("mutation_ms").read(t) == pytest.approx(2.75)
    from vdb_bench.metrics import layers
    monkeypatch.setattr(layers, "counters", lambda: {
        "dynamic.delta_rows": 500, "dynamic.delta_slots": 512})
    assert _reader("delta_fill_pct").read(t) == pytest.approx(
        100 * 500 / 512)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_elsewhere(name, monkeypatch):
    from vdb_bench.metrics import layers
    monkeypatch.setattr(layers, "counters", lambda: {})
    assert _reader(name).read(_churn_summary(kind="serve_batch")) is None
    # the parent program: no dynamic spans and no dynamic counters
    bare = _churn_summary(host_ops=[op for op in _churn_summary().host_ops
                                    if not op[0].startswith("vdb_torch.")])
    assert _reader(name).read(bare) is None


_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from vdb_bench.run import run_cell
from vdb_bench.tests.cpu_sizes import CPU
from vdb_bench.tests.test_vdb_bench_churn import NAME, _small
run_cell(NAME, 3, 0.0, True, CPU, overrides=_small())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_churn_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _RUN], cwd=core.ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(core.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert "vector_database_tpu_torch" in names
    assert not names & set(core.FORBIDDEN)


def test_the_delta_rows_hold_in_steady_state():
    """The client keeps the delta at ``delta_rows``: each cycle adds one
    block and expires the oldest."""
    kind = _kind()
    state = None

    def keep(s):
        nonlocal state
        state = s
        return s.system

    run_cell(NAME, 31, SECONDS, False, CPU, overrides=_small(),
             system_hook=keep)
    adds = [e for e in state.log if e[0] == "add"]
    removes = [e for e in state.log if e[0] == "remove"]
    requests = [e for e in state.log if e[0] == "request"]
    assert len(adds) == 1 + 10 + len(requests)  # the build, set-up, cycles
    assert len(removes) == 1 + len(requests)
    live, versions = kind.replay(state)
    n = SMALL["config"]["n"]
    assert int(live.live()[n:].sum()) == SMALL["config"]["delta_rows"]
    assert int((~live.live()[:n]).sum()) == (
        SMALL["config"]["removed_at_start"]
        + len(requests) * SMALL["mix"]["remove_main"])
    assert np.all(np.diff([versions[i] for i in range(len(requests))]) == 2)
