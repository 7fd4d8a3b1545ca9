"""The readers of the program's layers (``metrics/layers.py`` and the
metrics over it) on traces whose answers are known, and on a card the
launch-order pairing against the profiler's own correlation ids."""

import pytest
import torch

from vdb_bench import core
from vdb_bench import trace as T
from vdb_bench.metrics import layers
from vdb_bench.trace import Summary

MS = 1_000_000  # nanoseconds
SCAN = "void (anonymous namespace)::bucket_scan_sm90_kernel<128, 128, 2>"
SERVE_READERS = ["wave_fill_pct", "select_us_per_q", "rerank_us_per_q",
                 "program_idle_pct.serve"]
BUILD_READERS = ["program_idle_pct.build", "build_moments_ms",
                 "build_partition_ms"]


def _reader(name):
    return core.load_cell("deep96.serve-full").metric_reader(name)


def _serving(**kw):
    """One wave: the shortlist launches the scan (inside its scan span)
    and a sort, the rerank a gather and a copy; the client launches a
    copy of its own (already left out of ``device_ops``)."""
    host = [
        ("vdb_bench.request", 0, 20 * MS),
        ("vdb_torch.serve.query", 0, 19 * MS),
        ("vdb_torch.serve.wave", MS // 2, 18 * MS),
        ("vdb_torch.knn.shortlist", MS, 5 * MS),
        ("vdb_torch.knn.scan", MS, 2 * MS),
        ("cudaLaunchKernel", MS + 1, MS + 2),  # the scan
        ("cudaLaunchKernel", 3 * MS, 3 * MS + 1),  # the sort
        ("vdb_bench.client.prepare", 5 * MS + 1, 6 * MS),
        ("cudaMemcpyAsync", 5 * MS + 2, 5 * MS + 3),  # the client's copy
        ("vdb_torch.knn.rerank", 6 * MS, 12 * MS),
        ("cudaLaunchKernel", 7 * MS, 7 * MS + 1),  # the gather
        ("cudaMemcpyAsync", 8 * MS, 8 * MS + 1),  # the rerank's copy
        ("aten::sort", 3 * MS, 4 * MS),
    ]
    ops = [(SCAN, 2 * MS, 8 * MS), ("sort", 8 * MS, 9 * MS),
           ("gather", 9 * MS, 11 * MS),
           ("Memcpy DtoH (Device -> Pageable)", 11 * MS, 12 * MS)]
    base = dict(device_ops=ops, host_ops=host, window_ns=(0, 20 * MS),
                kind="serve_batch", queries=1000, requests=1)
    base.update(kw)
    return Summary(**base)


def _building(**kw):
    host = [
        ("vdb_bench.build", 0, 10 * MS),
        ("vdb_torch.build", 0, 9 * MS),
        ("vdb_torch.build.level", 0, 8 * MS),
        ("vdb_torch.build.moments", 0, 2 * MS),
        ("cudaLaunchKernel", 1, 2),
        ("cudaLaunchKernel", 3, 4),
        ("vdb_torch.build.sync", 2 * MS, 5 * MS),
        ("cudaMemcpyAsync", 2 * MS + 1, 2 * MS + 2),
        ("cudaStreamSynchronize", 2 * MS + 3, 4 * MS),
        ("vdb_torch.build.partition", 5 * MS, 8 * MS),
        ("cudaLaunchKernel", 5 * MS + 1, 5 * MS + 2),
        ("cudaMemsetAsync", 5 * MS + 3, 5 * MS + 4),
    ]
    ops = [("prefix", MS, 2 * MS), ("scan", 2 * MS, 3 * MS),
           ("Memcpy DtoH (Device -> Pinned)", 3 * MS, 3 * MS + MS // 2),
           ("gather", 6 * MS, 9 * MS), ("Memset (Device)", 9 * MS, 10 * MS)]
    base = dict(device_ops=ops, host_ops=host, window_ns=(0, 10 * MS),
                kind="rebuild", requests=2)
    base.update(kw)
    return Summary(**base)


def test_attribute_charges_the_innermost_span_of_the_launch():
    spans = [("vdb_torch.serve.wave", 0, 60), ("vdb_torch.knn.shortlist",
                                               20, 40),
             ("vdb_torch.knn.scan", 20, 30), ("vdb_bench.request", 0, 100),
             ("vdb_bench.client.prepare", 70, 80)]
    calls = [(10, 1), (25, 2), (35, 3), (50, 4), (75, 5), (90, 6)]
    ops = [("a", 100, 110, 1), ("b", 110, 140, 2), ("c", 140, 150, 3),
           ("d", 150, 170, 4), ("client", 150, 151, 5),
           ("outside", 170, 175, 6), ("unlaunched", 175, 177, 99)]
    assert layers.attribute(ops, calls, spans) == {
        "vdb_torch.serve.wave": 10 + 20, "vdb_torch.knn.scan": 30,
        "vdb_torch.knn.shortlist": 10, "": 5 + 2}


def test_pairing_follows_the_launch_order_of_each_kind():
    ops, calls = layers.pair(_serving())
    by_call = dict((corr, s) for s, corr in calls)
    launched = {name: by_call[corr] for name, _, _, corr in ops}
    assert launched == {SCAN: MS + 1, "sort": 3 * MS, "gather": 7 * MS,
                        "Memcpy DtoH (Device -> Pageable)": 8 * MS}
    assert layers.layer_ns(_serving()) == {
        "vdb_torch.knn.scan": 6 * MS, "vdb_torch.knn.shortlist": MS,
        "vdb_torch.knn.rerank": 3 * MS}


def _requests(n, lost=()):
    """``n`` requests of two waves, each wave a shortlist (a sort and a
    copy) and a rerank (a gather), each request ending in a host
    synchronisation; the operations numbered in ``lost`` are missing
    from ``device_ops``, as ``trace.summarize`` leaves some out. Returns
    the summary and what each span's operations took."""
    host, ops, want, t = [], [], {}, 0
    plan = [("vdb_torch.knn.shortlist", "aten::sort", "sort", 3),
            ("vdb_torch.knn.shortlist", "aten::copy_", "copy", 1),
            ("vdb_torch.knn.rerank", "aten::gather", "gather", 2)]
    for _ in range(n):
        host.append(("vdb_torch.serve.query", t, t + 40 * MS))
        for _ in range(2):
            for span, ctx, name, ms in plan:
                host += [(span, t, t + MS), (ctx, t + 1, t + MS - 1),
                         ("cudaLaunchKernel", t + 2, t + 3)]
                if len(ops) + len(want.get("_all", [])) not in lost:
                    ops.append((name, t + 10, t + 10 + ms * 1000))
                    want[span] = want.get(span, 0) + ms * 1000
                else:
                    want.setdefault("_all", []).append(name)
                t += MS
        host.append(("cudaStreamSynchronize", t, t + MS))
        t += 10 * MS
    want.pop("_all", None)
    return Summary(device_ops=ops, host_ops=host, window_ns=(0, t),
                   kind="serve_batch", queries=n, requests=n), want


def test_a_lost_operation_is_skipped_where_the_names_say():
    """A gather (operation 4) and a sort (operation 13) are missing: the
    alignment skips their launches, and no time moves to another span."""
    t, want = _requests(4, lost=(4, 13))
    assert len(t.device_ops) == 4 * 6 - 2
    assert layers.layer_ns(t) == want


def test_pairing_is_refused_where_it_cannot_hold():
    t, _ = _requests(2)
    extra = _requests(2)[0]
    extra.device_ops = t.device_ops + [("sort", 11, 12)]  # never launched
    assert layers.pair(extra) is None and layers.layer_ns(extra) is None


def test_the_program_idle_time_lies_inside_its_spans():
    # gaps: 0-2 ms (in the wave), 12-20 ms (its middle, 16, in the query)
    assert layers.program_idle_ns(_serving()) == 2 * MS + 8 * MS
    assert _reader("program_idle_pct.serve").read(_serving()) == \
        pytest.approx(50.0)
    host = [op for op in _serving().host_ops if op[0] not in (
        "vdb_torch.serve.query", "vdb_torch.serve.wave")]
    assert _reader("program_idle_pct.serve").read(
        _serving(host_ops=host)) == pytest.approx(10.0)  # 0-2 ms only
    # the build: gaps 0-1 (in moments), 3.5-6 (middle 4.75 in sync)
    assert _reader("program_idle_pct.build").read(_building()) == \
        pytest.approx(35.0)


def test_per_query_and_per_operation_device_time():
    assert _reader("select_us_per_q").read(_serving()) == pytest.approx(
        MS / 1e3 / 1000)
    assert _reader("rerank_us_per_q").read(_serving()) == pytest.approx(
        3 * MS / 1e3 / 1000)
    assert layers.layer_ns(_building()) == {
        "vdb_torch.build.moments": 2 * MS,
        "vdb_torch.build.sync": MS // 2,
        "vdb_torch.build.partition": 4 * MS}
    assert _reader("build_moments_ms").read(_building()) == \
        pytest.approx(1.0)
    assert _reader("build_partition_ms").read(_building()) == \
        pytest.approx(2.0)


def test_wave_fill_reads_the_programs_counters(monkeypatch):
    monkeypatch.setattr(layers, "counters", lambda: {
        "serve.queries": 20_000, "serve.slots": 20_480})
    assert _reader("wave_fill_pct").read(_serving()) == pytest.approx(
        97.65625)
    assert _reader("wave_fill_pct").read(_serving(device_ops=[])) is None
    monkeypatch.setattr(layers, "counters", lambda: None)
    assert _reader("wave_fill_pct").read(_serving()) is None


def test_the_program_keeps_the_counters():
    c = layers.counters()
    assert {"serve.queries", "serve.slots"} <= set(c)


@pytest.mark.parametrize("name", SERVE_READERS + BUILD_READERS)
def test_nothing_to_read_is_none(name, monkeypatch):
    """The wrong traffic kind, no device operations, or a program with no
    spans and no counters (as before it had them)."""
    monkeypatch.setattr(layers, "counters", lambda: None)
    right, wrong = ((_serving, _building) if name in SERVE_READERS
                    else (_building, _serving))
    assert _reader(name).read(wrong()) is None
    assert _reader(name).read(right(device_ops=[])) is None
    bare = [op for op in right().host_ops
            if not op[0].startswith(layers.PROGRAM)]
    assert _reader(name).read(right(host_ops=bare)) is None


_CARD = """
import json, sys, torch
from vdb_bench import trace as T
from vdb_bench.metrics import layers
from vdb_bench.run import run_cell
seen = {}
summarize = T.summarize


def keep(prof):
    t = summarize(prof)
    calls, corr = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            corr[(ev.name()[:T.NAME_CHARS],
                  max(ev.start_ns(), t.window_ns[0]))] = T._correlation(ev)
        elif T._correlation(ev) and layers.call_kind(ev.name()):
            calls.append((ev.start_ns(), T._correlation(ev)))
    ops = [(n, s, e, corr[(n, s)]) for n, s, e in t.device_ops]
    seen["got"] = layers.layer_ns(t)
    seen["want"] = layers.attribute(ops, calls, t.host_ops)
    return t


T.summarize = keep
cell, over = sys.argv[1], json.loads(sys.argv[2])
line = run_cell(cell, 2**31 + 5, 2.5, True, torch.device("cuda", 0),
                overrides=over)
print(json.dumps(dict(seen, correct=line["correct"],
                      metrics=sorted(line["metrics"]))))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("cell,over", [
    ("sift128.serve-full", {"config": {"n": 300_000},
                            "mix": {"request_queries": 3000}}),
    ("deep96.rebuild", {"config": {"n": 1_000_000, "queries": 1000}}),
])
def test_pairing_is_the_profilers_on_the_card(cell, over):
    """A traced window of a cell at a small size, in a process of its own
    (its first profiled window, as a benchmark run's): the layers read
    from the ``Summary`` equal those the profiler's correlation ids give,
    and every new metric of the cell is on the line."""
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-c", _CARD, cell,
                          json.dumps(over)], cwd=core.ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["correct"] is True
    assert got["got"] is not None and got["got"] == got["want"]
    readers = SERVE_READERS if cell.endswith("serve-full") else BUILD_READERS
    assert set(readers) <= set(got["metrics"])
