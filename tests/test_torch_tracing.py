"""The port's spans and counters (``utils/profiling``): a gate that makes
nothing without a profiler, the span tree of one request and of one
build, the counters, and results that do not depend on the profiler."""

import pytest
import torch

from vector_database_tpu_torch import (
    PackedServer,
    build_index_fused,
    pack_database,
)
from vector_database_tpu_torch.utils.profiling import COUNTERS, span, spanned

CPU = torch.device("cpu")


def _rows(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, d), generator=g) * 2 - 1


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((ev.name(), ev.start_ns(), ev.start_ns()
                     + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith("vdb_torch.")),
                   key=lambda sp: (sp[1], -sp[2]))
    return out, _tree(spans)


def _tree(spans):
    """``[(name, [children...]), ...]`` of spans nested by their intervals."""
    roots, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][1] < s:
            stack.pop()
        node = (name, [])
        (stack[-1][2][1] if stack else roots).append(node)
        stack.append((name, e, node))
    return roots


def _names(nodes):
    return [name for name, _ in nodes]


@pytest.fixture
def record_functions(monkeypatch):
    """Counts the ``record_function`` ranges the program makes."""
    made = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        made.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return made


def test_without_a_profiler_a_span_is_the_shared_no_op(record_functions):
    assert span("vdb_torch.test") is span("vdb_torch.other")
    with span("vdb_torch.test"):
        pass
    assert spanned("vdb_torch.test")(lambda x: x + 1)(1) == 2
    pack = pack_database(_rows(3000, 8, 1), buckets=128, device=CPU)
    PackedServer(pack, k=5, batch=256).query(_rows(300, 8, 2))
    assert record_functions == []


def test_under_a_profiler_a_span_is_a_record_function(record_functions):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("vdb_torch.test"):
            pass
    assert record_functions == ["vdb_torch.test"]
    assert span("vdb_torch.test") is span("vdb_torch.other")  # off again


def test_a_request_is_a_span_of_waves():
    pack = pack_database(_rows(5000, 16, 3), buckets=256, device=CPU)
    server = PackedServer(pack, k=10, batch=1024)
    queries = _rows(2500, 16, 4)
    before = dict(COUNTERS)
    _, roots = _profiled(lambda: server.query(queries))
    assert _names(roots) == ["vdb_torch.serve.query"]
    waves = roots[0][1]
    assert _names(waves) == ["vdb_torch.serve.wave"] * 3
    for _, inside in waves:
        assert _names(inside) == ["vdb_torch.knn.shortlist",
                                  "vdb_torch.knn.rerank"]
        assert _names(inside[0][1]) == ["vdb_torch.knn.scan"]
    assert COUNTERS["serve.queries"] - before["serve.queries"] == 2500
    assert COUNTERS["serve.slots"] - before["serve.slots"] == 3 * 1024


def test_a_build_is_a_span_of_levels_and_a_pack_a_span():
    rows = _rows(4000, 8, 5)
    index, roots = _profiled(
        lambda: build_index_fused(rows, leaf_size=8, device=CPU))
    assert _names(roots) == ["vdb_torch.build"]
    # the levels, then the one gather of the leaf-major matrix, charged to
    # the partition like the levels' moves of the row index
    levels = roots[0][1]
    assert _names(levels) == ["vdb_torch.build.level"] * index.depth + [
        "vdb_torch.build.partition"]
    for _, phases in levels[:-1]:
        assert _names(phases) == [
            "vdb_torch.build.moments", "vdb_torch.build.plane",
            "vdb_torch.build.sync", "vdb_torch.build.partition"]
    _, roots = _profiled(
        lambda: pack_database(index.vectors, buckets=128, device=CPU))
    assert _names(roots) == ["vdb_torch.pack"]


def test_results_do_not_depend_on_the_profiler():
    rows, queries = _rows(6000, 12, 6), _rows(700, 12, 7)

    def run():
        index = build_index_fused(rows, leaf_size=16, device=CPU)
        pack = pack_database(index.vectors, metric="cosine", buckets=256,
                             device=CPU)
        got = PackedServer(pack, k=10, batch=256).query(queries)
        return [index.vectors, index.orig_row, index.dim, index.mid,
                pack.vb, pack.vn, *got]

    off = run()
    on, _ = _profiled(run)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
