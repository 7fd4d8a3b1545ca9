"""The per-layer readers on traces whose answers are known."""

import pytest

from vdb_bench import core
from vdb_bench.metrics import work
from vdb_bench.trace import Summary, summarize

MS = 1_000_000  # nanoseconds
SCAN = "void (anonymous namespace)::bucket_scan_sm90_kernel<128, 128, 2>"


def _reader(name):
    return core.load_cell("deep96.serve-full").metric_reader(name)


def _summary(**kw):
    ops = [(SCAN, 0, 6 * MS), ("sort", 6 * MS, 7 * MS),
           ("Memcpy DtoH", 6 * MS + MS // 2, 8 * MS),  # overlaps the sort
           (SCAN, 9 * MS, 15 * MS)]
    base = dict(device_ops=ops, host_ops=[("vdb_bench.request", 0,
                                           20 * MS),
                                          ("aten::sort", 8 * MS, 9 * MS)],
                window_ns=(0, 20 * MS), kind="serve_batch", queries=2048,
                requests=2, work={"n": 10_000_000, "d": 96, "m": 4096,
                                  "k": 10, "probes": None, "block": 8192})
    base.update(kw)
    return Summary(**base)


def test_busy_is_the_union_of_operations():
    t = _summary()
    assert t.busy_s() == pytest.approx(14e-3)
    assert _reader("device_idle_pct.serve").read(t) == pytest.approx(30.0)


def test_idle_is_named_by_the_host():
    gaps = dict(_summary().idle_by_host())
    assert gaps["request/aten::sort"] == pytest.approx(1e-3)
    assert gaps["request/-"] == pytest.approx(5e-3)


def test_scan_roofline_counts_the_data_not_the_pack():
    t = _summary()
    ops = 2.0 * 2048 * 10_000_000 * 96
    want = 100 * (ops / work.PEAK_BF16_FLOPS) / 12e-3
    assert _reader("scan_roofline_pct").read(t) == pytest.approx(want)
    pruned = _summary(work=dict(t.work, probes=256))
    ops = 2.0 * 2048 * 256 * 8192 * 96
    assert _reader("scan_roofline_pct").read(pruned) == pytest.approx(
        100 * work.bound_s(ops, work.scan_bytes(2048, 2, pruned.work))
        / 12e-3)


def test_nonscan_time_per_query():
    t = _summary()
    assert _reader("nonscan_us_per_q").read(t) == pytest.approx(
        2.5e3 / 2048)


@pytest.mark.parametrize("name", ["scan_roofline_pct", "nonscan_us_per_q",
                                  "device_idle_pct.serve"])
def test_nothing_to_read_is_none(name):
    assert _reader(name).read(_summary(device_ops=[])) is None
    assert _reader(name).read(_summary(kind="rebuild")) is None


class _Event:
    def __init__(self, name, start, end, device, corr=0):
        self._n, self._s, self._e, self._d = name, start, end, device
        self._c = corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._n.startswith("vdb_bench.")

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def test_summary_keeps_the_programs_device_work():
    """Inside the traced span only; the client's work, launched inside
    its spans, is no operation of the program even where it runs beside
    a request, and neither are the spans' shadows on the device's
    timeline."""
    import types

    import torch
    gpu, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        _Event("vdb_bench.traced", 10 * MS, 30 * MS, cpu),
        _Event("vdb_bench.client.queries", 10 * MS, 11 * MS, cpu),
        _Event("vdb_bench.client.prepare", 11 * MS, 12 * MS, cpu),
        _Event("cudaMemcpyAsync", 11 * MS + MS // 10, 11 * MS + MS // 5,
               cpu, corr=7),
        _Event("vdb_bench.request", 12 * MS, 30 * MS, cpu),
        _Event("cudaLaunchKernel", 12 * MS + MS // 2, 13 * MS, cpu,
               corr=8),
        _Event("vdb_bench.request", 12 * MS, 30 * MS, gpu),  # a shadow
        _Event(SCAN, 13 * MS, 20 * MS, gpu, corr=8),
        # the client's copy, running beside the request's scan
        _Event("Memcpy DtoH", 14 * MS, 15 * MS, gpu, corr=7),
        _Event(SCAN, 31 * MS, 40 * MS, gpu, corr=9),  # after the window
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    t = summarize(prof)
    assert t.window_ns == (10 * MS, 30 * MS)
    assert t.device_ops == [(SCAN, 13 * MS, 20 * MS)]
    assert t.client_ops == 1
    # the gap from 10 to 13 ms is named by what the host did at its middle
    assert dict(t.idle_by_host())["client.prepare/-"] == pytest.approx(3e-3)
