"""The BIGANN cell (``bigann10M.serve-full``): correct on the CPU at the
tests' size through the plain versions of the program's kernels, not
correct with the symmetric int8 pack or the ``int8f`` control in the
uint8 pack's place, and its two readers against hand counts."""

import pytest
import torch

from vdb_bench import core
from vdb_bench.control import read
from vdb_bench.metrics import layers
from vdb_bench.run import run_cell
from vdb_bench.tests.cpu_sizes import CPU, SECONDS, overrides
from vdb_bench.trace import Summary

NAME = "bigann10M.serve-full"
MS = 1_000_000  # nanoseconds
I8 = "void (anonymous namespace)::bucket_scan_i8_kernel<128, true>"


def _reader(name):
    return core.load_cell(NAME).metric_reader(name)


def test_the_cell_is_correct_on_the_cpu():
    line = run_cell(NAME, 2 ** 31 + 11, SECONDS, False, CPU,
                    overrides=overrides(NAME))
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["nn_missed"]["value"] == 0.0
    assert set(line["metrics"]) == {"qps", "setup_s"}


@pytest.mark.parametrize("control,pack", [("program", "int8"),
                                          ("int8f", "int8f")])
def test_a_lossy_pack_is_not_correct(control, pack):
    """The symmetric int8 pack keeps 128 levels of SIFT's 256; ``int8f``
    scores the same blocks in bf16: both lose nearest rows."""
    over = overrides(NAME)
    over["config"]["pack_dtype"] = pack
    got = read(NAME, 2 ** 31 + 12, control, SECONDS, CPU, over)
    assert got["correct"] is False
    assert got["checks"]["nn_missed"]["value"] > \
        got["checks"]["nn_missed"]["limit"]


def _summary(**kw):
    ops = [(I8, 0, 6 * MS), ("sort", 6 * MS, 7 * MS),
           ("void (anonymous namespace)::bucket_scan_sm90_kernel<128>",
            7 * MS, 8 * MS),
           (I8, 9 * MS, 13 * MS)]
    base = dict(device_ops=ops, host_ops=[], window_ns=(0, 20 * MS),
                kind="serve_batch", queries=20_000, requests=2,
                work={"n": 10_000_000, "d": 128, "m": 4096, "k": 10,
                      "probes": None, "block": 8192})
    base.update(kw)
    return Summary(**base)


def test_scan_i8_roofline_counts_the_data_at_the_int8_peak():
    ops = 2.0 * 20_000 * 10_000_000 * 128
    nbytes = 2 * 10_000_000 * 128 + 20_000 * 128 + 20_000 * 4096 * 8
    assert ops / 1979e12 > nbytes / 3.35e12  # operations bound it here
    want = 100 * (ops / 1979e12) / 10e-3  # the bf16 kernel not counted
    assert _reader("scan_i8_roofline_pct").read(_summary()) == \
        pytest.approx(want)
    few = _summary(queries=16, requests=2)
    want = 100 * ((2 * 10_000_000 * 128 + 16 * 128 + 16 * 4096 * 8)
                  / 3.35e12) / 10e-3
    assert _reader("scan_i8_roofline_pct").read(few) == pytest.approx(want)


def test_rerank_rows_per_query_reads_the_counters(monkeypatch):
    monkeypatch.setattr(layers, "counters", lambda: {
        "knn.shortlist_queries": 30_720, "knn.shortlist_rows": 2_457_600})
    assert _reader("rerank_rows_per_q").read(_summary()) == 80.0


@pytest.mark.parametrize("name", ["scan_i8_roofline_pct",
                                  "rerank_rows_per_q"])
def test_nothing_to_read_is_none(name, monkeypatch):
    """No device operations, another traffic kind, or a program that
    keeps no shortlist counters and launches no integer kernel (as
    before this cell)."""
    monkeypatch.setattr(layers, "counters", lambda: {"serve.queries": 1})
    r = _reader(name)
    assert r.read(_summary(device_ops=[])) is None
    assert r.read(_summary(kind="rebuild")) is None
    bf16 = [op for op in _summary().device_ops if "i8" not in op[0]]
    assert _reader("scan_i8_roofline_pct").read(
        _summary(device_ops=bf16)) is None
    assert _reader("rerank_rows_per_q").read(_summary()) is None


@pytest.mark.cuda
def test_small_cell_traced_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = run_cell(NAME, 2 ** 31 + 13, 2.0, True, torch.device("cuda", 0),
                    overrides={"config": {"n": 300_000},
                               "mix": {"request_queries": 2000}})
    assert line["correct"] is True
    m = line["metrics"]
    assert 0 < m["scan_i8_roofline_pct"]["value"] <= 100
    assert m["rerank_rows_per_q"]["value"] == 80.0
    # the serving layers' readers that key on no span pairing read here too
    assert {"nonscan_us_per_q", "device_idle_pct.serve", "wave_fill_pct",
            "program_idle_pct.serve"} <= set(m)
