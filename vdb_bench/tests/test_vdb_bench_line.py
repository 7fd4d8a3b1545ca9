"""The result line has exactly the contract's keys, on both kinds of
run, and a sound run of the program is correct."""

import pytest

from vdb_bench import core
from vdb_bench.run import run_cell
from vdb_bench.tests.cpu_sizes import (
    CPU,
    PRUNED,
    REBUILD_SECONDS,
    SECONDS,
    overrides,
)

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", ["deep96.serve-full", "sift128.serve-full",
                                  "deep96.serve-full/pruned",
                                  "deep96.rebuild"])
def test_untraced_line(name):
    name, _, pruned = name.partition("/")
    cell = core.load_cell(name)
    secs = REBUILD_SECONDS if name.endswith("rebuild") else SECONDS
    line = run_cell(name, 2**31 + 11, secs, False, CPU,
                    overrides=PRUNED if pruned else overrides(name))
    assert list(line) == KEYS  # the checks come last
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    if not pruned:  # pruning 200 queries loses recall
        assert line["correct"] is True


def test_traced_line():
    name = "sift128.serve-full"
    line = run_cell(name, 5, SECONDS, True, CPU, overrides=overrides(name))
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["correct"] is True
    # no device here: the device-trace metrics find nothing to read
    assert line["metrics"] == {}
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def test_traced_rebuild_line():
    name = "deep96.rebuild"
    line = run_cell(name, 8, REBUILD_SECONDS + 2.0, True, CPU,
                    overrides=overrides(name))
    assert line["correct"] is True
    # the host spans after the traced seconds are read; no device here
    assert set(line["metrics"]) == {"build_ms", "pack_ms"}
    assert line["metrics"]["build_ms"]["value"] > 0
