"""The harness finds every cell, configuration, traffic mix and metric by
name, and a cell added as data alone runs."""

import json
import shutil

import pytest

from vdb_bench import core
from vdb_bench.run import run_cell
from vdb_bench.tests.cpu_sizes import CPU, SECONDS, overrides

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = core.load_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.kind(), "window")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
    for key in ("missing_answers", "dist_rel_err", "recall_at_10",
                "nn_missed"):
        assert key in cell.spec["checks"]


def test_config_files_are_the_benchmark_files():
    for c in BENCH["configs"]:
        data = core.load_json(core.ROOT / c["file"])
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        core.load_cell("no.such-cell")


def test_a_cell_added_as_data_runs(tmp_path):
    """A new cell file and its BENCHMARK.json entry, in a copy: found and
    run with no other file touched."""
    shutil.copytree(core.PKG, tmp_path / core.PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    entry = dict(bench["workloads"][0], name="deep96.serve-copy")
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELLS[0] in m.get("workloads", []):
            m["workloads"].append(entry["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    src = tmp_path / core.PKG.name / "workloads"
    shutil.copy(src / f"{BENCH['workloads'][0]['name']}.json",
                src / "deep96.serve-copy.json")
    line = run_cell("deep96.serve-copy", 7, SECONDS, False, CPU,
                    overrides=overrides("deep96.serve-full"), root=tmp_path)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"qps", "p95_ms", "setup_s"}
