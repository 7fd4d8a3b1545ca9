"""The port's numpy utilities and observability against the JAX package's:
``load_arff``/``minmax_normalize`` on the vendored UCI digits fixture,
``BuildStats``, ``ProgressLogger``, ``selectivity_report`` and ``trace``.
"""

import json
import os

import numpy as np
import pytest
import torch

from vector_database_tpu import build_index as jax_build_host
from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu import search as jax_search
from vector_database_tpu.utils import arff as jax_arff
from vector_database_tpu.utils import profiling as jax_profiling
from vector_database_tpu_torch import build_index_fused, exact_ball, search
from vector_database_tpu_torch.utils import arff, datasets
from vector_database_tpu_torch.utils.profiling import (
    BuildStats,
    ProgressLogger,
    selectivity_report,
    trace,
)

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "digits-64.arff")


def test_load_arff_equals_jax_loader():
    data, names, labels = arff.load_arff(FIXTURE)
    jdata, jnames, jlabels = jax_arff.load_arff(FIXTURE)
    assert data.shape == (1797, 64) and data.dtype == np.float32
    np.testing.assert_array_equal(data, jdata)
    assert names == jnames
    np.testing.assert_array_equal(labels, jlabels)
    assert set(np.unique(labels)) == set(range(10))
    vecs = arff.minmax_normalize(data)
    np.testing.assert_array_equal(vecs, jax_arff.minmax_normalize(data))
    assert vecs.min() >= -1.0 and vecs.max() <= 1.0
    # the normalized digits through the port's tree equal the oracle
    idx = build_index_fused(vecs, leaf_size=8, device="cpu")
    res = search(idx, vecs[:8], 2.0)
    truth = exact_ball(torch.from_numpy(vecs), vecs[:8], 2.0)
    for i in range(8):
        assert set(res.match_rows(i).tolist()) == \
            set(torch.nonzero(truth[i])[:, 0].tolist())


def test_load_arff_edge_cases(tmp_path):
    path = tmp_path / "x.arff"
    path.write_text("% comment\n@RELATION r\n@ATTRIBUTE a NUMERIC\n"
                    "@ATTRIBUTE 'b c' real\n@DATA\n")
    data, names, labels = arff.load_arff(str(path))
    assert data.shape == (0, 2) and names == ["a", "b c"] and labels is None
    path.write_text("@RELATION r\n@ATTRIBUTE a string\n@DATA\n")
    with pytest.raises(ValueError, match="unsupported"):
        arff.load_arff(str(path))
    const = np.array([[1.0, 2.0], [1.0, 4.0]], np.float32)
    np.testing.assert_array_equal(arff.minmax_normalize(const),
                                  [[0.0, -1.0], [0.0, 1.0]])


def test_build_stats_collects_levels():
    vecs = datasets.random_uniform(500, 8, seed=120)
    stats = BuildStats()
    build_index_fused(vecs, leaf_size=1, progress=stats, device="cpu")
    jstats = jax_profiling.BuildStats()
    jax_build_host(vecs, leaf_size=1, progress=jstats)
    assert [(s.level, s.live_ranges, s.active_points) for s in stats.levels] \
        == [(s.level, s.live_ranges, s.active_points) for s in jstats.levels]
    assert len(stats.levels) >= 5
    assert stats.levels[0].active_points == 500
    assert stats.levels[0].live_ranges == 1
    actives = [s.active_points for s in stats.levels]
    assert all(a >= b for a, b in zip(actives, actives[1:]))
    assert stats.total_seconds >= 0 and "level" in stats.report()


def test_progress_logger(capsys):
    vecs = datasets.random_uniform(200, 4, seed=121)
    build_index_fused(vecs, progress=ProgressLogger(every=1), device="cpu")
    assert "Process level 0: 1 ranges, 200 active points" in \
        capsys.readouterr().out


def test_selectivity_report_equals_jax():
    vecs = datasets.grid2d(50)
    qs = np.array([[0.1, 0.1], [0.5, 0.5]], np.float32)
    rep = selectivity_report(
        search(build_index_fused(vecs, device="cpu"), qs, 0.1), n=2500)
    jrep = jax_profiling.selectivity_report(
        jax_search(jax_build(vecs), qs, 0.1), n=2500)
    assert rep["queries"] == 2 and rep["overflowed"] == 0
    assert rep["mean_matches"] >= 1 and rep["candidates_per_match"] >= 1
    assert rep["mean_matches"] == jrep["mean_matches"]


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with trace(str(log_dir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_trace_does_not_swallow_failures(tmp_path):
    """The JAX trace hides every profiler failure; the port's raises (here
    a log_dir that is a file)."""
    path = tmp_path / "file"
    path.write_text("")
    with pytest.raises(OSError):
        with trace(str(path)):
            pass
