"""Every harness of ``vector_database_tpu_torch/benchmarks/`` runs on the
host at a tiny size, prints the JAX harness's JSON keys, and refuses
``--device cuda`` without a card.

Sizes stay at or under the pack's 4096 buckets, where every row owns its
bucket. The shortlist is still cut by bf16 scores (the query rounded to
8 mantissa bits), and in the bench recipe's clusters of sigma 0.05 a
few rows within that rounding of a query's tenth neighbour can fall past
the ``k * oversample`` best buckets: the scan recalls here are held to
0.97, and to 1.0 where the data leave no such rows (the latency run).
The key sets are the JAX harnesses' (``benchmarks/<name>.py``); the
port adds ``device`` where a JAX line had none, ``probes`` to
``probe_epilogue``, whose ``lax.approx_max_k`` line (a TPU operation)
becomes ``bucket_topk_unstable_us_per_q`` (``torch.topk``), and
``host_rerank`` to ``probe_host_rerank``.
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
HARNESSES = [
    "recall_qps", "make_hdf5", "latency", "probe_epilogue", "probe_select",
    "probe_host_rerank", "probe_pin_pipeline", "bigscale", "probe_churn",
    "crossover", "probe_fullscan", "probe_kernel", "probe_block",
    "probe_build", "probe_ops", "main_test", "probe_perm", "probe_meanid",
    "probe_sharded_mem",
]


def _harness(name):
    return importlib.import_module(
        f"vector_database_tpu_torch.benchmarks.{name}")


def _lines(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _harness(name).main(argv + ["--device", "cpu"])
    return [json.loads(x) for x in out.getvalue().splitlines()
            if x.startswith("{")]


@pytest.mark.parametrize("name", HARNESSES)
def test_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the harness would run for real")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        _harness(name).main(["--device", "cuda"])


def test_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m",
         "vector_database_tpu_torch.benchmarks.probe_host_rerank",
         "--n", "1000", "--q", "32", "--reps", "1", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[0]) == {"device": "cpu"}


def test_latency(monkeypatch):
    monkeypatch.setenv("VDB_LAT_BATCHES", "32,64")
    lines = _lines("latency", ["--n", "3000", "--calls", "3", "--reps", "2",
                               "--truth-q", "64"])
    assert lines[0] == {"n": 3000, "d": 96, "k": 10, "blocks": 1,
                        "device": "cpu"}
    assert [(x["batch"], x["mode"]) for x in lines[1:]] == [
        (32, "full"), (64, "full")]  # one block: nothing to prune
    for x in lines[1:]:
        assert set(x) == {"batch", "mode", "probes", "lat_p50_ms",
                          "lat_p99_ms", "lat_min_ms", "qps_sequential",
                          "qps_chained", "recall"}
        assert x["recall"] == 1.0
        assert x["lat_p99_ms"] >= x["lat_p50_ms"] >= x["lat_min_ms"] > 0


def test_latency_request_ends_on_the_host():
    from vector_database_tpu_torch import PackedServer, pack_database
    from vector_database_tpu_torch.benchmarks import latency

    v = torch.rand((500, 16))
    srv = PackedServer(pack_database(v, device="cpu"), k=5, batch=8)
    rows, d2 = latency._request(srv, v[:8].numpy())
    assert rows.device.type == d2.device.type == "cpu"
    assert rows[:, 0].tolist() == list(range(8))


@pytest.mark.parametrize("probes", [None, 2])
def test_probe_epilogue(probes):
    argv = ["--n", "3000", "--q", "128", "--reps", "2"]
    if probes:  # 8192-row blocks: 2 of 3 blocks
        argv[1] = "20000"
        argv += ["--probes", str(probes)]
    (line,) = _lines("probe_epilogue", argv)
    jax_keys = {"n", "q", "nb", "m", "k_scan", "reps", "full_us_per_q",
                "kernel_us_per_q", "bucket_topk_us_per_q",
                "rerank_us_per_q", "selection_us_per_q"}
    assert jax_keys | {"bucket_topk_unstable_us_per_q", "probes",
                       "device"} == set(line)
    assert line["probes"] == probes
    assert all(line[k] > 0 for k in line if k.endswith("_us_per_q"))


def test_crossover():
    lines = _lines("crossover", ["--n", "3000", "--q", "64", "--reps", "1",
                                 "--dims", "2,8"])
    assert lines[0] == {"device": "cpu"}
    for x in lines[1:3]:
        assert set(x) == {"d", "n", "tree_qps", "tree_recall",
                          "tree_leaves", "radius", "scan_qps",
                          "scan_recall", "winner"}
        assert x["scan_recall"] >= 0.97
        assert 0 < x["tree_recall"] <= 1.0
    assert set(lines[3]) == {"d", "n", "tree_qps", "scan_qps", "workload",
                             "winner"}
    assert lines[3]["d"] == "bool64"
    assert set(lines[4]) == {"tree_wins_at"}


def test_probe_fullscan():
    lines = _lines("probe_fullscan", [
        "--n", "3000", "--q", "256", "--reps", "1", "--truth-q", "64",
        "--configs", "8192:4096:512:4,4096:4096:256:2,1000:300:256:4"])
    assert lines[0] == {"device": "cpu"}
    for x in lines[1:3]:
        assert set(x) == {"block", "m", "q_tile", "oversample", "w",
                          "pack_s", "qps", "us_per_q", "recall"}
        assert x["recall"] >= 0.97
    # block 1000 is no multiple of 300 buckets: refused, and reported
    assert lines[3]["error"].startswith("ValueError")


def test_probe_kernel():
    lines = _lines("probe_kernel",
                   ["3000", "[(4096, 256, 4096), (4096, 512, 4096, 'int8f'),"
                    " (8192, 256, 4096, 'bfloat16')]"])
    assert lines[0] == {"device": "cpu"}
    assert [x["dtype"] for x in lines[1:]] == ["int8", "int8f", "bfloat16"]
    for x in lines[1:]:
        assert set(x) == {"block", "q_tile", "buckets", "dtype", "recall",
                          "qps", "compile_s", "ms_per_1024q"}
        assert x["recall"] >= 0.97


def test_probe_block():
    lines = _lines("probe_block", ["--n", "3000", "--q", "64", "--reps",
                                   "1", "--blocks", "8192,4096",
                                   "--q-tiles", "256,512"])
    assert lines[0] == {"device": "cpu"}
    assert [(x["block"], x["q_tile"]) for x in lines[1:]] == [
        (8192, 256), (8192, 512), (4096, 256), (4096, 512)]
    for x in lines[1:]:
        assert set(x) == {"block", "q_tile", "batch_ms", "qps", "vs_8192"}
    assert lines[1]["vs_8192"] == 1.0


def test_probe_build():
    lines = _lines("probe_build", [
        "3000", "[{'leaf': 16, 'ss': 4}, {'leaf': 8, 'd': 8, "
        "'tie': 'mean_id', 'max_levels': 6}]"])
    assert lines[0] == {"device": "cpu"}
    for x in lines[1:]:
        assert set(x) == {"n", "d", "leaf", "ss", "tie", "max_levels",
                          "depth", "build_s", "vectors_per_s",
                          "s_per_level"}
    assert lines[2]["tie"] == "mean_id" and lines[2]["depth"] <= 6


def test_probe_ops():
    lines = _lines("probe_ops", ["3000", "96", "200"])
    assert lines[0] == {"device": "cpu"}
    assert len(lines) == 13
    assert all(set(x) == {"op", "ms"} for x in lines[1:])
    ops = [x["op"] for x in lines[1:]]
    assert any(op.startswith("argsort[N] stable") for op in ops)
    assert any(op.startswith("prefix_sum [32,N] f64") for op in ops)
    assert ops[-1].startswith("level_math")
