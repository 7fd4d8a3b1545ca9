"""The port's ``recall_qps`` and ``probe_select`` harnesses against the JAX
harnesses on shared data.

Both packages read ``tests/data/digits-64.arff`` through ``VDB_DATA`` (the
same rows and the same seeded test queries). The JAX harness runs once in
this process (Pallas in interpret mode, ``VDB_CPU=1``), the port's on
``--device cpu``. Recalls agree within 2 / (q * k): two neighbours of the
640, for the rows that bf16 scores or an f32 sum in another order may
order differently at a bucket's or a radius's edge. The selection
policies' coverage table is the same line by line.
"""

from pathlib import Path

import pytest
import torch

from jax_harness import json_lines, port, run
from vector_database_tpu_torch.benchmarks import probe_select, recall_qps

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARFF = str(REPO / "tests" / "data" / "digits-64.arff")
ARGS = ["--n", "1797", "--q", "64", "--reps", "1", "--buckets", "64",
        "--probes", "1,2"]
Q, K = 64, 10


@pytest.fixture(scope="module")
def jax_lines():
    return json_lines(run("recall_qps", ARGS,
                          dict(VDB_DATA=ARFF, VDB_CPU="1")))


@pytest.fixture(scope="module")
def port_lines():
    return json_lines(port(recall_qps.main,
                           ARGS + ["--device", "cpu", "--sharded"],
                           dict(VDB_DATA=ARFF)))


def test_report_keys_and_recalls_match_jax(jax_lines, port_lines):
    jax_report, port_report = jax_lines[-1], port_lines[-1]
    assert set(jax_report) <= set(port_report)
    assert port_report["dataset"] == jax_report["dataset"]
    assert port_report["device"] == "cpu"
    for key in ("scan_bf16_recall", "pallas_recall", "tree_recall"):
        assert abs(port_report[key] - jax_report[key]) <= 2 / (Q * K), key


def test_probes_lines_match_jax(jax_lines, port_lines):
    want = [x["probes"] for x in jax_lines if "probes" in x]
    got = [x["probes"] for x in port_lines if "probes" in x]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["probes"], g["blocks"]) == (w["probes"], w["blocks"])
        assert abs(g["recall"] - w["recall"]) <= 2 / (Q * K)


def test_sharded_recall_equals_single_device(port_lines):
    """At world size 1 the sharded scan is the single-device scan."""
    report = port_lines[-1]
    assert report["sharded_devices"] == 1
    assert report["sharded_recall"] == report["pallas_recall"]
    lines = [x["sharded_probes"] for x in port_lines if "sharded_probes" in x]
    assert [x["recall"] for x in lines] == [
        x["probes"]["recall"] for x in port_lines if "probes" in x]
    import torch.distributed as dist

    assert not dist.is_initialized()  # the harness closed its own world


def test_probe_select_table_matches_jax():
    argv = ["--n", "1797", "--q", "64", "--probes", "1,2", "--q-tile", "16"]
    want = run("probe_select", argv, dict(VDB_DATA=ARFF))
    got = port(probe_select.main, argv + ["--device", "cpu"],
               dict(VDB_DATA=ARFF))
    rows = [x for x in want.splitlines() if not x.startswith("#")]
    assert len(rows) == 9  # the header and eight policies
    assert [x for x in got.splitlines() if not x.startswith("#")] == rows
