"""The port's stateful harnesses against the JAX harnesses on the same
numpy data: ``probe_churn`` (``DynamicIndex`` under adds and removals)
and ``bigscale`` (``NativeVectorStore`` -> ``ChunkedIndex`` -> sampled
recall). The JAX harnesses run in this process (Pallas in interpret
mode), the port's on ``--device cpu``.

``probe_churn``: the two cache flags (the main pack survives adds; the
base pack survives removals) equal JAX's. ``bigscale`` at 20,000 rows in
chunks of 5,000: the sampled recall@10 equals JAX's exactly (both merge
exact per-chunk top-k lists of the same rows), and the store and spill
directory are removed at the end.
"""

import pytest
import torch

from jax_harness import json_lines, port, run
from vector_database_tpu_torch.benchmarks import bigscale, probe_churn

torch.set_num_threads(2)


def test_probe_churn_flags_match_jax():
    argv = ["--sizes", "5000", "--q", "64", "--reps", "1", "--epochs", "1"]
    want = json_lines(run("probe_churn", argv))
    got = json_lines(port(probe_churn.main, argv + ["--device", "cpu"]))
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for key in ("pack_survived_adds", "base_pack_survived_removes"):
        assert got[0][key] is want[0][key], key
    assert got[0]["pack_survived_adds"] and \
        got[0]["base_pack_survived_removes"]


@pytest.mark.parametrize("pin", [False, True])
def test_bigscale_sampled_recall_matches_jax(tmp_path, pin):
    def argv(tag):
        return ["--n", "20000", "--chunk", "5000", "--q", "16", "--reps",
                "1", "--path", str(tmp_path / f"{tag}.vstore"),
                "--spill", str(tmp_path / f"{tag}_spill")] + (
                    ["--pin", "--probes", "1"] if pin else [])

    want = json_lines(run("bigscale", argv("jax")))
    got = json_lines(port(bigscale.main, argv("port") + ["--device", "cpu"]))
    assert set(want[-1]) == set(got[-1])
    assert got[-1]["recall_at_10_sampled"] == \
        want[-1]["recall_at_10_sampled"]
    assert got[0] == {"device": "cpu"}
    assert [set(x) for x in got[1:]] == [set(x) for x in want[1:]]
    assert not (tmp_path / "port.vstore").exists()
    assert not (tmp_path / "port_spill").exists()
