"""The out-of-core pair of harnesses on the host: ``probe_host_rerank``'s
exact variants against the production rerank, and
``probe_pin_pipeline``'s two loops.

``diff`` and ``inplace`` give the same ``[Q, C]`` keys bit for bit, and
the ``k`` smallest of each row are bitwise the distances that
``ChunkedIndex._host_rerank`` returns on the same candidates (the
production rerank is the in-place form plus masking and a stable
top-k). The pipelined and the sequential pinned loops return the same
rows and distances bit for bit (the harness asserts it; here on the
plain scan at a tiny size).
"""

import contextlib
import io
import json

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import (
    probe_host_rerank,
    probe_pin_pipeline,
)
from vector_database_tpu_torch.out_of_core import ChunkedIndex

torch.set_num_threads(2)


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(x) for x in out.getvalue().splitlines()]


def test_host_rerank_variants_equal_production():
    rng = np.random.RandomState(3)
    vec = rng.randn(5000, 96).astype(np.float32)
    qh = rng.randn(128, 96).astype(np.float32)
    safe = rng.randint(0, 5000, size=(128, 80))
    fns = probe_host_rerank.variants(vec, qh, safe)
    diff, inplace = fns["diff"](), fns["inplace"]()
    assert np.array_equal(diff.view(np.uint32), inplace.view(np.uint32))
    rows, d2 = ChunkedIndex(device="cpu")._host_rerank(
        {"cap": 5000, "vectors": vec}, safe, qh, 10)
    rows2, d22 = probe_host_rerank.production(vec, qh, safe, 10)()
    assert np.array_equal(rows, rows2) and np.array_equal(d2, d22)
    for key in (diff, inplace):
        top = np.sort(key, axis=1)[:, :10]
        assert np.array_equal(top.view(np.uint32), d2.view(np.uint32))
        pos = np.argsort(key, axis=1, kind="stable")[:, :10]
        assert np.array_equal(np.take_along_axis(safe, pos, 1), rows)


def test_host_rerank_harness_lines():
    lines = _lines(probe_host_rerank.main,
                   ["--n", "3000", "--q", "64", "--reps", "1",
                    "--device", "cpu"])
    assert lines[0] == {"device": "cpu"}
    names = [next(iter(x)) for x in lines[1:]]
    assert names == ["diff", "inplace", "dot32", "dot64", "host_rerank",
                     "gather_only_ms"]
    by = {next(iter(x)): x[next(iter(x))] for x in lines[1:]}
    for name in ("diff", "inplace", "host_rerank"):
        assert by[name]["max_abs_err_vs_diff"] == 0.0
        assert set(by[name]) == {"ms_per_chunk", "max_abs_err_vs_diff"}
    assert 0 < by["dot32"]["max_abs_err_vs_diff"] < 1e-3


def test_pin_pipeline_modes_are_bitwise_equal():
    lines = _lines(probe_pin_pipeline.main,
                   ["--n", "30000", "--chunk", "10000", "--q", "256",
                    "--reps", "1", "--probes", "1", "--device", "cpu"])
    assert lines[0] == {"device": "cpu"}
    assert lines[1]["chunks"] == 3
    assert lines[2]["full"]["bit_identical"] is True
    assert lines[3]["pruned"]["bit_identical"] is True
    assert set(lines[-1]) == {f"{tag}_{key}" for tag in ("full", "pruned")
                              for key in ("seq_qps", "pipe_qps", "speedup")}
