"""The port's headline bench (``vector_database_tpu_torch.bench``) against
the JAX package's root ``bench.py``.

JAX's ``bench.py`` runs once, as a subprocess on the CPU with one JAX
device (the port's sharded legs run in a world of one rank), started
when this module starts so that it runs beside the other tests. The
port's ``main`` runs on ``device="cpu"`` at the same environment: the
same key set, the same pruned points and headline pick. On one set of
numpy rows of the bench recipe, the port's serving leg and JAX's pack
and packed scans (Pallas in interpret mode) give the same result sets
and the same recalls. A failed leg makes the port's bench
return non-zero; at world size 1 on Gloo its sharded rows are the
single-device rows; ``build_index_fused`` takes JAX's ``donate=``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu import exact_knn as jax_exact_knn
from vector_database_tpu.ops import pallas_knn as jpk
from vector_database_tpu_torch import bench, build_index_fused
from vector_database_tpu_torch import parallel as par

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# 40,000 rows in blocks of 8192: nb = 5, so both pruned points exist
ENV = dict(VDB_BENCH_N="40000", VDB_BENCH_D="8", VDB_BENCH_Q="128",
           VDB_BENCH_TRUTH_Q="64", VDB_BENCH_SERVE_REPS="2",
           VDB_BENCH_BUCKETS="64", VDB_BENCH_PROBES="2,3")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def jax_run():
    """JAX's ``bench.py`` at ``ENV``: one CPU device (no virtual devices
    from ``conftest.py``), started before this module's first test."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="",
               PYTHONPATH=str(REPO), **ENV)
    proc = subprocess.Popen([sys.executable, str(REPO / "bench.py")],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.returncode is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_line(jax_run):
    out, err = jax_run.communicate(timeout=900)
    assert jax_run.returncode == 0, err[-3000:]
    (line,) = out.splitlines()
    return json.loads(line)


def _port(env, rows_out=None):
    """``(stdout lines, return value)`` of the port's ``main`` on the
    CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = bench.main(env=env, device="cpu", rows_out=rows_out)
    return out.getvalue().splitlines(), ret


@pytest.fixture(scope="module")
def port_run():
    rows = {}
    lines, ret = _port(ENV, rows)
    return lines, ret, rows


def test_port_prints_one_line_and_returns_0(port_run):
    lines, ret, _ = port_run
    assert ret == 0 and len(lines) == 1
    assert not [k for k in json.loads(lines[0]) if k.endswith("_error")]
    assert not dist.is_initialized()  # the world of one is gone


def test_sharded_rows_equal_single_device_rows(port_run):
    """At world size 1 (Gloo) the sharded scan is the single-device scan:
    full and at the headline pruned point, ids and distances bitwise."""
    lines, _, rows = port_run
    line = json.loads(lines[0])
    assert line["serve_sharded_devices"] == line["build_sharded_devices"] == 1
    assert line["serve_sharded_full_recall"] == line["serve_full_recall"]
    p = line["serve_sharded_pruned"]["probes"]
    assert line["serve_sharded_pruned"]["recall"] == next(
        x["recall"] for x in line["serve_pruned"] if x["probes"] == p)
    for sharded, single in (("sharded_full", "full"),
                            ("sharded_pruned", f"pruned_{p}")):
        for got, want in zip(rows[sharded], rows[single]):
            assert torch.equal(got, want), sharded


def test_failed_leg_gives_error_field_and_nonzero_return(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("sharded pack failed")

    monkeypatch.setattr(par, "pack_database_sharded", broken)
    lines, ret = _port(dict(ENV, VDB_BENCH_N="10000",
                            VDB_BENCH_SHARDED_FIELD="0"))
    (line,) = [json.loads(x) for x in lines]
    assert ret == 1
    assert line["serve_sharded_error"] == "RuntimeError: sharded pack failed"
    assert line["serve_full_recall"] > 0 and "value" in line
    assert not dist.is_initialized()


def test_donate_is_accepted_and_changes_nothing():
    x = torch.as_tensor(np.random.RandomState(0).rand(3000, 8),
                        dtype=torch.float32)
    a = build_index_fused(x, leaf_size=16, device="cpu")
    b = build_index_fused(x, leaf_size=16, device="cpu", donate=True)
    for name in ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
                 "vectors", "orig_row"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.depth, a.num_leaves) == (b.depth, b.num_leaves)


def _recipe(n, d, q):
    """The JAX bench's draw (keys 10-14), as numpy rows."""
    key = jax.random.PRNGKey
    c = max(64, n // 1000)
    centers = jax.random.uniform(key(10), (c, d), jnp.float32) * 2 - 1
    train = centers[jax.random.randint(key(11), (n,), 0, c)] + \
        0.05 * jax.random.normal(key(12), (n, d), jnp.float32)
    test = centers[jax.random.randint(key(13), (q,), 0, c)] + \
        0.05 * jax.random.normal(key(14), (q, d), jnp.float32)
    return np.array(train), np.array(test)


def test_serving_results_equal_jax_on_the_same_rows():
    """The port's serving leg on numpy rows of the bench recipe, and JAX's
    pack and packed scans (full and runtime-probes, Pallas interpret) over
    the leaf-major matrix of the same rows: per query the same result set,
    full and at every pruned point, and the same recalls against JAX's
    ``exact_knn``. JAX's pipeline packs the port's build of the rows: on
    float rows the two builds may pick another split dimension at a
    near-tie of variances (a deviation by design, ROADMAP §3), and a
    different leaf order fills the buckets differently."""
    n, d, q, truth_q, probes, buckets = 40_000, 8, 128, 64, [2, 3], 64
    train, test = _recipe(n, d, q)
    rows = {}
    fields = bench._serve_bench(n, d, 16, q, truth_q, probes, 1, buckets,
                                dev=CPU, sharded=False, rows=(train, test),
                                rows_out=rows)
    jvec = jnp.asarray(
        build_index_fused(train, leaf_size=16, device="cpu").vectors.numpy())
    jtest = jnp.asarray(test)
    truth = [set(r) for r in np.asarray(
        jax_exact_knn(jvec, jtest[:truth_q], k=bench.K)[0]).tolist()]
    pack = jpk.pack_database(jvec, buckets=buckets)
    assert pack.vb.shape[0] == 5 and fields["serve_n"] == n
    q_tile = min(512, max(256, q))
    jax_rows = {"full": jpk.pallas_scan_knn_packed(pack, jtest, k=bench.K,
                                                   q_tile=q_tile)[0]}
    for p in probes:
        jax_rows[f"pruned_{p}"] = jpk.pallas_scan_knn_packed_rt(
            pack, jtest, jnp.int32(p), k=bench.K, probes_max=max(probes),
            q_tile=q_tile)[0]

    port_recalls = dict(full=fields["serve_full_recall"], **{
        f"pruned_{x['probes']}": x["recall"] for x in fields["serve_pruned"]})
    assert sorted(port_recalls) == sorted(jax_rows)
    for key, jrows in jax_rows.items():
        want = [set(r) for r in np.asarray(jrows).tolist()]
        assert [set(r) for r in rows[key][0].tolist()] == want, key
        jax_recall = sum(len(w & t) for w, t in zip(want, truth)) / (
            truth_q * bench.K)
        assert port_recalls[key] == round(jax_recall, 4), key


def test_key_set_and_points_match_jax(jax_line, port_run):
    line = json.loads(port_run[0][0])
    assert set(line) == set(jax_line)
    assert (line["metric"], line["unit"]) == (jax_line["metric"],
                                              jax_line["unit"])
    for key in ("serve_headline_probes", "serve_buckets", "serve_n",
                "serve_q", "build_sharded_devices", "serve_sharded_devices"):
        assert line[key] == jax_line[key], key
    assert [set(x) for x in line["serve_pruned"]] == \
        [set(x) for x in jax_line["serve_pruned"]]
    def points(x):
        return [(p["probes"], p["stream_fraction"]) for p in x["serve_pruned"]]

    assert points(line) == points(jax_line)
    assert set(line["serve_sharded_pruned"]) == \
        set(jax_line["serve_sharded_pruned"])
    assert line["serve_sharded_pruned"]["probes"] == \
        jax_line["serve_sharded_pruned"]["probes"]
