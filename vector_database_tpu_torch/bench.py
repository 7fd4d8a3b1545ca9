#!/usr/bin/env python
"""Headline benchmark: build throughput and certified serving QPS/recall
(port of the root ``bench.py``).

One run on one device (default the card) measures:

- **index build throughput**: ``build_index_fused`` over uniform rows in
  [-1, 1) made on the device from a seeded ``torch.Generator`` outside
  the timed window (the builder is data-oblivious); one warm build, then
  the best of two timed builds (seeds 1 and 2). These are the
  ``metric``/``value``/``unit``/``vs_baseline`` fields. ``vs_baseline``
  is against the reference's C# build of ~10M rows in ~3 minutes on a
  laptop (its README.md:93-100), not against any accelerator;
- **sharded build throughput** (``build_sharded_*``):
  ``parallel.build_index_sharded`` on ``make_mesh()``;
- **serving QPS and recall@10** on the clustered recipe
  (``benchmarks/_harness.clustered``: ``max(64, n // 1000)`` centres,
  sigma 0.05): ``pack_database`` of the build's leaf-major matrix, the
  full packed scan, and pruned points through one runtime-probes map
  (``probes_max`` = the largest point), recall@10 against ``exact_knn``
  on the first ``VDB_BENCH_TRUTH_Q`` queries; ``serve_headline_*`` is
  the best QPS at recall >= 0.95 (the full scan counts as a point);
- **the mesh serving leg** (``serve_sharded_*``):
  ``pack_database_sharded`` and the public ``sharded_scan_knn``, full and
  at the headline pruned point (``probes_max`` = the rank's block
  count), the ``[Q, k]`` merge included.

The sharded legs run on ``make_mesh()``: over every rank of an existing
process group, else a world of one rank (NCCL on the card, Gloo on the
CPU) that the leg starts and destroys.

Ids are positions in the leaf-major matrix on every side: the truth is
``exact_knn`` over that matrix, and the sharded pack gets no
``orig_rows``.

Timing. Builds and packs: the host clock around work that ends in a
synchronise. QPS: ``q * reps`` over ``reps`` calls issued back to back
on rotated copies of the queries, after one warm call (which also takes
the kernels' first-use build), CUDA events around the run
(``benchmarks/_harness.chained_s``). The sharded pruned window holds the
chained calls only.

Output: exactly one JSON line on stdout, with the JAX bench's keys for
the same environment; the card's name and power limit go to stderr
first. A failed build-field or serving leg leaves a ``*_error`` field in
the line, as in JAX, so the primary fields are not lost, and makes the
run return 1 (JAX's exits 0).

Environment knobs (the JAX bench's names and defaults): VDB_BENCH_N
(rows, 10,000,000), VDB_BENCH_D (dims, 96), VDB_BENCH_LEAF (16),
VDB_BENCH_TIE (``positional`` or ``mean_id``), VDB_BENCH_SHARDED=1 (time
the primary build through ``build_index_sharded`` instead),
VDB_BENCH_INGEST=1 (the primary build starts from a host numpy array,
streamed by ``stream_rows_to_device`` inside the window),
VDB_BENCH_SHARDED_FIELD=0, VDB_BENCH_SERVE=0 and
VDB_BENCH_SERVE_SHARDED=0 (skip a leg), VDB_BENCH_Q (serving batch,
4096), VDB_BENCH_TRUTH_Q (1024), VDB_BENCH_PROBES (``192,256,320``),
VDB_BENCH_SERVE_REPS (20), VDB_BENCH_BUCKETS (4096).

Usage: python -m vector_database_tpu_torch.bench
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from vector_database_tpu_torch import (
    build_index_fused,
    exact_knn,
    pack_database,
    pallas_scan_knn_packed,
    pallas_scan_knn_packed_rt,
)
from vector_database_tpu_torch import parallel as par
from vector_database_tpu_torch.benchmarks import _harness as H
from vector_database_tpu_torch.runtime.native_store import (
    stream_rows_to_device,
)

K = 10
# the reference's published build: ~10M rows in ~3 minutes
REFERENCE_RATE = 10_000_000 / 180.0


def main(env=None, device=None, rows_out=None) -> int:
    """Run the legs the knobs in ``env`` (default ``os.environ``) ask for
    on ``device`` (default ``cuda``, which needs a card) and print the
    JSON line; 1 when a leg failed, else 0. ``rows_out``: a dict to fill
    with the ``(rows, sq_dists)`` of each serving result the recalls read
    (``full``, ``pruned_<p>``, ``sharded_full``, ``sharded_pruned``)."""
    env = os.environ if env is None else env
    n = int(env.get("VDB_BENCH_N", 10_000_000))
    d = int(env.get("VDB_BENCH_D", 96))
    leaf = int(env.get("VDB_BENCH_LEAF", 16))
    tie = env.get("VDB_BENCH_TIE", "positional")
    sharded = env.get("VDB_BENCH_SHARDED", "") == "1"
    ingest = env.get("VDB_BENCH_INGEST", "") == "1"
    want_field = env.get("VDB_BENCH_SHARDED_FIELD", "1") == "1" and not sharded
    dev = H.resolve("cuda" if device is None else str(device))
    print(H.device_name(dev), file=sys.stderr, flush=True)

    mesh_cm = _world(dev) if sharded or want_field else \
        contextlib.nullcontext()
    with mesh_cm as mesh:
        out = _build_bench(n, d, leaf, tie, dev, mesh=mesh, sharded=sharded,
                           ingest=ingest)
        if want_field:
            try:
                out.update(_sharded_build_field(n, d, leaf, tie, dev, mesh,
                                                ingest))
            except Exception as e:  # never lose the primary line
                out["build_sharded_error"] = _error(e)

    if env.get("VDB_BENCH_SERVE", "1") == "1":
        try:
            out.update(_serve_bench(
                n, d, leaf,
                int(env.get("VDB_BENCH_Q", 4096)),
                int(env.get("VDB_BENCH_TRUTH_Q", 1024)),
                [int(x) for x in
                 env.get("VDB_BENCH_PROBES", "192,256,320").split(",")],
                int(env.get("VDB_BENCH_SERVE_REPS", 20)),
                buckets=int(env.get("VDB_BENCH_BUCKETS", 4096)),
                dev=dev,
                sharded=env.get("VDB_BENCH_SERVE_SHARDED", "1") == "1",
                rows_out=rows_out,
            ))
        except Exception as e:
            out["serve_error"] = _error(e)

    print(json.dumps(out), flush=True)
    return 1 if any(key.endswith("_error") for key in out) else 0


def _error(e: Exception) -> str:
    """The traceback on stderr; the line's ``*_error`` text."""
    traceback.print_exc()
    return f"{type(e).__name__}: {e}"[:200]


@contextlib.contextmanager
def _world(dev: torch.device):
    """``make_mesh()`` over every rank; a world of one rank started here
    when no process group exists, destroyed on the way out."""
    started = not dist.is_initialized()
    try:
        yield par.make_mesh(device_type=dev.type)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _uniform(n: int, d: int, seed: int, dev: torch.device) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((n, d), generator=g, device=dev).mul_(2.0).sub_(1.0)


def _host_uniform(n: int, d: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, d).astype(np.float32) \
        * 2.0 - 1.0


def _build_s(build, rows, dev: torch.device) -> float:
    """Seconds of ``build(rows)``, synchronised; the index is dropped and
    its memory returned before this returns."""
    H.sync(dev)
    t0 = time.perf_counter()
    index = build(rows)
    H.sync(dev)
    secs = time.perf_counter() - t0
    del index
    H.free(dev)
    return secs


def _build_bench(n, d, leaf, tie, dev, *, mesh, sharded, ingest) -> dict:
    """The primary build: one warm build, then the best of two timed
    builds (seeds 1 and 2)."""
    if sharded:
        def build(vecs):
            return par.build_index_sharded(vecs, mesh, leaf_size=leaf,
                                           donate=True, tie_break=tie)
    else:
        def build(vecs):
            return build_index_fused(vecs, leaf_size=leaf, donate=True,
                                     tie_break=tie)
    if ingest:
        # the window covers the host -> device stream and the build
        device_build = build

        def build(host):
            return device_build(stream_rows_to_device(
                lambda s, rows: host[s:s + rows], n, d, device=dev))

        def make(seed):
            return _host_uniform(n, d, seed)
    else:
        def make(seed):
            return _uniform(n, d, seed, dev)

    _build_s(build, make(0), dev)  # warm: first-use costs out of the window
    secs = min(_build_s(build, make(seed), dev) for seed in (1, 2))
    rate = n / secs
    tag = ("_sharded" if sharded else "") + ("_ingest" if ingest else "")
    return {
        "metric": f"index_build_throughput_{d}d_n{n}_leaf{leaf}{tag}",
        "value": round(rate, 1),
        "unit": "vectors/s",
        "vs_baseline": round(rate / REFERENCE_RATE, 3),
    }


def _sharded_build_field(n, d, leaf, tie, dev, mesh, ingest) -> dict:
    """``build_index_sharded`` on the mesh: one warm build (seed 3), one
    timed (seed 4). With ``ingest`` the rows start on the host, as in
    JAX, and each rank takes its block from there."""
    make = (lambda s: _host_uniform(n, d, s)) if ingest else \
        (lambda s: _uniform(n, d, s, dev))

    def build(vecs):
        return par.build_index_sharded(vecs, mesh, leaf_size=leaf,
                                       donate=True, tie_break=tie)

    _build_s(build, make(3), dev)
    secs = _build_s(build, make(4), dev)
    return {"build_sharded_vps": round(n / secs, 1),
            "build_sharded_devices": mesh.size()}


def _served(fn, test, queries, dev):
    """``(fn(test), QPS)``: the chained QPS of ``fn`` over ``queries``
    (``reps`` rotated copies of ``test``), then one call on ``test`` for
    the recall."""
    qps = test.shape[0] / H.chained_s(fn, queries, dev)
    return fn(test), qps


def _serve_bench(n, d, leaf, q, truth_q, probes_list, reps, buckets=4096, *,
                 dev, sharded=True, rows=None, rows_out=None) -> dict:
    """Clustered-data serving: the full packed scan and the pruned points,
    then the mesh leg; returns the ``serve_*`` fields. ``rows``: the
    recipe's ``(train, test)`` given by the caller (host or device), in
    place of the rows made from the seeded generator."""
    if rows is None:
        train, test = H.clustered(n, d, q, 10, dev)
    else:
        train, test = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                       for x in rows)
    n, q = train.shape[0], test.shape[0]
    # serving reads only the leaf-major matrix: the node tables and the
    # input rows are dropped at once
    vectors = build_index_fused(train, leaf_size=leaf, donate=True).vectors
    del train
    H.free(dev)
    keep = rows_out if rows_out is not None else {}

    truth = exact_knn(vectors, test[:truth_q], k=K)[0]

    def recall(result):
        return round(H.recall(result[0][:truth_q], truth), 4)

    H.sync(dev)
    t0 = time.perf_counter()
    pack = pack_database(vectors, buckets=buckets)
    H.sync(dev)
    pack_s = time.perf_counter() - t0

    q_tile = min(512, max(256, q))
    queries = H.rolled(test, reps)
    keep["full"], full_qps = _served(
        lambda qs: pallas_scan_knn_packed(pack, qs, k=K, q_tile=q_tile),
        test, queries, dev)
    fields = {
        "serve_n": n,
        "serve_q": q,
        "serve_buckets": buckets,
        "serve_pack_s": round(pack_s, 2),
        "serve_full_qps": round(full_qps),
        "serve_full_recall": recall(keep["full"]),
    }

    # pruned points through one runtime-probes map, probes_max wide
    nb = pack.vb.shape[0]
    pts = sorted({min(p, nb) for p in probes_list})
    pmax = max(pts)
    if pmax < nb:  # pruning only makes sense with blocks to skip
        pruned = []
        for p in pts:
            keep[f"pruned_{p}"], qps = _served(
                lambda qs, p=p: pallas_scan_knn_packed_rt(
                    pack, qs, p, k=K, probes_max=pmax, q_tile=q_tile),
                test, queries, dev)
            pruned.append({
                "probes": p,
                "stream_fraction": round(p / nb, 4),
                "qps": round(qps),
                "recall": recall(keep[f"pruned_{p}"]),
            })
        fields["serve_pruned"] = pruned
        ok = [pt for pt in pruned if pt["recall"] >= 0.95]
        ok.append({"probes": nb, "qps": fields["serve_full_qps"],
                   "recall": fields["serve_full_recall"]})
        best = max(ok, key=lambda pt: pt["qps"])
        fields["serve_headline_qps"] = best["qps"]
        fields["serve_headline_recall"] = best["recall"]
        fields["serve_headline_probes"] = best["probes"]
        # the >= 100k batched QPS target on deep-image-shaped data
        fields["serve_qps_vs_target"] = round(best["qps"] / 100_000, 3)

    if sharded:
        try:
            headline_p = None
            if fields.get("serve_headline_probes", nb) < nb:
                headline_p = fields["serve_headline_probes"]
            elif pts[0] < nb:
                headline_p = pts[len(pts) // 2]
            # the single-device pack is done: free its blocks before the
            # sharded pack is made
            pack = None
            H.free(dev)
            fields.update(_serve_sharded_leg(
                vectors, test, queries, recall, q_tile=q_tile,
                buckets=buckets, probes=headline_p, dev=dev, keep=keep))
        except Exception as e:
            fields["serve_sharded_error"] = _error(e)
    return fields


def _serve_sharded_leg(vectors, test, queries, recall, *, q_tile, buckets,
                       probes, dev, keep) -> dict:
    """``pack_database_sharded`` on ``make_mesh()`` and the public
    ``sharded_scan_knn``: the full scan and one pruned point, each rank
    walking at most its own block count."""
    n = vectors.shape[0]
    with _world(dev) as mesh:
        t0 = time.perf_counter()
        sdb = par.pack_database_sharded(vectors, mesh, buckets=buckets,
                                        donate=n > 2_000_000)
        H.sync(dev)
        fields = {
            "serve_sharded_devices": mesh.size(),
            "serve_sharded_pack_s": round(time.perf_counter() - t0, 2),
        }
        keep["sharded_full"], qps = _served(
            lambda qs: par.sharded_scan_knn(sdb, qs, k=K, q_tile=q_tile),
            test, queries, dev)
        fields["serve_sharded_full_qps"] = round(qps)
        fields["serve_sharded_full_recall"] = recall(keep["sharded_full"])

        nb_loc = sdb.vb.shape[0]
        if probes is not None and probes < nb_loc:
            keep["sharded_pruned"], qps = _served(
                lambda qs: par.sharded_scan_knn(
                    sdb, qs, k=K, q_tile=q_tile, probes=probes,
                    probes_max=nb_loc),
                test, queries, dev)
            fields["serve_sharded_pruned"] = {
                "probes": probes,
                "qps": round(qps),
                "recall": recall(keep["sharded_pruned"]),
            }
        del sdb
        H.free(dev)
    return fields


if __name__ == "__main__":
    sys.exit(main())
