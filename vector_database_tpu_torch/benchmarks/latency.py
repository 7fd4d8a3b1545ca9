#!/usr/bin/env python
"""Serving latency and small-batch throughput through ``PackedServer``
(port of ``benchmarks/latency.py``).

Per batch size (default 32 / 256 / 1024 / 4096), full scan and pruned
(``--probes``, default 256):

- **per-call latency** p50 / p99 / min over ``--calls`` calls of the
  request path: host queries in, ``PackedServer.query`` (pad, scan,
  rerank on the card), and the rows and distances back on the host. The
  port's ``query`` returns device tensors, so the timed window ends with
  their ``.cpu()`` (``_request``), as the JAX server's numpy results did;
  without it the window would time a launch, not a request;
- **sequential QPS** (batch / p50: what one synchronous client gets) and
  **chained QPS** (``qps_chained``: ``--reps`` batches of different
  queries issued back to back on the current stream, CUDA events around
  the run, ``_harness``: the pipelined steady state of an asynchronous
  server);
- **recall@k** against the exact oracle on ``--truth-q`` queries (pruned
  serving is a batch mode: its small-batch rows fall off the recall knee
  by design).

Data: the bench recipe made on the device from a seeded generator.

Usage: python -m vector_database_tpu_torch.benchmarks.latency
       [--n 10000000] [--probes 256] [--device cuda]
       (VDB_LAT_BATCHES=32,256,1024,4096 to override the sweep)
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def _request(srv, queries):
    """One request: ``srv.query`` with its results on the host."""
    rows, d2 = srv.query(queries)
    return rows.cpu(), d2.cpu()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--reps", type=int, default=20,
                    help="chained batches per throughput measurement")
    ap.add_argument("--probes", type=int, default=256,
                    help="pruned operating point (0 = full scan only)")
    ap.add_argument("--truth-q", type=int, default=512)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)
    batches = [
        int(x)
        for x in os.environ.get(
            "VDB_LAT_BATCHES", "32,256,1024,4096"
        ).split(",")
    ]

    from vector_database_tpu_torch import (
        PackedServer,
        build_index_fused,
        exact_knn,
        pack_database,
        pallas_scan_knn_packed,
    )

    n, d, k = args.n, args.d, args.k
    qmax = max(batches)
    train, test_dev = H.clustered(n, d, qmax, 10, dev)
    test = test_dev.cpu().numpy()  # requests arrive from the host
    index = build_index_fused(train, leaf_size=args.leaf)
    del train
    vectors = index.vectors
    index = None  # only the leaf-major matrix is served
    tq = min(args.truth_q, qmax)
    truth = exact_knn(vectors, test_dev[:tq], k=k)[0]
    want = [set(r) for r in truth.cpu().tolist()]

    def recall(rows):
        rows = rows[:tq].tolist()
        hits = sum(len(set(r) & w) for r, w in zip(rows, want))
        return hits / max(1, sum(len(w) for w in want[:len(rows)]))

    pack = pack_database(vectors)
    nb = pack.vb.shape[0]
    modes = [("full", None)]
    if args.probes and args.probes < nb:
        modes.append(("pruned", args.probes))

    print(json.dumps({"n": n, "d": d, "k": k, "blocks": nb,
                      "device": H.device_name(dev)}), flush=True)
    rng = np.random.RandomState(0)
    lines = []
    for b in batches:
        for mode, probes in modes:
            srv = PackedServer(pack, k=k, batch=b, probes=probes)
            srv.warmup()
            # distinct query sets per call (no cross-call caching luck)
            lats = []
            for _ in range(args.calls):
                qs = test[rng.randint(0, qmax, size=b)]
                t0 = time.perf_counter()
                _request(srv, qs)
                lats.append(time.perf_counter() - t0)
            lats = np.sort(np.asarray(lats))
            p50 = float(np.percentile(lats, 50))
            p99 = float(np.percentile(lats, 99))
            # chained steady state at this batch shape
            stack = [torch.as_tensor(test[rng.randint(0, qmax, size=b)],
                                     device=dev) for _ in range(args.reps)]
            per_batch = H.chained_s(
                lambda qs: pallas_scan_knn_packed(
                    pack, qs, k=k, q_tile=srv._q_tile, probes=probes),
                stack, dev)
            # recall at this operating point: serve enough queries to
            # cover the truth subset, in this batch size's waves
            rows, _ = _request(srv, test[:b] if b >= tq else test[:tq])
            line = {
                "batch": b, "mode": mode, "probes": probes,
                "lat_p50_ms": round(p50 * 1e3, 2),
                "lat_p99_ms": round(p99 * 1e3, 2),
                "lat_min_ms": round(float(lats[0]) * 1e3, 2),
                "qps_sequential": round(b / p50),
                "qps_chained": round(b / per_batch),
                "recall": round(recall(rows), 4),
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
