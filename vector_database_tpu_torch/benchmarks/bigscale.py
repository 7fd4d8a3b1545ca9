#!/usr/bin/env python
"""Out-of-core scale run: build and serve a dataset larger than the card
through the mmap store and ``ChunkedIndex`` (port of
``benchmarks/bigscale.py``):

  host RNG -> NativeVectorStore (mmap file) -> per-chunk fused builds on
  the device -> host-resident chunk indexes -> exact cross-chunk top-k
  merge serving.

Recall is checked against a chunked exact oracle on the first 16 queries
(the full oracle would stream the whole store again; the sample catches
a broken merge). Prints JSON lines; the last is the summary. The store
and the spill directory default to ``build/`` under the working
directory (the JAX harness's lie outside the checkout) and are removed
at the end unless ``--keep``. QPS are host-clock times of ``knn``
calls, which return numpy arrays.

Usage: python -m vector_database_tpu_torch.benchmarks.bigscale
       [--n 100000000] [--d 96] [--chunk 10000000] [--q 256]
       [--path build/bigscale.vstore] [--spill build/bigscale_spill]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=10_000_000)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--path", default=os.path.join("build",
                                                   "bigscale.vstore"))
    ap.add_argument("--spill", default=os.path.join("build",
                                                    "bigscale_spill"),
                    help="disk spill dir for chunk vectors ('' = RAM)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument(
        "--reuse", action="store_true",
        help="reuse an existing store file at --path (skip ingest)",
    )
    ap.add_argument(
        "--pin", action="store_true",
        help="also measure the pinned capacity mode: packed blocks stay "
        "on the card, steady-state QPS",
    )
    ap.add_argument(
        "--probes", type=int, default=None,
        help="with --pin: also measure the pruned pinned mode "
        "(per-chunk probes)",
    )
    ap.add_argument("--reps", type=int, default=3)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch import ChunkedIndex, exact_knn
    from vector_database_tpu_torch.runtime.native_store import (
        NativeVectorStore,
    )

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    os.makedirs(os.path.dirname(args.path) or ".", exist_ok=True)

    # --- ingest: host RNG -> mmap store, a chunk at a time
    rng = np.random.RandomState(11)
    if args.reuse and os.path.exists(args.path):
        store = NativeVectorStore.open(args.path)
        if len(store) < args.n:
            raise ValueError("the existing store is smaller than --n")
        print(json.dumps({"ingest_rows": len(store), "reused": True}),
              flush=True)
    else:
        if os.path.exists(args.path):
            os.unlink(args.path)
        t0 = time.perf_counter()
        store = NativeVectorStore.create(args.path, args.d,
                                         capacity_rows=args.chunk)
        written = 0
        while written < args.n:
            rows = min(args.chunk, args.n - written)
            store.append(rng.rand(rows, args.d).astype(np.float32) * 2 - 1)
            written += rows
        ingest_s = time.perf_counter() - t0
        print(json.dumps({
            "ingest_rows": written,
            "ingest_s": round(ingest_s, 1),
            "store_gb": round(written * args.d * 4 / 2**30, 1),
        }), flush=True)

    # --- build: per-chunk fused builds on the device, indexes on the host
    t0 = time.perf_counter()
    ci = ChunkedIndex.from_store(store, chunk_rows=args.chunk,
                                 leaf_size=args.leaf,
                                 spill_dir=args.spill or None, device=dev)
    build_s = time.perf_counter() - t0
    print(json.dumps({"chunks": ci.num_chunks,
                      "build_s": round(build_s, 1),
                      "vectors_per_s": round(args.n / build_s)}), flush=True)

    # --- queries: perturbed database rows; exact-merge serving
    queries = np.stack([
        np.asarray(store.rows(i * (args.n // args.q), 1))[0]
        for i in range(args.q)
    ]) + 0.01 * rng.randn(args.q, args.d).astype(np.float32)

    t0 = time.perf_counter()
    rows, d2 = ci.knn(queries, k=args.k)
    qps = args.q / (time.perf_counter() - t0)  # cold: first chunk streams

    # steady streamed QPS: every call streams every chunk to the card
    t0 = time.perf_counter()
    for _ in range(args.reps):
        rows, d2 = ci.knn(queries, k=args.k)
    qps_steady = args.q * args.reps / (time.perf_counter() - t0)
    print(json.dumps({"streamed_steady_qps": round(qps_steady, 1)}),
          flush=True)

    def overlap(other):
        return sum(len(set(other[i].tolist()) & set(rows[i].tolist()))
                   for i in range(args.q)) / (args.q * args.k)

    pinned_qps = pruned_qps = None
    if args.pin:
        ci.pin()
        ci.knn(queries, k=args.k)  # warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            prow, _ = ci.knn(queries, k=args.k)
        pinned_qps = args.q * args.reps / (time.perf_counter() - t0)
        print(json.dumps({"pinned_steady_qps": round(pinned_qps, 1),
                          "pinned_vs_streamed_overlap":
                              round(overlap(prow), 3)}), flush=True)
        if args.probes:
            ci.knn(queries, k=args.k, probes=args.probes)  # warm
            t0 = time.perf_counter()
            for _ in range(args.reps):
                prow, _ = ci.knn(queries, k=args.k, probes=args.probes)
            pruned_qps = args.q * args.reps / (time.perf_counter() - t0)
            print(json.dumps({
                "pinned_pruned_steady_qps": round(pruned_qps, 1),
                "probes": args.probes,
                "pruned_vs_full_overlap": round(overlap(prow), 3),
            }), flush=True)
        ci.unpin()

    # --- sampled oracle: chunked exact scan for the first 16 queries
    sq = min(16, args.q)
    qs = torch.as_tensor(queries[:sq], dtype=torch.float32, device=dev)
    best_d = np.full((sq, args.k), np.inf, np.float32)
    best_r = np.full((sq, args.k), -1, np.int64)
    for start in range(0, args.n, args.chunk):
        nrows = min(args.chunk, args.n - start)
        part = torch.as_tensor(store.rows(start, nrows), device=dev)
        idx, dd = exact_knn(part, qs, k=args.k)
        del part
        cat_d = np.concatenate([best_d, dd.cpu().numpy()], 1)
        cat_r = np.concatenate([best_r, idx.cpu().numpy() + start], 1)
        order = np.argsort(cat_d, axis=1, kind="stable")[:, : args.k]
        best_d = np.take_along_axis(cat_d, order, 1)
        best_r = np.take_along_axis(cat_r, order, 1)
    hits = sum(len(set(rows[i].tolist()) & set(best_r[i].tolist()))
               for i in range(sq))
    recall = hits / (sq * args.k)

    summary = {
        "metric": f"out_of_core_build_{args.d}d_n{args.n}",
        "value": round(args.n / build_s),
        "unit": "vectors/s",
        "build_s": round(build_s, 1),
        "serve_qps_cold": round(qps, 1),
        "serve_qps_steady": round(qps_steady, 1),
        "pinned_qps_steady":
            round(pinned_qps, 1) if pinned_qps else None,
        "pinned_pruned_qps_steady":
            round(pruned_qps, 1) if pruned_qps else None,
        "recall_at_10_sampled": round(recall, 3),
    }
    print(json.dumps(summary), flush=True)

    del ci
    store.close()
    H.free(dev)
    if not args.keep:
        os.unlink(args.path)
        if args.spill:
            shutil.rmtree(args.spill, ignore_errors=True)
    return summary


if __name__ == "__main__":
    main()
