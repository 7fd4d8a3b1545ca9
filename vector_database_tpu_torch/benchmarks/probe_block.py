#!/usr/bin/env python
"""The serving scan's block size against its query grouping at 10M x 96
(port of ``benchmarks/probe_block.py``).

``block`` sets how many rows stream per block: w = block / m rows share
each bucket, so the per-block epilogue (the id encode and the running
minimum) amortizes over more columns as the block grows. On the card the
kernel's query tile is fixed at 256 rows (``ops/bucket_scan.scan_plan``);
``q_tile`` here is the serve call's wave and group size (the padding
unit of the queries, and in pruned serving the queries that share one
block list), not the kernel's tile.

Prints one JSON line per (block, q_tile). ``batch_ms`` and ``qps`` are
chained (``_harness``): ``--reps`` batches back to back, each on its own
perturbed queries, CUDA events around the run. Data: the JAX probe's,
``RandomState(3)`` uniform rows in [-1, 1].

Usage: python -m vector_database_tpu_torch.benchmarks.probe_block
       [--n 10000000] [--blocks 8192,16384,32768] [--q-tiles 512]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--blocks", type=str, default="8192,16384,32768")
    ap.add_argument("--q-tiles", type=str, default="512")
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch.ops.packed_knn import (
        pack_database,
        pallas_scan_knn_packed,
    )

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    rng = np.random.RandomState(3)
    vecs = torch.as_tensor(
        rng.rand(args.n, args.d).astype(np.float32) * 2 - 1, device=dev)
    queries = torch.as_tensor(
        rng.rand(args.q, args.d).astype(np.float32) * 2 - 1, device=dev)
    steps = list(range(args.reps))

    base = None
    lines = []
    for block in (int(b) for b in args.blocks.split(",")):
        pack = pack_database(vecs, block=block)
        for q_tile in (int(t) for t in args.q_tiles.split(",")):
            dt = H.chained_s(
                lambda i: pallas_scan_knn_packed(
                    pack, queries + 1e-7 * i, k=args.k, q_tile=q_tile),
                steps, dev)
            qps = args.q / dt
            rec = {
                "block": block,
                "q_tile": q_tile,
                "batch_ms": round(dt * 1e3, 2),
                "qps": round(qps, 1),
            }
            if base is None:
                base = qps
            rec["vs_8192"] = round(qps / base, 3)
            print(json.dumps(rec), flush=True)
            lines.append(rec)
        pack = None
        H.free(dev)
    return lines


if __name__ == "__main__":
    main()
