#!/usr/bin/env python
"""Full-scan serving sweep over the pack and serve knobs (port of
``benchmarks/probe_fullscan.py``).

``block`` and ``m`` (buckets) move the scan's epilogue: w = block/m rows
share a bucket, the bucket top-k scales with m, and the exact rerank's
width with k_scan * w. This sweep measures QPS and recall@10 across
``block:m:q_tile:oversample`` configurations on clustered rows, at
q=4096 against the exact oracle on ``--truth-q`` queries. On the card the
kernel's query tile is fixed at 256 rows (``ops/bucket_scan.scan_plan``):
``q_tile`` is the serve call's padding unit and, pruned, its group size.

QPS are chained (``_harness``): ``--reps`` batches back to back, each on
the queries rotated by one more row, CUDA events around the run. A
configuration the port refuses (``ValueError``: a block that is not a
multiple of m, say) prints an ``error`` line and the sweep goes on.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_fullscan
       [--n 10000000]
       [--configs "8192:4096:512:4,16384:4096:512:2,..."]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

from vector_database_tpu_torch.benchmarks import _harness as H

DEFAULT = "8192:4096:512:4,16384:4096:512:4,16384:4096:512:2," \
          "8192:2048:512:4,32768:4096:512:2,8192:4096:384:4"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--truth-q", type=int, default=1024)
    ap.add_argument("--configs", type=str, default=DEFAULT)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch import (
        build_index_fused,
        exact_knn,
        pack_database,
        pallas_scan_knn_packed,
    )

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    n, d, k, q = args.n, args.d, args.k, args.q
    train, test = H.clustered(n, d, q, 10, dev)
    vectors = build_index_fused(train, leaf_size=16).vectors
    del train

    tq = args.truth_q
    truth = exact_knn(vectors, test[:tq], k=k)[0]
    queries = H.rolled(test, args.reps)
    lines = []
    for cfg in args.configs.split(","):
        block, m, q_tile, os_ = (int(x) for x in cfg.split(":"))
        head = {"block": block, "m": m, "q_tile": q_tile, "oversample": os_}
        try:
            t0 = time.perf_counter()
            pack = pack_database(vectors, block=block, buckets=m)
            H.sync(dev)
            pack_s = time.perf_counter() - t0

            def serve(qs):
                return pallas_scan_knn_packed(
                    pack, qs, k=k, q_tile=q_tile, oversample=os_)

            qps = q / H.chained_s(serve, queries, dev)
            rows, _ = serve(test)
            line = dict(head, w=block // m, pack_s=round(pack_s, 2),
                        qps=round(qps), us_per_q=round(1e6 / qps, 2),
                        recall=round(H.recall(rows[:tq], truth), 4))
        except ValueError as e:
            line = dict(head, error=f"{type(e).__name__}: {e}"[:200])
        pack = None
        H.free(dev)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
