"""Pack variants of the serving scan, ``(block, q_tile, buckets[,
dtype])``, timed at 1024 queries on clustered rows (port of
``benchmarks/probe_kernel.py``).

The variant list is a Python literal (read with ``ast.literal_eval``);
a variant without a dtype packs ``"int8"``, as in the JAX probe. On the
card the kernel's query tile is fixed at 256 rows
(``ops/bucket_scan.scan_plan``): ``q_tile`` is the serve call's padding
unit. ``compile_s`` is the first call's seconds (on the card it includes
building and loading the kernels where this process has not yet);
``qps`` is chained (``_harness``): 20 batches back to back, each on the
queries rotated by one more row, CUDA events around the run.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_kernel
       [N] ["[(8192, 256, 4096, 'int8f'), ...]"] [--device cuda]
"""

from __future__ import annotations

import argparse
import ast
import json
import time

from vector_database_tpu_torch.benchmarks import _harness as H

D, Q, K, REPS = 96, 1024, 10, 20
QR = 256


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("variants", nargs="?", type=ast.literal_eval,
                    default=[(8192, 256, 4096)])
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch import (
        exact_knn,
        pack_database,
        pallas_scan_knn_packed,
    )

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    train, test = H.clustered(args.n, D, Q, 0, dev)
    truth = exact_knn(train, test[:QR], k=K)[0]
    queries = H.rolled(test, REPS)
    lines = []
    for var in args.variants:
        (block, q_tile, buckets) = var[:3]
        dtype = var[3] if len(var) > 3 else "int8"
        pack = pack_database(train, block=block, buckets=buckets,
                             dtype=dtype)

        def fn(qs):
            return pallas_scan_knn_packed(pack, qs, k=K, q_tile=q_tile)

        t0 = time.perf_counter()
        rows, _ = fn(test)
        r = H.recall(rows[:QR], truth)
        t_compile = time.perf_counter() - t0
        qps = Q / H.chained_s(fn, queries, dev)
        line = {"block": block, "q_tile": q_tile, "buckets": buckets,
                "dtype": dtype, "recall": round(r, 4), "qps": round(qps),
                "compile_s": round(t_compile, 1),
                "ms_per_1024q": round(1000 * Q / qps, 2)}
        print(json.dumps(line), flush=True)
        lines.append(line)
        pack = None
        H.free(dev)
    return lines


if __name__ == "__main__":
    main()
