"""A/B of the capacity mode's pipelined loop (``ChunkedIndex.knn`` pinned,
host rerank): ``VDB_PIN_PIPELINE=1`` issues every chunk's scan and an
asynchronous copy of its shortlist to pinned host memory before the
first host rerank, so the card's work and the copies overlap the host's
gather and exact rerank; ``=0`` is the strictly sequential loop. The
results must be bit-identical (the merge order is unchanged): asserted
here. Port of ``benchmarks/probe_pin_pipeline.py``.

It measures an overlap on the card; ``--device cpu`` (the JAX harness's
``--cpu``) runs the plain versions and times nothing of value.
``--probes`` defaults to 16: the JAX harness's 64 is at least a default
chunk's 62 blocks, so its "pruned" leg scanned every block.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_pin_pipeline
       [--n 4000000] [--chunk 500000] [--d 96] [--q 4096] [--k 10]
       [--probes 16] [--reps 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--chunk", type=int, default=500_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--probes", type=int, default=16)
    ap.add_argument("--reps", type=int, default=4)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)
    print(json.dumps({"device": H.device_name(dev)}), flush=True)

    from vector_database_tpu_torch.out_of_core import ChunkedIndex

    rng = np.random.RandomState(7)
    nc = max(16, args.n // 1000)
    centers = rng.randn(nc, args.d).astype(np.float32)

    index = ChunkedIndex(leaf_size=16, device=dev)
    t0 = time.perf_counter()
    first = None
    for lo in range(0, args.n, args.chunk):
        rows = min(args.chunk, args.n - lo)
        assign = rng.randint(0, nc, size=rows)
        chunk = (
            centers[assign] + 0.1 * rng.randn(rows, args.d)
        ).astype(np.float32)
        if first is None:
            first = chunk[: args.q].copy()
        index.add_chunk(chunk, capacity=args.chunk)
        del chunk
    print(json.dumps({
        "build_s": round(time.perf_counter() - t0, 1),
        "chunks": index.num_chunks,
    }), flush=True)
    index.pin()

    queries = (
        first + 0.05 * rng.randn(args.q, args.d).astype(np.float32)
    )

    def timed(mode_env: str, probes):
        kw = {"probes": probes} if probes else {}
        before = os.environ.get("VDB_PIN_PIPELINE")
        os.environ["VDB_PIN_PIPELINE"] = mode_env
        try:
            r, d = index.knn(queries, k=args.k, **kw)  # warm
            t0 = time.perf_counter()
            for _ in range(args.reps):
                r, d = index.knn(queries, k=args.k, **kw)
            dt = (time.perf_counter() - t0) / args.reps
        finally:
            if before is None:
                del os.environ["VDB_PIN_PIPELINE"]
            else:
                os.environ["VDB_PIN_PIPELINE"] = before
        return r, d, round(args.q / dt)

    out = {}
    for tag, probes in (("full", None), ("pruned", args.probes)):
        r_seq, d_seq, qps_seq = timed("0", probes)
        r_pipe, d_pipe, qps_pipe = timed("1", probes)
        if not (np.array_equal(r_seq, r_pipe)
                and np.array_equal(d_seq.view(np.int32),
                                   d_pipe.view(np.int32))):
            raise AssertionError(f"{tag}: pipelined != sequential")
        out[f"{tag}_seq_qps"] = qps_seq
        out[f"{tag}_pipe_qps"] = qps_pipe
        out[f"{tag}_speedup"] = round(qps_pipe / max(qps_seq, 1), 3)
        print(json.dumps({tag: {
            "seq_qps": qps_seq, "pipe_qps": qps_pipe,
            "bit_identical": True,
        }}), flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
