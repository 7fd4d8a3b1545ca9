#!/usr/bin/env python
"""Split the packed scan's per-batch cost into its pieces (port of
``benchmarks/probe_epilogue.py``).

Each piece is timed alone, in microseconds per query:

  - ``full_us_per_q``: the whole ``pallas_scan_knn_packed`` call (pruned
    to ``--probes`` blocks per group of 512 queries when given; the JAX
    harness has no such flag and times the full scan);
  - ``kernel_us_per_q``: ``ops/bucket_scan.bucket_scan`` launched directly
    on the pack's tensors (with the pruned block map when ``--probes`` is
    given: the map is made once, outside the clock);
  - ``bucket_topk_us_per_q``: what the port runs to shortlist buckets, the
    stable full-row sort of a ``[Q, m]`` accumulator
    (``ops/packed_knn._shortlist_rows``), cut to ``k_scan`` columns;
  - ``bucket_topk_unstable_us_per_q``: ``torch.topk`` of the same
    accumulator, the library's top-k, which is not stable (it stands
    where the JAX harness timed the TPU's ``lax.approx_max_k``, which has
    no counterpart here);
  - ``rerank_us_per_q``: the ``[Q, k_scan * w, D]`` gather, exact f32
    distances and the stable top-k of ``pallas_scan_knn_packed``;
  - ``selection_us_per_q``: the pruned mode's block map,
    ``ops/packed_knn._block_map`` (at ``--probes``, else every block).

Each piece is ``--reps`` calls back to back, each on an input perturbed
by the call's index, CUDA events around the run (``_harness``). The data
are the JAX harness's: ``RandomState(0)`` uniform rows in [-1, 1].

Usage: python -m vector_database_tpu_torch.benchmarks.probe_epilogue
       [--n 1000000] [--q 4096] [--probes 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probes", type=int, default=None,
                    help="split the pruned scan at this many blocks per "
                    "query group (default: the full scan)")
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch import pack_database
    from vector_database_tpu_torch.ops.bucket_scan import bucket_scan
    from vector_database_tpu_torch.ops.packed_knn import (
        _block_map,
        _round_up,
        _scan_queries,
        pallas_scan_knn_packed,
    )

    rng = np.random.RandomState(0)
    v = torch.as_tensor(rng.rand(args.n, args.d).astype(np.float32) * 2 - 1,
                        device=dev)
    qs = torch.as_tensor(rng.rand(args.q, args.d).astype(np.float32) * 2 - 1,
                         device=dev)
    pack = pack_database(v)
    nb, m, block = pack.vb.shape[0], pack.m, pack.block
    w = block // m
    k_scan = min(args.k * 4, m)
    q_tile = 512
    probes = args.probes if args.probes and args.probes < nb else None
    out = {"n": args.n, "q": args.q, "nb": nb, "m": m, "k_scan": k_scan,
           "reps": args.reps, "probes": probes,
           "device": H.device_name(dev)}
    reps = list(range(args.reps))

    def us_per_q(fn):
        return H.chained_s(fn, reps, dev) / args.q * 1e6

    # ---- the whole serve call (reference point) ----
    out["full_us_per_q"] = us_per_q(lambda t: pallas_scan_knn_packed(
        pack, qs + t * 1e-6, k=args.k, q_tile=q_tile, probes=probes))

    # ---- the kernel alone, on the pack's tensors ----
    q_pad = _round_up(args.q, q_tile)
    kw = dict(m=m, bits=pack.bits)
    qk = qs
    if probes is not None:
        order, bmap = _block_map(pack, qs, q_tile=q_tile, probes=probes)
        qk = qs[order]  # the scan sees the queries in map order
        kw.update(bmap=bmap, nprobe=probes, q_tile=q_tile)

    def kernel_only(t):
        qp = torch.nn.functional.pad(
            qk + t * 1e-6, (0, pack.d_pad - args.d, 0, q_pad - args.q))
        return bucket_scan(pack.vn, pack.vb, _scan_queries(pack, qp), **kw)

    out["kernel_us_per_q"] = us_per_q(kernel_only)

    # ---- bucket top-k over a [Q, m] accumulator ----
    acc0 = torch.as_tensor(rng.rand(args.q, m).astype(np.float32),
                           device=dev)

    def bucket_topk(t):
        vals, pos = torch.sort(acc0 + t * 1e-9, dim=1, stable=True)
        return vals[:, :k_scan], pos[:, :k_scan]

    out["bucket_topk_us_per_q"] = us_per_q(bucket_topk)
    out["bucket_topk_unstable_us_per_q"] = us_per_q(
        lambda t: torch.topk(acc0 + t * 1e-9, k_scan, dim=1, largest=False))

    # ---- shortlist rerank: gather + exact f32 + final top-k ----
    short0 = torch.as_tensor(
        rng.randint(0, args.n, size=(args.q, k_scan * w)).astype(np.int32),
        device=dev)

    def rerank(t):
        safe = short0.clamp(0, args.n - 1).long()
        diff = v[safe] - (qs[:, None, :] + t * 1e-6)
        key = torch.sum(diff * diff, dim=-1)
        key = torch.where((short0 < args.n) & torch.isfinite(key), key,
                          float("inf"))
        vals, pos = torch.sort(key, dim=1, stable=True)
        return vals[:, :args.k], short0.gather(1, pos[:, :args.k])

    out["rerank_us_per_q"] = us_per_q(rerank)

    # ---- pruned-mode selection: the block map ----
    if pack.cent is not None:
        out["selection_us_per_q"] = us_per_q(lambda t: _block_map(
            pack, qs + t * 1e-6, q_tile=q_tile, probes=probes or nb))

    for key in list(out):
        if key.endswith("_us_per_q"):
            out[key] = round(out[key], 3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
