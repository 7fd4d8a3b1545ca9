#!/usr/bin/env python
"""``DynamicIndex`` mutate + serve steady state: when does packed serving
win? (port of ``benchmarks/probe_churn.py``).

``DynamicIndex`` serves the main segment and the delta as separate parts:
an ``add`` only rebuilds the small delta view (the main pack survives
adds; fresh rows merge exactly per batch); a main-segment removal
invalidates the main view, which the exact scan recovers with one
``[N]``-bool mask, and packed serving with ``PackedDB.mask_rows`` (the
bf16 base pack survives the whole compaction epoch; a removal epoch
rebuilds only the ``[1, N]`` norm row on the device).

Measured per database size (host clock: ``knn`` returns numpy arrays):

  t_scan         -- steady exact-scan batch
  t_packed       -- steady packed batch (same epoch)
  t_scan_add     -- first scan batch after an add (delta view rebuild)
  t_packed_add   -- first packed batch after an add (no repack)
  t_scan_rm      -- first scan batch after remove_ids (mask upload)
  t_packed_rm    -- first packed batch after remove_ids (mask upload +
                    norm-row rebuild via mask_rows)

Packed serving wins a removal epoch of T batches when
  T > (t_packed_rm - t_scan_rm) / (t_scan - t_packed);
for add epochs it wins whenever t_packed_add < t_scan_add.

Prints one JSON line per database size.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_churn
       [--sizes 1000000,10000000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=str, default="1000000")
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=3)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)
    name = H.device_name(dev)

    from vector_database_tpu_torch.dynamic import DynamicIndex

    lines = []
    dyn = None
    for n in (int(x) for x in args.sizes.split(",")):
        # free the previous size's tensors (index, serve view, pack)
        # before the next build
        dyn = None
        H.free(dev)
        rng = np.random.RandomState(0)
        base = rng.rand(n, args.d).astype(np.float32) * 2 - 1
        queries = rng.rand(args.q, args.d).astype(np.float32) * 2 - 1
        dyn = DynamicIndex(base, leaf_size=16, device=dev)
        del base

        def scan_batch():
            dyn.knn(queries, k=args.k)

        def packed_batch():
            dyn.knn(queries, k=args.k, exact=False, packed=True)

        def timed(fn, reps):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) / reps

        def epoch_first(mutate, batch, epochs):
            """Mean first-batch-after-mutation time; the first epoch
            warms the post-mutation paths."""
            mutate()
            batch()
            ts = []
            for _ in range(epochs):
                mutate()
                t0 = time.perf_counter()
                batch()
                ts.append(time.perf_counter() - t0)
            return sum(ts) / len(ts)

        # steady batches (warm first)
        scan_batch()
        t_scan = timed(scan_batch, args.reps)
        packed_batch()
        t_packed = timed(packed_batch, args.reps)
        pack_obj = dyn._main.pack  # the base pack, served unmasked

        # add churn: one fresh row per epoch
        def add_one():
            dyn.add(rng.rand(1, args.d).astype(np.float32) * 2 - 1)

        t_scan_add = epoch_first(add_one, scan_batch, args.epochs)
        t_packed_add = epoch_first(add_one, packed_batch, args.epochs)
        pack_survived = dyn._main_view().pack is pack_obj

        # remove churn: tombstone one main row per epoch
        rm_iter = iter(range(n))

        def remove_one():
            dyn.remove_ids([next(rm_iter)])

        t_scan_rm = epoch_first(remove_one, scan_batch, args.epochs)
        t_packed_rm = epoch_first(remove_one, packed_batch, args.epochs)
        base_survived = dyn._main.pack is pack_obj

        denom = t_scan - t_packed
        crossover_rm = (
            round((t_packed_rm - t_scan_rm) / denom, 2) if denom > 0
            else None
        )
        line = {
            "n": n,
            "q": args.q,
            "t_scan_batch_s": round(t_scan, 4),
            "t_packed_batch_s": round(t_packed, 4),
            "t_scan_first_after_add_s": round(t_scan_add, 4),
            "t_packed_first_after_add_s": round(t_packed_add, 4),
            "pack_survived_adds": pack_survived,
            "t_scan_first_after_remove_s": round(t_scan_rm, 4),
            "t_packed_first_after_remove_s": round(t_packed_rm, 4),
            "base_pack_survived_removes": base_survived,
            "scan_qps": round(args.q / t_scan),
            "packed_qps": round(args.q / t_packed),
            "remove_crossover_batches_per_epoch": crossover_rm,
            "device": name,
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
