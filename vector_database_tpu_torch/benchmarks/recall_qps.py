#!/usr/bin/env python
"""Recall@k against QPS: the qdrant-style benchmark of the serving knobs
(port of ``benchmarks/recall_qps.py``).

Measures, on ``--device`` (default the card):
  - index build throughput (``build_index_fused``);
  - exact-scan k-NN QPS (the bf16 streaming ``scan_knn`` and the packed
    scan ``pallas_scan_knn_packed`` over the ``bucket_scan`` kernel) with
    recall@k against the exact oracle;
  - with ``--probes``: the pruned packed scan, one line per value;
  - with ``--sweep``: buckets 2048/4096/8192 x oversample 1/4/16;
  - with ``--sharded``/``--sharded-only``: ``pack_database_sharded`` +
    ``sharded_scan_knn`` on ``make_mesh()`` (on one card a world of one
    rank over NCCL: the merge's cost beside the single-device line);
  - at n <= 2M, the tree walk (``knn`` at a radius calibrated for 0.9).

Dataset: ``VDB_DATA`` naming an ``.arff`` file or an ann-benchmarks HDF5
file (needs ``h5py``), else the bench recipe made on the device from a
seeded ``torch.Generator`` (the JAX harness's ``jax.random`` data cannot
be reproduced in torch).

QPS keys (``*_qps``) are chained times (``_harness``): ``--reps`` calls
back to back, each on the queries rotated by one more row, CUDA events
around the run. ``tree_qps`` is per call, each ending in a synchronise,
as in the JAX harness.

Usage: python -m vector_database_tpu_torch.benchmarks.recall_qps
       [--n 1000000] [--d 96] [--q 1024] [--probes 64,128] [--sweep]
       [--sharded] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def load_data(n, d, q, seed=0, device="cuda"):
    """``(train, test, name)``: numpy rows from ``VDB_DATA`` (the JAX
    harness's arff and HDF5 paths, so both packages read the same data),
    else the bench recipe as tensors on ``device``."""
    path = os.environ.get("VDB_DATA")
    if path and path.endswith(".arff"):
        from vector_database_tpu_torch.utils.arff import (
            load_arff,
            minmax_normalize,
        )

        data, _, _ = load_arff(path)
        vecs = minmax_normalize(data)[:n]
        rng = np.random.RandomState(seed)
        test = vecs[rng.randint(0, vecs.shape[0], size=q)]
        return vecs, test, f"arff:{os.path.basename(path)}"
    if path:
        h5py = H.h5py()
        from vector_database_tpu_torch.utils.datasets import (
            hdf5_size,
            load_hdf5,
        )

        rows, _ = hdf5_size(path, "/train")
        n = min(n, rows)
        parts = []
        for _, chunk in load_hdf5(path, "/train", chunk=250_000):
            parts.append(chunk)
            if sum(p.shape[0] for p in parts) >= n:
                break
        train = np.concatenate(parts)[:n]
        qrows, _ = hdf5_size(path, "/test")
        with h5py.File(path, "r") as f:
            test = np.asarray(f["test"][: min(q, qrows)], np.float32)
        return train, test, f"hdf5:{os.path.basename(path)}"
    train, test = H.clustered(n, d, q, seed, torch.device(device))
    return train, test, f"clustered:{n}x{d}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument(
        "--sweep", action="store_true",
        help="emit a (recall, QPS) curve over buckets x oversample, one "
        "JSON line per operating point",
    )
    ap.add_argument(
        "--probes", type=str, default=None,
        help="comma-separated probes values (e.g. 64,128,256): also serve "
        "through the pruned scan, one JSON line per value",
    )
    ap.add_argument(
        "--buckets", type=int, default=4096,
        help="shortlist bucket count m of the single-device serve pack",
    )
    ap.add_argument(
        "--sharded-only", action="store_true", dest="sharded_only",
        help="measure only the mesh serving path (implies --sharded)",
    )
    ap.add_argument(
        "--sharded", action="store_true",
        help="also serve through the mesh path: pack_database_sharded "
        "over make_mesh() + sharded_scan_knn",
    )
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.sharded_only:
        args.sharded = True
    dev = H.resolve(args.device)

    from vector_database_tpu_torch import (
        build_index_fused,
        exact_knn,
        knn,
        pack_database,
        pallas_scan_knn_packed,
        scan_knn,
    )
    from vector_database_tpu_torch.search import calibrate_radius

    train, test, name = load_data(args.n, args.d, args.q, device=dev)
    test = torch.as_tensor(test, dtype=torch.float32, device=dev)
    # a dataset's test split can be smaller than --q: every QPS divides
    # by the actual batch size
    nq = test.shape[0]
    report = {"dataset": name, "k": args.k, "q": nq,
              "device": H.device_name(dev)}
    print(json.dumps({"device": report["device"]}), flush=True)

    t0 = time.perf_counter()
    index = build_index_fused(torch.as_tensor(train, device=dev),
                              leaf_size=args.leaf)
    H.sync(dev)
    build_s = time.perf_counter() - t0
    report["build_s"] = round(build_s, 2)
    report["build_vps"] = round(index.n / build_s, 0)
    report["depth"] = index.depth
    del train

    truth, _ = exact_knn(index.vectors, test, k=args.k)
    truth_rows = index.orig_row[truth].cpu()
    orig = index.orig_row.cpu()
    queries = H.rolled(test, args.reps)
    q_tile = min(512, max(256, args.q))

    def to_orig(rows):
        """Leaf-major rows -> input rows, keeping -1 padding."""
        rows = rows.cpu()
        return torch.where(rows >= 0, orig[rows.clamp(min=0)], -1)

    def chained(fn):
        """(result on the unrotated queries, chained QPS)."""
        qps = 1.0 / H.chained_s(fn, queries, dev) * nq
        return fn(test), qps

    pack = None
    if not args.sharded_only:
        t0 = time.perf_counter()
        pack = pack_database(index.vectors, buckets=args.buckets)
        H.sync(dev)
        report["pack_s"] = round(time.perf_counter() - t0, 2)
        for mode, fn in (
            ("scan_bf16", lambda qs: scan_knn(index.vectors, qs, k=args.k)),
            # the serving path: database packed once, batches stream
            ("pallas", lambda qs: pallas_scan_knn_packed(
                pack, qs, k=args.k, q_tile=q_tile)),
        ):
            (rows, _), qps = chained(fn)
            report[f"{mode}_qps"] = round(qps, 0)
            report[f"{mode}_recall"] = round(
                H.recall(to_orig(rows), truth_rows), 4)

    if args.probes and not args.sharded_only:
        nb = pack.vb.shape[0]
        for p in (int(x) for x in args.probes.split(",")):
            (rows, _), qps = chained(
                lambda qs, p=p: pallas_scan_knn_packed(
                    pack, qs, k=args.k, q_tile=q_tile, probes=min(p, nb)))
            print(json.dumps({"probes": {
                "probes": min(p, nb), "blocks": nb,
                "stream_fraction": round(min(p, nb) / nb, 4),
                "qps": round(qps),
                "recall": round(H.recall(to_orig(rows), truth_rows), 4),
            }}), flush=True)

    # the single-device pack is done serving: free its blocks before the
    # sweep's and the sharded packs
    pack = None
    H.free(dev)

    if args.sweep:
        # shortlist buckets (selection granularity) x oversample (rerank
        # width); each bucket count re-packs, the previous pack freed
        for buckets in (2048, 4096, 8192):
            p = pack_database(index.vectors, buckets=buckets)
            for ov in (1, 4, 16):
                (rows, _), qps = chained(
                    lambda qs, ov=ov: pallas_scan_knn_packed(
                        p, qs, k=args.k, q_tile=q_tile, oversample=ov))
                print(json.dumps({"sweep": {
                    "buckets": buckets, "oversample": ov,
                    "qps": round(qps),
                    "recall": round(H.recall(to_orig(rows), truth_rows), 4),
                }}), flush=True)
            p = None
            H.free(dev)

    if args.sharded:
        _sharded(args, index, test, truth_rows, report, chained, q_tile, dev)

    if args.n <= 2_000_000:
        # at high D the tree prunes nothing (crossover.py): skip the walk
        # at scan scale
        r = calibrate_radius(index.vectors, test[:64], args.k, 0.9)
        knn(index, test, k=args.k, radius=r, max_leaves=256)  # warm
        dt = sum(H.host_s(lambda: knn(index, test, k=args.k, radius=r,
                                      max_leaves=256), dev)
                 for _ in range(args.reps)) / args.reps
        rows, _ = knn(index, test, k=args.k, radius=r, max_leaves=256)
        report["tree_radius"] = round(float(r), 4)
        report["tree_qps"] = round(nq / dt, 0)
        report["tree_recall"] = round(H.recall(rows, truth_rows), 4)

    print(json.dumps(report), flush=True)
    return report


def _sharded(args, index, test, truth_rows, report, chained, q_tile, dev):
    """The mesh legs: ``make_mesh()`` over every rank (a world of one
    rank when no process group exists; one this function starts, it
    destroys at the end)."""
    import torch.distributed as dist

    from vector_database_tpu_torch.parallel import (
        make_mesh,
        pack_database_sharded,
        sharded_scan_knn,
    )

    started = not dist.is_initialized()
    mesh = make_mesh(device_type=dev.type)
    try:
        t0 = time.perf_counter()
        sdb = pack_database_sharded(index.vectors, mesh,
                                    orig_rows=index.orig_row)
        H.sync(dev)
        report["sharded_devices"] = dist.get_world_size()
        report["sharded_pack_s"] = round(time.perf_counter() - t0, 2)
        (rows, _), qps = chained(lambda qs: sharded_scan_knn(
            sdb, qs, k=args.k, q_tile=q_tile))
        report["sharded_qps"] = round(qps, 0)
        report["sharded_recall"] = round(H.recall(rows, truth_rows), 4)
        if args.probes:
            # pruned x sharded: per-shard pruned stream + the same merge
            nb_loc = sdb.vb.shape[0]
            for p in (int(x) for x in args.probes.split(",")):
                p = min(p, nb_loc)
                (rows, _), qps = chained(
                    lambda qs, p=p: sharded_scan_knn(
                        sdb, qs, k=args.k, q_tile=q_tile,
                        probes=p if p < nb_loc else None))
                print(json.dumps({"sharded_probes": {
                    "probes": p, "blocks_per_shard": nb_loc,
                    "stream_fraction": round(p / nb_loc, 4),
                    "qps": round(qps),
                    "recall": round(H.recall(rows, truth_rows), 4),
                }}), flush=True)
        del sdb
        H.free(dev)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
