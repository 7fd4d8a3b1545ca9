#!/usr/bin/env python
"""Tree against scan by dimensionality (port of
``benchmarks/crossover.py``).

The BSP tree is the engine for low-dimensional and boolean workloads;
the packed scan is the high-dimensional server (at 96-d every split
plane is uninformative and the tree prunes nothing). Per dimensionality
this times

  - the tree path: the port's frontier walk ``search._traverse_bfs``, the
    exact ``search._rerank`` and a top-k, at a radius calibrated for
    ~0.95 recall@k and a leaf buffer doubled until no query overflows
    (the JAX harness's ``_traverse`` is a DFS; the frontier walk reaches
    the same leaves);
  - the packed scan (``pallas_scan_knn_packed``);

plus one boolean-matrix line: exact-match identification (single-branch
``_descend`` + ``_locate_in_leaf``) against the exact Hamming scan.

QPS are chained (``_harness``): ``--reps`` calls back to back, each on
the queries rotated by one more row, CUDA events around the run. Data:
the bench recipe on the device, seeded per dimensionality.

Usage: python -m vector_database_tpu_torch.benchmarks.crossover
       [--n 1000000] [--q 1024] [--dims 2,4,8,16,32,96] [--device cuda]
Prints one JSON line per configuration and a crossover summary.
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
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dims", type=str, default="2,4,8,16,32,96")
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch import (
        BoolMatrixIndex,
        build_index_fused,
        exact_knn,
        pack_database,
        pallas_scan_knn_packed,
    )
    from vector_database_tpu_torch.ops.exact import (
        pairwise_sq_dists,
        smallest_k,
    )
    from vector_database_tpu_torch.search import (
        _descend,
        _locate_in_leaf,
        _rerank,
        _traverse_bfs,
        calibrate_radius,
        search,
    )

    print(json.dumps({"device": H.device_name(dev)}), flush=True)

    def chained_qps(fn, test):
        return args.q / H.chained_s(fn, H.rolled(test, args.reps), dev)

    def tree_knn(index, qs, radius, k, max_leaves):
        leaves, _, _ = _traverse_bfs(
            index.dim, index.mid, index.low, index.high, qs, radius,
            max_leaves=max_leaves, depth=index.depth,
        )
        rows, d2, _, _, _ = _rerank(
            index.leaf_start, index.leaf_count, index.vectors,
            index.orig_row, leaves, qs, radius, leaf_cap=index.leaf_cap,
        )
        vals, pos = smallest_k(d2, k)
        return rows.gather(1, pos), vals

    summary = []
    for d in [int(x) for x in args.dims.split(",")]:
        train, test = H.clustered(args.n, d, args.q, 17 * d, dev)
        index = build_index_fused(train, leaf_size=args.leaf)
        del train
        truth, _ = exact_knn(index.vectors, test, k=args.k)
        truth_rows = index.orig_row[truth]

        pack = pack_database(index.vectors)
        q_tile = min(512, max(256, args.q))
        prow, _ = pallas_scan_knn_packed(pack, test, k=args.k)
        scan_rec = H.recall(index.orig_row[prow], truth_rows)
        scan_qps = chained_qps(lambda qs: pallas_scan_knn_packed(
            pack, qs, k=args.k, q_tile=q_tile), test)
        pack = None

        r = calibrate_radius(index.vectors, test[:64], args.k, 0.95)
        # a leaf buffer wide enough for this radius: double until no
        # overflow, but cap the rerank's candidate rows (Q * leaves *
        # leaf_cap); past the cap the tree prunes nothing and the verdict
        # is "scan", not an out-of-memory
        cand_cap = 64 << 20
        leaf_cap_max = max(64, cand_cap // (args.q * args.leaf))
        max_leaves = 64
        pruned = True
        while True:
            res = search(index, test, r, max_leaves=max_leaves,
                         auto_grow=False)
            if not bool(res.overflow.any()):
                break
            if max_leaves >= min(index.num_leaves, leaf_cap_max):
                pruned = False
                break
            max_leaves *= 2
        res = None

        if not pruned:
            line = {
                "d": d, "n": args.n, "tree_qps": None,
                "tree_recall": None, "tree_leaves": max_leaves,
                "radius": round(float(r), 4),
                "scan_qps": round(scan_qps),
                "scan_recall": round(scan_rec, 4), "winner": "scan",
                "note": "tree prunes nothing at this d/recall",
            }
        else:
            rows, _ = tree_knn(index, test, r, args.k, max_leaves)
            tree_rec = H.recall(rows, truth_rows)
            tree_qps = chained_qps(
                lambda qs: tree_knn(index, qs, r, args.k, max_leaves), test)
            line = {
                "d": d, "n": args.n, "tree_qps": round(tree_qps),
                "tree_recall": round(tree_rec, 4),
                "tree_leaves": max_leaves,
                "radius": round(float(r), 4), "scan_qps": round(scan_qps),
                "scan_recall": round(scan_rec, 4),
                "winner": "tree" if tree_qps > scan_qps else "scan",
            }
        print(json.dumps(line), flush=True)
        summary.append(line)
        index = None
        H.free(dev)

    # boolean-matrix line: identify-style Hamming workload at p = 64
    rng = np.random.RandomState(7)
    p = 64
    mat = rng.rand(args.n, p) < 0.5  # distinct objects
    qprops = mat[rng.randint(0, args.n, args.q)]
    bidx = BoolMatrixIndex(mat, leaf_size=args.leaf, device=dev)
    qsigned = torch.as_tensor(qprops.astype(np.float32) * 2 - 1,
                              device=dev)
    # every object identifies to itself
    if not bool((bidx.identify_batch(qprops[:64]) >= 0).all()):
        raise AssertionError("a stored object failed to identify")
    idx = bidx._index

    # tree: exact-match identification (Hamming 0, radius 0: the only
    # Hamming ball the +-1 tree can prune), one branch per level
    def identify_fn(qs):
        leaf, _ = _descend(idx.dim, idx.mid, idx.low, idx.high, qs,
                           depth=idx.depth)
        return _locate_in_leaf(idx.leaf_start, idx.leaf_count, idx.vectors,
                               idx.orig_row, leaf, qs, leaf_cap=idx.leaf_cap)

    btree_qps = chained_qps(identify_fn, qsigned)

    def bool_scan(qs):
        vals, pos = smallest_k(pairwise_sq_dists(qs, idx.vectors), args.k)
        return pos, vals

    bscan_qps = chained_qps(bool_scan, qsigned)
    line = {
        "d": f"bool{p}", "n": args.n, "tree_qps": round(btree_qps),
        "scan_qps": round(bscan_qps), "workload": "identify",
        "winner": "tree" if btree_qps > bscan_qps else "scan",
    }
    print(json.dumps(line), flush=True)
    summary.append(line)

    tree_wins = [s["d"] for s in summary if s["winner"] == "tree"]
    print(json.dumps({"tree_wins_at": tree_wins}), flush=True)
    return summary


if __name__ == "__main__":
    main()
