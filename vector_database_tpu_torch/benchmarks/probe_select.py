#!/usr/bin/env python
"""Pruned-scan selection policies, ranked by coverage@probes (port of
``benchmarks/probe_select.py``).

Recall through the pruned kernel is bounded by block coverage: a true
neighbour can be found only if its leaf-major block is in its query's
tile list. The kernel scores chosen blocks exactly, so ranking selection
policies by coverage@probes ranks them by achievable recall, without
running the kernel.

Policies over the per-query key matrix ``key[Q, nb]`` (best-cell
centroid distance, as ``ops/packed_knn._block_map`` computes it):
  min      -- tile key = min over tile queries (production's base)
  min+f1   -- min + force every query's top-1 block  (PRODUCTION)
  min+f2   -- min + force every query's top-2 blocks
  min+f3   -- min + force every query's top-3 blocks
  rank     -- tile key = sum of per-query ranks (Borda count)
  rank+f1  -- Borda + forced top-1
  mean     -- tile key = mean key over tile queries

The coverage is device-independent math: the build, the pack and the
oracle run on ``--device`` (default the card), the key matrix in full
f32 there, and the policies in numpy. Prints a text table, as the JAX
harness does.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_select
       [--n 1000000] [--q 4096] [--probes 8,16,24,32,48,64]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--q-tile", type=int, default=512)
    ap.add_argument("--probes", type=str, default="8,16,24,32,48,64")
    ap.add_argument(
        "--cell", type=int, default=0,
        help="override summary-cell rows (0 = the pack's block/32)",
    )
    ap.add_argument(
        "--group", type=str, default="top1",
        choices=("none", "top1", "top12", "kmeans"),
        help="query->tile grouping policy (production: top1 sort)",
    )
    ap.add_argument(
        "--sel-bf16", action="store_true",
        help="round the selection dot's inputs to bf16 (f32 accumulate), "
        "as production's _block_map does, instead of full f32",
    )
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch import (
        build_index_fused,
        exact_knn,
        pack_database,
    )
    from vector_database_tpu_torch.benchmarks.recall_qps import load_data
    from vector_database_tpu_torch.ops.exact import full_f32

    t0 = time.perf_counter()
    train, test, name = load_data(args.n, args.d, args.q, device=dev)
    test = torch.as_tensor(test, dtype=torch.float32, device=dev)
    index = build_index_fused(torch.as_tensor(train, device=dev),
                              leaf_size=16)
    del train
    pack = pack_database(index.vectors)
    nb = pack.vb.shape[0]
    block = pack.block
    print(f"# {name} nb={nb} block={block} on {H.device_name(dev)} "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)

    # truth in sorted-position space -> owning block ids
    truth, _ = exact_knn(index.vectors, test, k=args.k)
    tblock = truth.cpu().numpy() // block  # [Q, k]

    # per-query selection key: the math of _block_map
    if args.cell:
        # finer or coarser summaries than the pack's block/32, straight
        # from the sorted vectors (the radius only marks empty cells)
        v = index.vectors.cpu().numpy()
        n_pad = nb * block
        vp = np.zeros((n_pad, args.d), np.float32)
        vp[: v.shape[0]] = v
        real = np.zeros(n_pad, bool)
        real[: v.shape[0]] = True
        c = args.cell
        cnt = real.reshape(-1, c).sum(1)
        cent = torch.as_tensor(
            (vp.reshape(-1, c, args.d).sum(1)
             / np.maximum(cnt, 1)[:, None]).astype(np.float32), device=dev)
        rad = torch.as_tensor(
            np.where(cnt > 0, 0.0, -3.0e38).astype(np.float32), device=dev)
    else:
        cent, rad = pack.cent, pack.rad
    cpb = cent.shape[0] // nb
    qsel, csel = test, cent
    if args.sel_bf16:
        qsel = qsel.bfloat16().float()
        csel = csel.bfloat16().float()
    with full_f32():
        dots = qsel @ csel.T
    cc = torch.sum(cent * cent, dim=1)
    key = cc[None, :] - 2.0 * dots
    key = torch.where(rad[None, :] < -1e38, float("inf"), key)
    nq = test.shape[0]
    key = key.view(nq, nb, cpb).amin(dim=2).cpu().numpy()  # [Q, nb]

    top1 = key.argmin(axis=1)
    if args.group == "none":
        order = np.arange(nq)
    elif args.group == "top1":
        order = np.argsort(top1, kind="stable")
    elif args.group == "top12":
        t12 = np.argsort(key, axis=1)[:, :2]
        order = np.lexsort((t12[:, 1], t12[:, 0]))
    else:  # kmeans
        # tiles as key-space clusters: sort by top1, then one refinement
        # pass moving queries toward the tile whose mean key vector is
        # closest (L2 on keys)
        order = np.argsort(top1, kind="stable")
        q_t = args.q_tile
        pads = ((nq + q_t - 1) // q_t) * q_t
        ks = np.full((pads, nb), 0, np.float32)
        ks[:nq] = key[order]
        cent_t = ks.reshape(-1, q_t, nb).mean(axis=1)  # [tiles, nb]
        d2t = ((key[:, None, :] - cent_t[None]) ** 2).sum(-1)  # [q, t]
        order = np.argsort(d2t.argmin(axis=1), kind="stable")
    q_tile = args.q_tile
    q_pad = ((nq + q_tile - 1) // q_tile) * q_tile
    tiles = q_pad // q_tile
    key_s = np.full((q_pad, nb), np.inf, np.float32)
    key_s[:nq] = key[order]
    # per-query rank of each block (0 = best); inf keys rank last anyway
    ranks = np.argsort(np.argsort(key_s, axis=1), axis=1).astype(np.float32)
    tkey = key_s.reshape(tiles, q_tile, nb)
    trank = ranks.reshape(tiles, q_tile, nb)

    def forced(j):
        """[tiles, nb] bool: blocks that are some tile member's top-j."""
        topj = np.argsort(key_s, axis=1)[:, :j]  # [q_pad, j]
        f = np.zeros((q_pad, nb), bool)
        np.put_along_axis(f, topj, True, axis=1)
        f[nq:] = False
        return f.reshape(tiles, q_tile, nb).any(axis=1)

    mean = np.where(np.isinf(tkey), 0, tkey).sum(axis=1)
    pol = {
        "min": (tkey.min(axis=1), None),
        "min+f1": (tkey.min(axis=1), forced(1)),
        "min+f2": (tkey.min(axis=1), forced(2)),
        "min+f3": (tkey.min(axis=1), forced(3)),
        "rank": (trank.sum(axis=1), None),
        "rank+f1": (trank.sum(axis=1), forced(1)),
        "mean": (mean, None),
        "mean+f1": (mean, forced(1)),
    }

    tile_of = np.empty(nq, np.int64)
    tile_of[order] = np.arange(nq) // q_tile  # query -> its tile

    probes_list = [int(x) for x in args.probes.split(",")]
    print("policy      " + "".join(f"  P={p:<5d}" for p in probes_list),
          flush=True)
    table = {}
    for nm, (tk, f) in pol.items():
        tk = tk.copy()
        if f is not None:
            tk[f] = -np.inf
        bsort = np.argsort(tk, axis=1)  # [tiles, nb] best first
        line = f"{nm:<12s}"
        table[nm] = []
        for p in probes_list:
            sel = np.zeros((tiles, nb), bool)
            np.put_along_axis(sel, bsort[:, :p], True, axis=1)
            cov = sel[tile_of[:, None], tblock].mean()
            table[nm].append(float(cov))
            line += f"  {cov:.4f}"
        print(line, flush=True)
    return table


if __name__ == "__main__":
    main()
