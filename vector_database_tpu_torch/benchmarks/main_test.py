#!/usr/bin/env python
"""Console benchmark harness: the reference MainTest (port of
``benchmarks/main_test.py``).

Mirrors VectorIndex.MainTest/Program.cs:

1. a 10k x 1536 uniform random build, timed (Program.cs:9-31);
2. the crafted 1536 one-hot adversarial set, where every dimension has
   identical statistics (Program.cs:34-67);
3. an ann-benchmarks HDF5 dataset (needs ``h5py``): chunked ingest of
   /train, fused build (leaf 16), and optionally the CSV export of the
   finished index as ``RangeID,Dimension,Mid,ID`` rows in the reference's
   heap numbering (``BSPIndex.heap_rows``; Program.cs:70-156), the same
   bytes as the JAX harness's export for the same tree.

Build times are host-clock seconds ending in a synchronise.

Usage: python -m vector_database_tpu_torch.benchmarks.main_test
       [hdf5_file] [index_csv_out] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def timed_build(name, vectors, dev, leaf_size=1, export=None):
    from vector_database_tpu_torch import build_index_fused

    t0 = time.perf_counter()
    index = build_index_fused(
        torch.as_tensor(np.asarray(vectors, np.float32), device=dev),
        leaf_size=leaf_size)
    H.sync(dev)
    dt = time.perf_counter() - t0
    print(f"{name}: build {dt:.2f}s, nodes {index.num_nodes}, "
          f"depth {index.depth}, leaves {index.num_leaves}", flush=True)
    if export:
        t0 = time.perf_counter()
        with open(export, "w") as f:
            f.write("RangeID,Dimension,Mid,ID\n")
            count = 0
            for heap, dim, mid, vid in index.heap_rows():
                f.write(f"{heap},{dim},{mid},{vid}\n")
                count += 1
                if count % 100000 == 0:
                    print(f"Processed {count} records.")
        print(f"{name}: exported {count} rows to {export} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return index


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("hdf5", nargs="?", default=None)
    ap.add_argument("export", nargs="?", default=None)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    from vector_database_tpu_torch.utils import datasets

    print(f"device: {H.device_name(dev)}", flush=True)
    # 1. random 10k x 1536 (Program.cs:9-31)
    timed_build(
        "random 10k x 1536",
        datasets.random_uniform(10_000, 1536, seed=int(time.time()) % 997),
        dev,
    )

    # 2. crafted one-hot 1536 (Program.cs:34-67)
    timed_build("crafted one-hot 1536", datasets.one_hot_crafted(1536), dev)

    # 3. HDF5 dataset (Program.cs:70-156)
    if args.hdf5:
        H.h5py()
        rows, dims = datasets.hdf5_size(args.hdf5, "/train")
        print(f"{args.hdf5}: /train {rows} x {dims}")
        parts = [c for _, c in datasets.load_hdf5(args.hdf5, "/train")]
        timed_build(f"hdf5 {rows} x {dims}", np.concatenate(parts), dev,
                    leaf_size=16, export=args.export)


if __name__ == "__main__":
    main()
