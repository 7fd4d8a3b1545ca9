#!/usr/bin/env python
"""Generate ann-benchmarks-shaped synthetic HDF5 files (the port's own
copy of ``benchmarks/make_hdf5.py``: numpy and ``h5py``, the same arrays
for the same arguments).

The reference's headline benchmark ingests deep-image-96-angular
(ann-benchmarks HDF5: float32 ``/train`` + ``/test``, 96-d, unit rows);
SIFT1M (1M x 128, L2) and GloVe-100-angular (~1.18M x 100) are also
named. This writes structurally identical stand-ins: clustered vectors
with each dataset's dimensionality, scaling and normalization. Drive the
pipeline with e.g.:

    python -m vector_database_tpu_torch.benchmarks.make_hdf5 \\
        --style sift build/sift-shaped.hdf5
    VDB_DATA=build/sift-shaped.hdf5 python -m \\
        vector_database_tpu_torch.benchmarks.recall_qps --n 1000000 \\
        --q 4096 --probes 24,48

Styles:
  deep  (default) -- 96-d, unit rows (angular), like deep-image-96-angular
  glove           -- 100-d, unit rows (angular), like glove-100-angular
  sift            -- 128-d, non-negative integer-valued f32 rows, L2
                     metric, magnitudes like SIFT descriptors (0..~160)

The default output is ``build/<style>-shaped.hdf5`` under the working
directory (the JAX harness writes outside the checkout). ``--device`` only
names where the data will be served; the file is made on the host.

Usage: python -m vector_database_tpu_torch.benchmarks.make_hdf5
       [out.hdf5] [--style deep|glove|sift] [--n 1000000] [--q 10000]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from vector_database_tpu_torch.benchmarks import _harness as H

STYLES = {
    # d, normalize rows to unit length (angular), SIFT-like int scaling
    "deep": (96, True, False),
    "glove": (100, True, False),
    "sift": (128, False, True),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--style", choices=sorted(STYLES), default="deep")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=None)
    ap.add_argument("--q", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    H.resolve(args.device)

    h5py = H.h5py()

    d_style, angular, siftish = STYLES[args.style]
    d = args.d if args.d is not None else d_style
    out = args.out or os.path.join("build", f"{args.style}-shaped.hdf5")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    rng = np.random.RandomState(args.seed)
    c = max(64, args.n // 1000)
    centers = rng.rand(c, d).astype(np.float32) * 2 - 1

    def rows(num, key):
        r = np.random.RandomState(key)
        v = centers[r.randint(0, c, size=num)] + 0.05 * r.randn(
            num, d
        ).astype(np.float32)
        if angular:
            # unit rows, like the real deep-image/glove angular files
            return (v / np.maximum(
                np.linalg.norm(v, axis=1, keepdims=True), 1e-30
            )).astype(np.float32)
        if siftish:
            # SIFT descriptors: non-negative integers ~0..160 stored as
            # float32, so bf16 rounding meets the real dynamic range
            return np.clip(
                np.rint((v + 1.0) * 80.0), 0, 255
            ).astype(np.float32)
        return v.astype(np.float32)

    with h5py.File(out, "w") as f:
        # chunked storage like the ann-benchmarks files, written in
        # 100k-row blocks so the generator stays O(block) in RAM
        tr = f.create_dataset(
            "train", (args.n, d), dtype="f4",
            chunks=(min(100_000, args.n), d),
        )
        for s in range(0, args.n, 100_000):
            e = min(s + 100_000, args.n)
            tr[s:e] = rows(e - s, args.seed + 1 + s)
        f.create_dataset("test", data=rows(args.q, args.seed + 7), dtype="f4")
    print(
        f"wrote {out}: style={args.style} "
        f"train=({args.n},{d}) test=({args.q},{d})"
    )
    return out


if __name__ == "__main__":
    main()
