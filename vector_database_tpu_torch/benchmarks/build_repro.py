"""Why the fused build once gave a different tree from run to run on the
card, and what the fixed-order prefix sum costs.

    python -m vector_database_tpu_torch.benchmarks.build_repro

Run from the root of a checkout (it takes ``chip_smoke.py``'s recipe:
10M x 96 clustered rows from its seed). Three parts, one JSON line:

- ``cumsum``: each float prefix sum of the build at its size (the split
  column, ``[N]``; a moment row block, ``[96, N / 4]`` along the last
  dimension), ``REPS`` times on one input: how many elements differ from
  the first call's bits, and the median time (CUDA events), for
  ``torch.cumsum`` and for ``sorted_build.prefix_sum``;
- ``build``: two fused builds of one input with ``prefix_sum`` replaced
  by ``torch.cumsum`` along the last dimension (the build before the
  fixed-order scan) and two with it as it is: leaf counts, whether the
  node tables are equal field by field, and the build's time.

Prints the card and the JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from vector_database_tpu_torch.ops import sorted_build

REPS = 5


def _times_and_diffs(fn, x):
    first = fn(x)
    diffs, times = [], []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        y = fn(x)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        diffs.append(int((y.view(torch.int32) != first.view(torch.int32))
                         .sum()))
    return dict(ms=statistics.median(times), differing=diffs)


def _builds(train, scan):
    import chip_smoke as cs
    from vector_database_tpu_torch import build_index_fused

    sorted_build.prefix_sum = scan
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_index_fused(train, leaf_size=cs.LEAF)
        torch.cuda.synchronize()
        out.append((index, time.perf_counter() - t0))
    (a, ta), (b, tb) = out
    return dict(leaves=[a.num_leaves, b.num_leaves], seconds=[ta, tb],
                equal_tables=cs._same_tree(a, b))


def main():
    if not torch.cuda.is_available():
        sys.exit("build_repro: no CUDA device")
    import chip_smoke as cs  # the checkout's root is the working directory

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    dev = torch.device("cuda")
    train, _, _, _ = cs._clustered(dev, cs.N, cs.SEED)
    fixed = sorted_build.prefix_sum

    def cub(x):
        return torch.cumsum(x, dim=-1)

    col = train[:, 0].contiguous()
    rows = train[::4].T.contiguous()  # [96, N / 4], the stats subsample
    result = {"cumsum": {
        "split_column_N": dict(torch_cumsum=_times_and_diffs(cub, col),
                               prefix_sum=_times_and_diffs(fixed, col)),
        "moments_96xN4": dict(torch_cumsum=_times_and_diffs(cub, rows),
                              prefix_sum=_times_and_diffs(fixed, rows)),
    }}
    del col, rows
    try:
        result["build"] = dict(torch_cumsum=_builds(train, cub),
                               prefix_sum=_builds(train, fixed))
    finally:
        sorted_build.prefix_sum = fixed
    print(json.dumps(result))


if __name__ == "__main__":
    main()
