#!/usr/bin/env python
"""Inverting the build's per-level permutation, three ways (port of
``benchmarks/probe_perm.py``).

A level's partition computes ``dest[p]`` (where the row at position
``p`` moves); gathering the permuted arrays needs ``src = dest^-1``
(``src[i]``: which row lands at ``i``). The port's build
(``ops/sorted_build.py``) no longer inverts: it scatters its row index
and segment ids by ``dest``. Three torch forms of the JAX probe's
candidates, each timed alone:

  scatter_ms       ``src[dest] = pos``: one scatter with unique
                   indices, where the TPU program sorted
  sort_key_val_ms  ``torch.sort(dest, stable=True).indices``: the sort
                   of ``(dest, pos)`` pairs, JAX's ``lax.sort_key_val``
  argsort_ms       ``torch.argsort(dest)``

``dest`` is the JAX probe's: a numpy ``RandomState(0)`` draw of a stable
two-way partition within each segment of 2^14 rows, in int64 like the
build's positions. The three must give the same ``src`` (asserted).
Each time is chained (``_harness``): 20 calls back to back, each on
``dest`` rotated by one more position (still a permutation), CUDA events
around the run.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_perm
       [N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H

REPS = 20
SEG = 1 << 14


def partition_dest(n: int) -> np.ndarray:
    """The JAX probe's ``dest``: within each segment of ``SEG`` rows, a
    random half (``rand < 0.5``) moves to the front in order, the rest
    after it in order."""
    rng = np.random.RandomState(0)
    dest = np.arange(n, dtype=np.int64)
    for s in range(0, n, SEG):
        e = min(s + SEG, n)
        low = rng.rand(e - s) < 0.5
        nlow = int(low.sum())
        dest[s:e][low] = s + np.arange(nlow)
        dest[s:e][~low] = s + nlow + np.arange(e - s - nlow)
    return dest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=10_000_000)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)
    n = args.n

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    dest = torch.from_numpy(partition_dest(n)).to(dev)
    pos = torch.arange(n, device=dev)

    def scatter(d):
        src = torch.empty_like(pos)
        src[d] = pos
        return src

    forms = {
        "scatter": scatter,
        "sort_key_val": lambda d: torch.sort(d, stable=True).indices,
        "argsort": lambda d: torch.argsort(d),
    }
    inputs = H.rolled(dest, REPS)
    for d in (inputs[0], inputs[1]):
        want = scatter(d)
        for name, fn in forms.items():
            if not torch.equal(fn(d), want):
                raise AssertionError(f"probe_perm: {name} != scatter")
    line = {"n": n}
    for name, fn in forms.items():
        line[f"{name}_ms"] = H.chained_s(fn, inputs, dev) * 1e3
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
