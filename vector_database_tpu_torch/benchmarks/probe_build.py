"""Build-time bisection: time ``build_index_fused`` under different knobs
(``stats_subsample``, ``leaf_size``, d, ``max_levels``, ``tie_break``) to
see where the per-level cost sits (port of ``benchmarks/probe_build.py``).
One JSON line per variant: the best of two builds on fresh uniform rows,
after one warm build, host clock ending in a synchronise.

The variant list is a Python literal (``ast.literal_eval``) of dicts with
the keys ``leaf``, ``ss``, ``d``, ``max_levels`` and ``tie``. The JAX
build's ``donate=True`` has no counterpart: the build keeps no reference
to its input, which is dropped after each build.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_build
       [N] ['[{"leaf": 16, "ss": 4}, ...]'] [--device cuda]
"""

from __future__ import annotations

import argparse
import ast
import json

import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=10_000_000)
    ap.add_argument("variants", nargs="?", type=ast.literal_eval,
                    default=[{"leaf": 16, "ss": 4}])
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)
    n = args.n

    from vector_database_tpu_torch import build_index_fused

    print(json.dumps({"device": H.device_name(dev)}), flush=True)

    def make(seed, d):
        g = torch.Generator(device=dev).manual_seed(seed)
        v = torch.rand((n, d), generator=g, device=dev) * 2.0 - 1.0
        H.sync(dev)
        return v

    lines = []
    for var in args.variants:
        d = var.get("d", 96)
        leaf = var.get("leaf", 16)
        ss = var.get("ss", None)
        kw = dict(leaf_size=leaf)
        if ss is not None:
            kw["stats_subsample"] = ss
        if "max_levels" in var:
            kw["max_levels"] = var["max_levels"]
        if "tie" in var:
            kw["tie_break"] = var["tie"]
        depth = build_index_fused(make(0, d), **kw).depth  # warm
        H.free(dev)
        dt = float("inf")
        for seed in (1, 2):
            vecs = make(seed, d)
            dt = min(dt, H.host_s(lambda: build_index_fused(vecs, **kw),
                                  dev))
            vecs = None
            H.free(dev)
        line = {
            "n": n, "d": d, "leaf": leaf, "ss": ss,
            "tie": var.get("tie", "positional"),
            "max_levels": var.get("max_levels"), "depth": depth,
            "build_s": round(dt, 2),
            "vectors_per_s": round(n / dt),
            "s_per_level": round(dt / max(depth, 1), 3),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
