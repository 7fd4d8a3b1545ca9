#!/usr/bin/env python
"""Peak device memory of the fused build, single-device and sharded
(port of ``benchmarks/probe_sharded_mem.py``).

The JAX probe compiled each build ahead of time and printed XLA's memory
analysis, without data. Torch has no such analysis, so this probe builds
and measures: for each variant, ``torch.cuda.reset_peak_memory_stats``,
the build over the bench recipe's rows (made on the device from a seed),
then ``torch.cuda.max_memory_allocated`` minus the bytes held before the
build (the rows included): the build's own peak, transients and output.

  single_donate   ``build_index_fused``
  sharded_donate  ``build_index_sharded`` on ``make_mesh()`` (on one card
                  a world of one rank, which this probe starts over NCCL
                  and destroys at the end when no process group exists)

The names keep the JAX probe's; the port's builds cannot take over the
caller's rows (``donate=`` does nothing). Per variant a text line as the
JAX probe's, ``args`` the rows' bytes and ``out`` the returned index's,
then a JSON line with ``args_gib``, ``out_gib`` and ``peak_gib``. The
two variants must return equal node tables, bit for bit (asserted when
both run). On ``--device cpu`` there are no allocator statistics: both
builds still run and are compared, and ``peak_gib`` is null, with the
reason.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_sharded_mem
       [--n 10000000] [--d 96] [--leaf 16] [--subsample 4]
       [--variants single,sharded] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from vector_database_tpu_torch.benchmarks import _harness as H

GIB = 1 << 30
TABLE = ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
         "orig_row", "vectors")


def _bytes(index) -> int:
    return sum(getattr(index, f).nbytes for f in TABLE)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--subsample", type=int, default=4,
                    help="stats_subsample (the build's own policy picks 4 "
                    "above 500k rows)")
    ap.add_argument("--variants", type=str, default="single,sharded")
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    import torch.distributed as dist

    from vector_database_tpu_torch import build_index_fused
    from vector_database_tpu_torch.parallel import (
        build_index_sharded,
        make_mesh,
    )

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    train, _ = H.clustered(args.n, args.d, 1, 0, dev)
    kw = dict(leaf_size=args.leaf, stats_subsample=args.subsample)
    builds = {
        "single": lambda: build_index_fused(train, **kw),
        "sharded": lambda: build_index_sharded(train, mesh, **kw),
    }
    variants = args.variants.split(",")
    unknown = set(variants) - set(builds)
    if unknown:
        raise ValueError(f"unknown variants: {sorted(unknown)}")
    started = "sharded" in variants and not dist.is_initialized()
    mesh = make_mesh(device_type=dev.type) if "sharded" in variants else None
    lines, built = [], {}
    try:
        for name in variants:
            H.sync(dev)
            if dev.type == "cuda":
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            built[name] = builds[name]()
            H.sync(dev)
            line = {"variant": f"{name}_donate",
                    "args_gib": train.nbytes / GIB,
                    "out_gib": _bytes(built[name]) / GIB}
            if dev.type == "cuda":
                peak = torch.cuda.max_memory_allocated(dev) - before
                line["peak_gib"] = peak / GIB
                shown = f"{line['peak_gib']:.2f}G"
            else:
                line["peak_gib"] = None
                line["peak_note"] = ("no allocator statistics on the "
                                     "cpu device")
                shown = "null (no allocator statistics on cpu)"
            print(f"{line['variant']}: args={line['args_gib']:.2f}G "
                  f"out={line['out_gib']:.2f}G peak~={shown}", flush=True)
            print(json.dumps(line), flush=True)
            lines.append(line)
        if len(built) == 2:
            for f in TABLE:
                if not torch.equal(_bits(getattr(built["single"], f)),
                                   _bits(getattr(built["sharded"], f))):
                    raise AssertionError(
                        f"probe_sharded_mem: single and sharded {f} differ")
    finally:
        if started:
            dist.destroy_process_group()
    return lines


if __name__ == "__main__":
    main()
