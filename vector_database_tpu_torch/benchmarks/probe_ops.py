"""The build level's ``[N]``-wide primitives, each timed alone (port of
``benchmarks/probe_ops.py``).

The JAX probe's primitives in their torch form: the per-row column
gather (``gather``), the one-hot mask-reduce alternative, the per-row
segment-table lookup (``index_select``), the ``[N, D]`` row permutation,
the ``[N]`` cumsums, an elementwise ``[N, D]`` pass and the ``[N]``
scatter. Then what the host-loop build's level (``ops/level.level_math``)
runs over all N rows: the stable sort of the rows by segment, the
``[N, D]`` gather into that order, the float64
``sorted_build.prefix_sum`` of one 32-column chunk (a level runs six:
sums and sums of squares of three chunks at D = 96), and the whole
``level_math`` call at S segments, for the sum of its parts.

Each line is ``reps`` = 10 calls back to back (inputs varied by the
call's index where the JAX probe varied them), CUDA events around the
run (``_harness``): ``{"op": name, "ms": per call}``.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_ops
       [N] [D] [S] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from vector_database_tpu_torch.benchmarks import _harness as H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=10_000_000)
    ap.add_argument("d", nargs="?", type=int, default=96)
    ap.add_argument("s", nargs="?", type=int, default=625_000)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)
    n, d, s = args.n, args.d, args.s
    reps = list(range(10))

    from vector_database_tpu_torch.ops.level import level_math
    from vector_database_tpu_torch.ops.sorted_build import prefix_sum

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=g, device=dev)
    pvec = torch.rand((n, d), **kw)
    p_dim = torch.randint(0, d, (n,), **kw)
    ps = torch.randint(0, s, (n,), **kw)
    src = torch.randperm(n, **kw)
    pack_a = torch.rand((s, 5), **kw)
    vec1 = torch.rand((n,), **kw)
    cols = torch.arange(d, device=dev)
    lines = []

    def timed(name, fn):
        line = {"op": name, "ms": round(H.chained_s(fn, reps, dev) * 1e3, 1)}
        print(json.dumps(line), flush=True)
        lines.append(line)

    # per-row value on the segment's split dim
    timed("gather[pvec,p_dim] (N scalar col-gathers)",
          lambda i: pvec.gather(1, ((p_dim + i) % d)[:, None])[:, 0])
    # the same value via a one-hot mask-reduce (streaming alternative)
    timed("onehot mask-reduce value",
          lambda i: torch.sum(
              pvec * (((p_dim + i) % d)[:, None] == cols[None, :]), dim=1))
    # per-row segment-table lookup
    timed("index_select(packA[S,5], ps) (N row-gathers from table)",
          lambda i: pack_a.index_select(0, (ps + i) % s))
    # whole-matrix row permutation (the partition move)
    timed("pvec[src] ([N,D] row permutation)",
          lambda i: pvec[(src + i) % n])
    timed("cumsum[N] f32", lambda i: torch.cumsum(vec1 + i, dim=0))
    timed("cumsum[N] i32",
          lambda i: torch.cumsum((vec1 + i).to(torch.int32), dim=0))
    timed("elementwise [N,D] mul", lambda i: pvec * (i + 1.5))
    timed("scatter zeros[N][dest] = 1",
          lambda i: torch.zeros(n, dtype=torch.int32, device=dev)
          .index_fill_(0, (src + i) % n, 1))

    # the host-loop level's own passes over all N rows
    timed("argsort[N] stable by segment (level order)",
          lambda i: torch.argsort((ps + i) % s, stable=True))
    order = torch.argsort(ps, stable=True)
    timed("pvec[order] ([N,D] gather in segment order)",
          lambda i: pvec[order])
    chunk = pvec[:, :32].T.double().contiguous()
    timed("prefix_sum [32,N] f64 (sorted_build.prefix_sum, one chunk)",
          lambda i: prefix_sum(chunk))
    chunk = None
    row_ids = torch.arange(n, device=dev)
    retired = torch.full((n,), -1, dtype=torch.int32, device=dev)
    seg = ps.to(torch.int32)
    timed(f"level_math (one level, S={s} segments)",
          lambda i: level_math(pvec, row_ids, seg, retired, bool(i % 2), 0,
                               num_segments=s, leaf_size=16))
    return lines


if __name__ == "__main__":
    main()
