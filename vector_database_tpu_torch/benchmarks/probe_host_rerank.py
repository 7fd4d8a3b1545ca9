"""Microbenchmark of the out-of-core host rerank, the floor of the pinned
capacity mode (port of ``benchmarks/probe_host_rerank.py``). Pure host
numpy; run with nothing else on the host's cores.

Variants of the ``[Q, C]`` distance keys of a ``[Q, C]`` candidate list:
  diff      -- cand - qh materialized, einsum square
  inplace   -- cand -= qh in place (no second [Q, C, D] allocation)
  dot32     -- |c|^2 - 2 q.c + |q|^2 in f32 (faster, not exact: ~1e-4
               absolute error at O(1) data, which breaks the exact-rerank
               contract; measured for the record)
  dot64     -- the same with f64 accumulation (exact enough, but the
               upcast costs)
and the production rerank itself, ``host_rerank``:
``ChunkedIndex._host_rerank`` (the in-place form plus the masking and the
stable top-k at k = 10), whose distances must equal the 10 smallest
``diff`` keys of each row bit for bit.

``--device`` names the machine the host belongs to (the card's line is
printed first); nothing here runs on the card.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_host_rerank
       [--q 4096] [--c 80] [--d 96] [--n 500000] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from vector_database_tpu_torch.benchmarks import _harness as H

K = 10  # the production rerank keeps the serving k


def variants(vec, qh, safe):
    """The four key functions on one input: ``{name: fn() -> [Q, C]}``."""
    n2 = np.einsum("nd,nd->n", vec, vec)
    q2 = np.einsum("qd,qd->q", qh, qh)

    def diff():
        cand = vec[safe]
        d = cand - qh[:, None, :]
        return np.einsum("qcd,qcd->qc", d, d)

    def inplace():
        cand = vec[safe]
        cand -= qh[:, None, :]
        return np.einsum("qcd,qcd->qc", cand, cand)

    def dot32():
        cand = vec[safe]
        return (
            n2[safe] - 2.0 * np.einsum("qcd,qd->qc", cand, qh)
            + q2[:, None]
        )

    def dot64():
        cand = vec[safe]
        return (
            n2[safe].astype(np.float64)
            - 2.0 * np.einsum("qcd,qd->qc", cand, qh, dtype=np.float64)
            + q2[:, None]
        ).astype(np.float32)

    return {"diff": diff, "inplace": inplace, "dot32": dot32,
            "dot64": dot64}


def production(vec, qh, safe, k):
    """``() -> (rows, d2)``: ``ChunkedIndex._host_rerank`` over ``vec`` as
    one chunk, on the candidate list ``safe``."""
    from vector_database_tpu_torch.out_of_core import ChunkedIndex

    index = ChunkedIndex(device="cpu")
    chunk = {"cap": vec.shape[0], "vectors": vec}
    return lambda: index._host_rerank(chunk, safe, qh, k)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--q", type=int, default=4096)
    ap.add_argument("--c", type=int, default=80)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--reps", type=int, default=5)
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)
    print(json.dumps({"device": H.device_name(dev)}), flush=True)

    rng = np.random.RandomState(3)
    vec = rng.randn(args.n, args.d).astype(np.float32)
    qh = rng.randn(args.q, args.d).astype(np.float32)
    safe = rng.randint(0, args.n, size=(args.q, args.c))

    fns = variants(vec, qh, safe)
    ref = fns["diff"]()
    ref_k = np.sort(ref, axis=1)[:, :K]
    fns["host_rerank"] = production(vec, qh, safe, K)
    out = {}
    for name, fn in fns.items():
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            key = fn()
        ms = (time.perf_counter() - t0) / args.reps * 1e3
        err = np.abs((key[1] if name == "host_rerank" else key)
                     - (ref_k if name == "host_rerank" else ref)).max()
        out[name] = {"ms_per_chunk": round(ms, 1),
                     "max_abs_err_vs_diff": round(float(err), 8)}
        print(json.dumps({name: out[name]}), flush=True)
    # the gather alone (a floor shared by every variant)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        vec[safe]
    out["gather_only_ms"] = round((time.perf_counter() - t0)
                                  / args.reps * 1e3, 1)
    print(json.dumps({"gather_only_ms": out["gather_only_ms"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
