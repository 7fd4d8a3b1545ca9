#!/usr/bin/env python
"""The cost of the ``mean_id`` tie statistic's segment id sums, piece by
piece (port of ``benchmarks/probe_meanid.py``).

``tie_break="mean_id"`` needs, per level, the sum of the row ids in each
segment. The TPU program sums int32 limbs of ``bits`` bits each (5 limbs
of 7 bits at 10M rows); per limb: an extraction pass, an ``[N]`` int32
cumsum and two boundary gathers. Its five formulations, as torch code
with int32 limbs:

  full_current    extraction + cumsum + boundary gathers, per limb
  extract_cumsum  extraction + cumsum only (the grand total, no gathers)
  gathers_only    the boundary gathers from prefixes made beforehand
  blocked         per-block limb sums (B = 8), short cumsums over the
                  ``[N / B]`` block sums, boundary gathers plus the
                  in-block remainders
  stacked         the block prefixes of every limb beside the raw id
                  block in one ``[N / B + 1, B + limbs]`` table: one row
                  gather a boundary serves every limb

and two of the port's own:

  int64           the port's production rule (``ops/sorted_build.py``):
                  one int64 prefix sum of the ids and two boundary
                  gathers; no limbs
  positional      the same two boundary gathers from the count prefix,
                  without the id sums; ``int64_ms - positional_ms`` is
                  what ``mean_id`` adds over positional ties

Data as the JAX probe's: ids a numpy ``RandomState(0)`` permutation,
``s_live`` equal segments over ``[0, n)`` in ``s_max`` lanes (retired
lanes start = end = 0). Every variant's segment totals (limbs combined
in int64) must equal the int64 sums exactly (``variants_exact``;
``extract_cumsum`` its grand total, ``positional`` the counts). Each
time is chained (``_harness``): ``--reps`` calls back to back, call
``i`` on ids XOR ``i`` (gathers_only and positional: boundaries shifted
by ``i & 1``), as the JAX probe varied them; CUDA events around the run.

Usage: python -m vector_database_tpu_torch.benchmarks.probe_meanid
       [--n 10000000] [--leaf 16] [--reps 10] [--s-live 0]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vector_database_tpu_torch.benchmarks import _harness as H
from vector_database_tpu_torch.ops.sorted_build import segment_capacity

B = 8


def id_limb_plan(n_total: int) -> tuple:
    """``(bits per limb, limb count)`` of the TPU program's int32 id sums:
    the widest limb (at most 7 bits) with ``n_total * 2^bits < 2^31``."""
    bits = 7
    while bits > 1 and (n_total << bits) >= 2**31:
        bits -= 1
    if (n_total << bits) >= 2**31:
        raise ValueError("mean_id ties take at most 2^30 - 1 rows")
    return bits, -(-31 // bits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--leaf", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--s-live", type=int, default=0,
                    help="live segments (0 = all s_max lanes live)")
    H.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = H.resolve(args.device)

    n = args.n
    bits, limbs = id_limb_plan(n)
    mask = (1 << bits) - 1
    s_max = segment_capacity(n, args.leaf)
    s_live = args.s_live or s_max
    i32 = torch.int32

    print(json.dumps({"device": H.device_name(dev)}), flush=True)
    rng = np.random.RandomState(0)
    pid = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    bounds = np.linspace(0, n, s_live + 1).astype(np.int64)
    start = np.zeros(s_max, np.int64)
    ends = np.zeros(s_max, np.int64)
    start[:s_live] = bounds[:-1]
    ends[:s_live] = bounds[1:]
    start = torch.from_numpy(start).to(dev)
    ends = torch.from_numpy(ends).to(dev)

    def at(prefix, idx):
        """Exclusive prefix at ``idx`` (0 at idx == 0)."""
        v = prefix[torch.clamp(idx - 1, 0, prefix.shape[0] - 1)]
        return torch.where(idx > 0, v, torch.zeros_like(v))

    def limb(p, l):
        return (p >> (bits * l)) & mask

    def combine(per_limb):
        """Segment totals of every limb -> exact int64 id sums."""
        return sum(t.long() << (bits * l) for l, t in enumerate(per_limb))

    def cumsum32(x):
        return torch.cumsum(x, 0, dtype=i32)

    def full_current(i):
        p = pid ^ i
        return combine(
            at(lc, ends) - at(lc, start)
            for lc in (cumsum32(limb(p, l)) for l in range(limbs)))

    def extract_cumsum(i):
        p = pid ^ i
        return combine(cumsum32(limb(p, l))[-1] for l in range(limbs))

    lcs = [cumsum32(limb(pid, l)) for l in range(limbs)]

    def gathers_only(i):
        st = torch.clamp(start + (i & 1), 0, n)  # vary indices, not data
        en = torch.clamp(ends + (i & 1), 0, n)
        return combine(at(lc, en) - at(lc, st) for lc in lcs)

    nb = -(-n // B)
    col = torch.arange(B, device=dev)[None, :]

    def blocks(i):
        return torch.nn.functional.pad(pid ^ i, (0, nb * B - n)).view(nb, B)

    def blocked(i):
        pb = blocks(i)
        bi_s, ri_s = start // B, start % B
        bi_e, ri_e = ends // B, ends % B
        rows_s = pb[torch.clamp(bi_s, 0, nb - 1)]
        rows_e = pb[torch.clamp(bi_e, 0, nb - 1)]
        m_s, m_e = col < ri_s[:, None], col < ri_e[:, None]
        out = []
        for l in range(limbs):
            bp = torch.cumsum(limb(pb, l).sum(dim=1, dtype=i32), 0,
                              dtype=i32)
            intra_s = torch.where(m_s, limb(rows_s, l), 0).sum(1, dtype=i32)
            intra_e = torch.where(m_e, limb(rows_e, l), 0).sum(1, dtype=i32)
            out.append((at(bp, bi_e) + intra_e) - (at(bp, bi_s) + intra_s))
        return combine(out)

    def stacked(i):
        pb = blocks(i)
        cols = [torch.cumsum(limb(pb, l).sum(dim=1, dtype=i32), 0, dtype=i32)
                for l in range(limbs)]
        # [nb + 1, B + limbs], row 0 zeros: row r holds block r - 1 and
        # the sums of the blocks before r (its inclusive prefix)
        table = torch.nn.functional.pad(
            torch.cat([pb, torch.stack(cols, dim=1)], dim=1), (0, 0, 1, 0))

        def pref(idx):
            bi, ri = idx // B, idx % B
            rows = table[bi + (ri > 0).long()]
            raw = torch.where(col < ri[:, None], rows[:, :B], 0)
            ex = table[bi, B:]
            return [ex[:, l] + limb(raw, l).sum(1, dtype=i32)
                    for l in range(limbs)]

        st, en = pref(start), pref(ends)
        return combine(e - s for s, e in zip(st, en))

    def int64(i):
        ic = torch.cumsum((pid ^ i).long(), 0)
        return at(ic, ends) - at(ic, start)

    cnt = torch.arange(1, n + 1, device=dev)

    def positional(i):
        st = torch.clamp(start + (i & 1), 0, n)
        en = torch.clamp(ends + (i & 1), 0, n)
        return at(cnt, en) - at(cnt, st)

    # correctness: every variant's segment totals are the int64 sums
    want = int64(0)
    checks = {
        "full_current": (full_current(0), want),
        "gathers_only": (gathers_only(0), want),
        "blocked": (blocked(0), want),
        "stacked": (stacked(0), want),
        "extract_cumsum": (extract_cumsum(0), pid.long().sum()),
        "positional": (positional(0), ends - start),
    }
    for name, (got, exp) in checks.items():
        if not torch.equal(got, exp):
            raise AssertionError(f"probe_meanid: {name} != the int64 sums")

    out = {"n": n, "bits": bits, "limbs": limbs, "s_max": s_max,
           "s_live": s_live, "B": B}
    reps = list(range(args.reps))
    for name, fn in (("full_current", full_current),
                     ("extract_cumsum", extract_cumsum),
                     ("gathers_only", gathers_only), ("blocked", blocked),
                     ("stacked", stacked), ("int64", int64),
                     ("positional", positional)):
        out[f"{name}_ms"] = H.chained_s(fn, reps, dev) * 1e3
    out["variants_exact"] = True
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
