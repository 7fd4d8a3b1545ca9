"""Time the scan kernels alone on the card, on random data at the main
path's shapes: a quick check of a kernel change, between full
``chip_smoke.py`` runs.

    python -m vector_database_tpu_torch.benchmarks.kernel_times

- ``bucket_scan`` over 1221 random int8 blocks of [128, 8192] (the
  int8f route) and over the same blocks widened to bf16, with 4096 bf16
  queries and m 4096, timed in turns (int8f, bf16, int8f, bf16): the
  full scan, then the scan pruned to 256 random blocks per group of 512
  queries; the two full outputs must be equal bit for bit;
- ``bucket_scan_i8`` over the same int8 values laid K-major ([8192,
  128] a block), int32 norms and 4096 int8 queries, full, in turns with
  the int8f full scan (i8, int8f, i8, int8f);
- the A/B probe's four modes at 10M rows (its own inputs) with 1024 and
  with 4096 queries.

CUDA events, median of 5 calls after a warm one. Prints the card and one
JSON line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from vector_database_tpu_torch.benchmarks import probe_kernel_ab as pab
from vector_database_tpu_torch.ops import bucket_scan as bs
from vector_database_tpu_torch.ops import bucket_scan_i8 as bi

REPS = 5
NB, D_PAD, BLOCK, M, Q, BITS = 1221, 128, 8192, 4096, 4096, 11
PROBES, Q_TILE = 256, 512


def _ms(fn):
    fn()
    times = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(generator=g, device="cuda")
    vb8 = torch.randint(-127, 128, (NB, D_PAD, BLOCK), dtype=torch.int8, **kw)
    vn = torch.rand((NB, 1, BLOCK), **kw)
    q = torch.randn((Q, D_PAD), **kw).bfloat16()
    bmap = torch.stack([torch.randperm(NB, **kw)[:PROBES]
                        for _ in range(Q // Q_TILE)]).int()
    blocks = {"int8f": vb8, "bf16": vb8.bfloat16()}
    out = {"full_ms": {}, "pruned256_ms": {}}
    for name in ("int8f", "bf16", "int8f", "bf16"):
        vb = blocks[name]
        out["full_ms"].setdefault(name, []).append(
            _ms(lambda: bs.bucket_scan(vn, vb, q, m=M, bits=BITS)))
        out["pruned256_ms"].setdefault(name, []).append(_ms(
            lambda: bs.bucket_scan(vn, vb, q, m=M, bits=BITS, bmap=bmap,
                                   nprobe=PROBES, q_tile=Q_TILE)))
    out["int8f_equals_bf16"] = torch.equal(
        *(bs.bucket_scan(vn, vb, q, m=M, bits=BITS)
          for vb in blocks.values()))
    vbk = vb8.transpose(1, 2).contiguous()  # the K-major pure-int8 pack
    vn2 = torch.randint(0, 2 ** 20, (NB, 1, BLOCK), dtype=torch.int32, **kw)
    qi = torch.randint(-127, 128, (Q, D_PAD), dtype=torch.int8, **kw)
    for name in ("i8", "int8f", "i8", "int8f"):
        out.setdefault("i8_vs_int8f_full_ms", {}).setdefault(name, []).append(
            _ms(lambda: bi.bucket_scan_i8(vn2, vbk, qi, m=M)) if name == "i8"
            else _ms(lambda: bs.bucket_scan(vn, vb8, q, m=M, bits=BITS)))
    del vb8, vbk, blocks
    for nq in (pab.Q, Q):
        vn_ab, vb_ab, q_ab, qn_ab = pab.make_inputs(10_000_000, q=nq)
        args = dict(m=pab.M, bits=pab.id_bits(vb_ab.shape[0],
                                              pab.BLOCK // pab.M))
        out[f"probe_q{nq}_ms"] = {mode: _ms(lambda: pab.probe_kernel_ab(
            mode, vn_ab, vb_ab, q_ab, qn_ab, **args)) for mode in pab.MODES}
        del vn_ab, vb_ab, q_ab, qn_ab
    print(json.dumps(out))
    if not out["int8f_equals_bf16"]:
        raise AssertionError("int8f != bf16 on the widened blocks")


if __name__ == "__main__":
    main()
