"""Hold the scan kernels against another version of their sources on one
card: the same outputs bit for bit, and the two times in turns.

    python -m vector_database_tpu_torch.benchmarks.scan_ab OTHER_CSRC_DIR

Run from the root of a checkout: the inputs are ``chip_smoke.py``'s
phases 4 and 6 (its recipe, seed and sizes: 10M x 96 clustered rows, the
fused build at leaf 16, ``pack_database(buckets=4096)`` in bf16, int8f
and int8, 4096 queries), made with that script's own functions.
``OTHER_CSRC_DIR`` holds another version of ``csrc/`` (for example the
parent commit's, unpacked with ``git archive``) from before the row
strides and the K-major int8 pack: its ``bucket_scan_sm90.cu`` takes an
element size but no row strides, and its ``bucket_scan_i8.cu`` (the
``mma.sync`` kernel) reads ``vb`` as ``[nb, d_pad, block]`` with a query
tile and warp rows of its own. Both are built here with this package's
``nvcc`` flags (each source beside its own headers). Cases: the bf16
scan, full and pruned to 256 blocks at q_tile 512, and the int8f scan,
full, on this package's tile plan; the exact int8 scan, full, the other
kernel on the pack's blocks transposed back to ``[nb, d_pad, block]``.
Each pair of outputs must be equal bit for bit; then each kernel is timed
in turns (other, this, this, other; CUDA events, median of 5 calls).
Prints the card and one JSON line; raises if an output differs.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from vector_database_tpu_torch.ops import bucket_scan as bs
from vector_database_tpu_torch.ops import bucket_scan_i8 as bi
from vector_database_tpu_torch.ops import cuda_build

REPS = 5
PROBES, Q_TILE = 256, 512


def _load_other(src: Path) -> ctypes.CDLL:
    h = hashlib.sha256()
    for f in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(f.read_bytes())
    out = cuda_build._BUILD_DIR / f"other_{src.stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build._NVCC_FLAGS, "-o",
                        str(out), str(src)], check=True)
    return ctypes.CDLL(str(out))


def _load_others(csrc: Path):
    scan = _load_other(csrc / "bucket_scan_sm90.cu")
    scan.bucket_scan_sm90_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    scan.bucket_scan_sm90_launch.restype = ctypes.c_int
    i8 = _load_other(csrc / "bucket_scan_i8.cu")
    i8.bucket_scan_i8_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    i8.bucket_scan_i8_launch.restype = ctypes.c_int
    i8.bucket_scan_i8_smem_bytes.argtypes = [ctypes.c_int] * 2
    i8.bucket_scan_i8_smem_bytes.restype = ctypes.c_size_t
    return scan, i8


def _other_scan(lib, vn, vb, q, *, m, bits, bmap=None, nprobe=None,
                q_tile=None):
    """The other float scan on the arguments of ``bucket_scan`` (blocks in
    contiguous rows)."""
    nb, d_pad, block = vb.shape
    q_pad = q.shape[0]
    esize = vb.element_size()
    plan = bs.scan_plan(q_tile or q_pad, d_pad, esize)
    out = torch.empty((q_pad, m), dtype=torch.float32, device=q.device)
    err = lib.bucket_scan_sm90_launch(
        vn.data_ptr(), vb.data_ptr(), q.data_ptr(),
        None if bmap is None else bmap.data_ptr(), out.data_ptr(), nb, d_pad,
        block, m, bits, q_pad, q_tile or q_pad,
        0 if bmap is None else bmap.shape[1], nprobe or 0, plan.nq, plan.kc,
        plan.stages, esize, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the other scan failed: CUDA error {err}")
    return out


def _other_i8(lib, vn, vb_t, q, *, m):
    """The other exact int8 scan on ``vb_t [nb, d_pad, block]``, with its
    own tile choice: the largest query tile of 64/32/16/8 rows dividing
    q_pad, and the fewest warp rows whose CTA width divides m, within
    shared memory."""
    nb, d_pad, block = vb_t.shape
    q_pad = q.shape[0]
    tile = next(((qt, wm) for qt in (64, 32, 16, 8) if q_pad % qt == 0
                 for wm in (1, 2, 4)
                 if 16 * wm >= qt and m % (256 // wm) == 0 and
                 lib.bucket_scan_i8_smem_bytes(wm, d_pad)
                 <= cuda_build.SMEM_LIMIT), None)
    if tile is None:
        raise ValueError(f"no tile of the other i8 kernel for q_pad={q_pad}")
    scores = torch.empty((q_pad, m), dtype=torch.int32, device=q.device)
    ids = torch.empty_like(scores)
    err = lib.bucket_scan_i8_launch(
        vn.data_ptr(), vb_t.data_ptr(), q.data_ptr(), scores.data_ptr(),
        ids.data_ptr(), nb, d_pad, block, m, q_pad, *tile,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the other i8 scan failed: CUDA error {err}")
    return scores, ids


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("scan_ab: no CUDA device")
    import chip_smoke as cs  # the checkout's root is the working directory
    from vector_database_tpu_torch import build_index_fused, pack_database
    from vector_database_tpu_torch.ops.packed_knn import (
        _block_map,
        _scan_queries,
    )

    scan_lib, i8_lib = _load_others(Path(argv[0]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    dev = torch.device("cuda")
    train, test, _, _ = cs._clustered(dev, cs.N, cs.SEED)
    index = build_index_fused(train, leaf_size=cs.LEAF)
    del train
    pack = pack_database(index.vectors, buckets=cs.BUCKETS)
    qp = torch.zeros((cs.Q, pack.d_pad), device=dev)
    qp[:, :cs.D] = test
    qb = qp.bfloat16()
    args = dict(m=pack.m, bits=pack.bits)
    order, bmap = _block_map(pack, test, q_tile=Q_TILE, probes=PROBES)
    cases = {
        "bf16_full": (lambda: bs.bucket_scan(pack.vn, pack.vb, qb, **args),
                      lambda: _other_scan(scan_lib, pack.vn, pack.vb, qb,
                                          **args)),
    }
    pargs = dict(args, bmap=bmap, nprobe=PROBES, q_tile=Q_TILE)
    qs = qb[order]
    cases["bf16_pruned256"] = (
        lambda: bs.bucket_scan(pack.vn, pack.vb, qs, **pargs),
        lambda: _other_scan(scan_lib, pack.vn, pack.vb, qs, **pargs))
    p8f = pack_database(index.vectors, buckets=cs.BUCKETS, dtype="int8f")
    qf = _scan_queries(p8f, qp)
    args8 = dict(m=p8f.m, bits=p8f.bits)
    cases["int8f_full"] = (
        lambda: bs.bucket_scan(p8f.vn, p8f.vb, qf, **args8),
        lambda: _other_scan(scan_lib, p8f.vn, p8f.vb, qf, **args8))
    p8 = pack_database(index.vectors, buckets=cs.BUCKETS, dtype="int8")
    del index
    qi = _scan_queries(p8, qp)
    vb_t = p8.vb.transpose(1, 2).contiguous()  # the other kernel's layout
    cases["i8_full"] = (
        lambda: bi.bucket_scan_i8(p8.vn, p8.vb, qi, m=p8.m),
        lambda: _other_i8(i8_lib, p8.vn, vb_t, qi, m=p8.m))
    result = {}
    for name, (this, other) in cases.items():
        equal = _equal(this(), other())
        times = [cs._ms(fn, REPS) for fn in (other, this, this, other)]
        result[name] = dict(bitwise_equal=equal, other_ms=times[::3],
                            this_ms=times[1:3])
    print(json.dumps(result))
    if not all(r["bitwise_equal"] for r in result.values()):
        raise AssertionError("the two versions' outputs differ")


if __name__ == "__main__":
    main()
