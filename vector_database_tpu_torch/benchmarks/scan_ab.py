"""Hold the bf16 scan kernel against another version of its source on one
card: the same output bit for bit, and the two times in turns.

    python -m vector_database_tpu_torch.benchmarks.scan_ab OTHER.cu

Run from the root of a checkout: the inputs are ``chip_smoke.py``'s
phase 4 (its recipe, seed and sizes: 10M x 96 clustered rows, the fused
build at leaf 16, ``pack_database(buckets=4096)``, 4096 queries), made
with that script's own functions. ``OTHER.cu`` is a version of
``csrc/bucket_scan_sm90.cu`` from before the int8 instantiation, whose
``bucket_scan_sm90_launch`` takes no element size; it is built here with
this package's ``nvcc`` flags and launched with this package's tile plan.
For the full scan, and the scan pruned to 256 blocks at q_tile 512, the
two accumulators must be equal bit for bit; then each kernel is timed in
turns (other, this, this, other; CUDA events, median of 5 calls). Prints
the card and one JSON line; raises if an output differs.
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
from vector_database_tpu_torch.ops import cuda_build

REPS = 5
PROBES, Q_TILE = 256, 512


def _load_other(src: Path) -> ctypes.CDLL:
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = cuda_build._BUILD_DIR / f"other_bucket_scan_sm90_{h}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build._NVCC_FLAGS, "-o",
                        str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.bucket_scan_sm90_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.bucket_scan_sm90_launch.restype = ctypes.c_int
    return lib


def _other_scan(lib, vn, vb, q, *, m, bits, bmap=None, nprobe=None,
                q_tile=None):
    """The other kernel on the arguments of ``bucket_scan``."""
    nb, d_pad, block = vb.shape
    q_pad = q.shape[0]
    plan = bs.scan_plan(q_tile or q_pad, d_pad)
    out = torch.empty((q_pad, m), dtype=torch.float32, device=q.device)
    err = lib.bucket_scan_sm90_launch(
        vn.data_ptr(), vb.data_ptr(), q.data_ptr(),
        None if bmap is None else bmap.data_ptr(), out.data_ptr(), nb, d_pad,
        block, m, bits, q_pad, q_tile or q_pad,
        0 if bmap is None else bmap.shape[1], nprobe or 0, plan.nq, plan.kc,
        plan.stages, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the other kernel failed: CUDA error {err}")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("scan_ab: no CUDA device")
    import chip_smoke as cs  # the checkout's root is the working directory
    from vector_database_tpu_torch import build_index_fused, pack_database
    from vector_database_tpu_torch.ops.packed_knn import _block_map

    lib = _load_other(Path(argv[0]))
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
    del index
    d_pad = pack.vb.shape[1]
    qb = torch.zeros((cs.Q, d_pad), device=dev)
    qb[:, :cs.D] = test
    qb = qb.bfloat16()
    args = dict(m=pack.m, bits=pack.bits)
    order, bmap = _block_map(pack, test, q_tile=Q_TILE, probes=PROBES)
    cases = {"full": (qb, args),
             "pruned256": (qb[order], dict(args, bmap=bmap, nprobe=PROBES,
                                            q_tile=Q_TILE))}
    result = {}
    for name, (q, kw) in cases.items():
        def this():
            return bs.bucket_scan(pack.vn, pack.vb, q, **kw)

        def other():
            return _other_scan(lib, pack.vn, pack.vb, q, **kw)

        equal = torch.equal(this(), other())
        times = [cs._ms(fn, REPS) for fn in (other, this, this, other)]
        result[name] = dict(bitwise_equal=equal, other_ms=times[::3],
                            this_ms=times[1:3])
    print(json.dumps(result))
    if not all(r["bitwise_equal"] for r in result.values()):
        raise AssertionError("the two kernels' outputs differ")


if __name__ == "__main__":
    main()
