"""A/B probe of the bucketed scan's parts on the card (port of
``benchmarks/probe_kernel_ab.py``).

    python -m vector_database_tpu_torch.benchmarks.probe_kernel_ab [N] [modes]

Four variants of the scan, one CUDA kernel with a compile-time mode
(``csrc/probe_kernel_ab.cu``) on the serving scan's skeleton
(``csrc/sm90.cuh``: TMA ring, ``wgmma``, 256-row query tiles, the same
tile plan ``ops.bucket_scan.scan_plan``), split the serving kernel's time
between streaming the blocks, the products and the epilogue:

- ``full``: the older scan's per-slice epilogue, an int32 running min of
  ``(bits(vn - 2 q.v + qn) & keep) | (b*w + j)``;
- ``noepi``: the int32 min of the raw dot's bits (products, no epilogue);
- ``nodot``: the ``full`` epilogue on ``vn * 1.0001`` (no products), as
  XLA compiles the TPU probe's: ``2 * 1.0001`` folds and
  ``vn - vn * 2.0002`` rounds once (a fused multiply-add);
- ``dmaonly``: the blocks stream; once per block the accumulator takes
  the bits of the first slice's norm row.

Defaults as the TPU probe's: N = 10M rows, D = 96 (d_pad 128), Q = 1024,
block 8192, m 2048, 20 timed calls per mode (CUDA events). One JSON line
per mode: ``mode``, ``ms_per_1024q``, ``us_per_tile_block`` (per block
and 256-query tile) and ``qps``. Block-slice ids take
``bits = (nb*w - 1).bit_length()`` bits (13 at 10M): a fixed 12 would let
ids above 4095 spill into the score bits.

``probe_kernel_ab`` launches the kernel on CUDA tensors (or raises) and
runs ``probe_kernel_ab_reference``, the plain torch version, on CPU
tensors; ``probe_kernel_ab.LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.ops.bucket_scan import (
    check_kernel_shape,
    pad_slices,
    row_pitch,
    row_stride,
    scan_plan,
    slices_aligned,
)

D, Q, REPS = 96, 1024, 20
D_PAD, BLOCK, Q_TILE, M = 128, 8192, 256, 2048
MODES = ("full", "noepi", "nodot", "dmaonly")
_NODOT_2X = 2.0 * float(np.float32(1.0001))  # exact: twice an f32


def id_bits(nb: int, w: int) -> int:
    """Bits that hold every block-slice id ``b*w + j`` of ``nb`` blocks."""
    return max(1, (nb * w - 1).bit_length())


def _declare(lib):
    lib.probe_kernel_ab_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 +
        [ctypes.c_void_p]
    )
    lib.probe_kernel_ab_launch.restype = ctypes.c_int
    lib.probe_kernel_ab_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.probe_kernel_ab_smem_bytes.restype = ctypes.c_size_t


def _load():
    return cuda_build.load("probe_kernel_ab", _declare)


def _check(mode, vn, vb, q, qn, m):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if vb.dim() != 3 or vn.shape != (vb.shape[0], 1, vb.shape[2]):
        raise ValueError("vb must be [nb, d_pad, block], vn [nb, 1, block]")
    if q.dim() != 2 or q.shape[1] != vb.shape[1] or \
            qn.shape != (q.shape[0], 1):
        raise ValueError("q must be [q_pad, d_pad] and qn [q_pad, 1]")
    if vb.dtype != torch.bfloat16 or q.dtype != torch.bfloat16 or \
            vn.dtype != torch.float32 or qn.dtype != torch.float32:
        raise TypeError("the probe takes bf16 vb and q, f32 vn and qn")
    if vb.shape[2] % m:
        raise ValueError(f"block ({vb.shape[2]}) must be a multiple of m")


def probe_kernel_ab_reference(mode, vn, vb, q, qn, *, m, bits):
    """Plain torch version: the ``[q_pad, m]`` int32 accumulator."""
    _check(mode, vn, vb, q, qn, m)
    nb, _, block = vb.shape
    w = block // m
    keep = ~((1 << bits) - 1)
    acc = torch.full((q.shape[0], m), 2 ** 31 - 1, dtype=torch.int32,
                     device=q.device)
    qf = q.float()
    for b in range(nb):
        if mode == "dmaonly":
            acc = torch.minimum(acc, vn[b, :, :m].view(torch.int32))
            continue
        for j in range(w):
            vrow = vn[b, :, j * m:(j + 1) * m]  # [1, m]
            if mode == "nodot":
                # one rounding of vn - vn * 2.0002: float64 holds the
                # product and the difference exactly
                v64 = vrow.double()
                d2 = (v64 - v64 * _NODOT_2X).float() + qn
            else:
                sl = qf @ vb[b, :, j * m:(j + 1) * m].float()
                if mode == "noepi":
                    acc = torch.minimum(acc, sl.view(torch.int32))
                    continue
                d2 = (vrow - 2.0 * sl) + qn
            acc = torch.minimum(
                acc, (d2.view(torch.int32) & keep) | (b * w + j))
    return acc


def probe_kernel_ab(mode, vn, vb, q, qn, *, m, bits):
    """The probe kernel in ``mode``; arguments as the plain version."""
    if q.device.type == "cpu":
        return probe_kernel_ab_reference(mode, vn, vb, q, qn, m=m, bits=bits)
    if q.device.type != "cuda":
        raise RuntimeError(f"probe_kernel_ab: no kernel for {q.device}")
    _check(mode, vn, vb, q, qn, m)
    if any(x.device != q.device or not x.is_contiguous()
           for x in (vn, vb, q, qn)):
        raise ValueError("probe_kernel_ab: inputs must be contiguous, one "
                         "device")
    nb, d_pad, block = vb.shape
    check_kernel_shape(d_pad, m)
    if not slices_aligned(m, block, 2, 4):  # as bucket_scan
        return probe_kernel_ab(mode, pad_slices(vn, m, 2),
                               pad_slices(vb, m, 2), q, qn, m=row_pitch(m),
                               bits=bits)[:, :m].contiguous()
    row_stride(vb), row_stride(vn)  # rows on 16-byte boundaries
    q_pad = q.shape[0]
    plan = scan_plan(q_pad, d_pad, qn_tile=True)
    out = torch.empty((q_pad, m), dtype=torch.int32, device=q.device)
    err = _load().probe_kernel_ab_launch(
        MODES.index(mode), vn.data_ptr(), vb.data_ptr(), q.data_ptr(),
        qn.data_ptr(), out.data_ptr(), nb, d_pad, block, m, bits, q_pad,
        plan.nq, plan.kc, plan.stages,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"probe_kernel_ab launch failed: CUDA error {err}")
    probe_kernel_ab.LAUNCHES += 1
    return out


probe_kernel_ab.LAUNCHES = 0


def make_inputs(n: int, *, q: int = Q, device="cuda"):
    """The probe's random operands, as the TPU probe draws them (normal
    blocks and queries in bf16, |normal| norms), from a generator seeded
    with 0 on ``device``: ``(vn, vb, q, qn)``."""
    nb = -(-n // BLOCK)
    g = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=g, device=device)
    vb = torch.randn((nb, D_PAD, BLOCK), dtype=torch.bfloat16, **kw)
    vn = torch.randn((nb, 1, BLOCK), **kw).abs_()
    qb = torch.randn((q, D_PAD), dtype=torch.bfloat16, **kw)
    qn = torch.randn((q, 1), **kw).abs_()
    return vn, vb, qb, qn


def run(n: int = 10_000_000, modes=MODES):
    """Time each mode's kernel at ``n`` rows and ``Q`` queries on the
    card, ``REPS`` calls after one warm call: one dict per mode with the
    probe's keys."""
    if not torch.cuda.is_available():
        raise RuntimeError("the A/B probe times a CUDA kernel: no GPU here")
    vn, vb, qb, qn = make_inputs(n)
    nb = vb.shape[0]
    bits = id_bits(nb, BLOCK // M)
    results = []
    for mode in modes:
        def call():
            return probe_kernel_ab(mode, vn, vb, qb, qn, m=M, bits=bits)

        call()  # warm
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(REPS):
            call()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / REPS
        results.append({
            "mode": mode, "ms_per_1024q": ms * Q / qb.shape[0],
            "us_per_tile_block": ms * 1e3 / (nb * (qb.shape[0] // Q_TILE)),
            "qps": qb.shape[0] / ms * 1e3,
        })
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 10_000_000
    modes = argv[1].split(",") if len(argv) > 1 else MODES
    if not torch.cuda.is_available():
        sys.exit("probe_kernel_ab: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    for r in run(n, modes):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
