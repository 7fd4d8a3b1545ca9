"""The exact integer bucketed scan: wrapper, plain version, tile plan,
launch count.

``bucket_scan_i8`` computes what the TPU kernel ``_kernel_i8`` of
``vector_database_tpu/ops/pallas_knn.py`` (:344) computes over a pure-int8
pack: for every query row and bucket ``c < m`` the minimum over blocks and
slices of ``vn2[b, j*m+c] + qi . vb[b, j*m+c, :]`` in int32, and in a
second output the first block that reached it (ties keep the earlier
block). That pack holds ``-v*sq`` under one symmetric scale, so the
scores are exact in its quantized values, not in the rows'. With
``uint8=True`` it scores a uint8 pack instead (``pack_database(dtype=
"uint8")``: ``vb = v - 128``, ``qi = q - 128`` over the whole int8 range,
``vn2 = |v - 128|^2``): the minimum of ``vn2 - 2 qi . vb``, which is
``|v - q|^2 - |q - 128|^2`` exactly for every uint8 row and query (no
int8 value is negated, since ``-(-128)`` does not fit). The pack's ``vb``
is K-major, ``[nb, block, d_pad]`` (each block's
rows as they lie), because s8 ``wgmma`` reads both operands K-major; the
JAX package's is ``[nb, d_pad, block]``, which ``PackedDB.from_numpy``
transposes once, at load.

On a CUDA tensor the wrapper launches ``csrc/bucket_scan_i8.cu`` (the s8
route of the Hopper skeleton ``csrc/sm90.cuh``: a TMA ring, s8 ``wgmma``
with both operands from shared memory, 256-row query tiles), building it
with ``nvcc`` at first use, or raises. Its tiling comes from ``i8_plan``;
the source's header says what bounds it on an H100. It takes any ``m``
that divides ``block`` (slices whose norms do not start on 16-byte
boundaries are scanned from a copy laid out in aligned slices, as in
``bucket_scan``). On a CPU tensor the wrapper runs
``bucket_scan_i8_reference``, the plain torch loop with the same
arguments. ``utils/profiling.COUNTERS["scan.launches.int8"]`` counts
the kernel's launches in the symmetric form, ``"scan.launches.uint8"``
those in the uint8 form.
"""

from __future__ import annotations

import ctypes

import torch

from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.ops.bucket_scan import (
    ScanPlan,
    check_kernel_shape,
    fit_plan,
    pad_slices,
    row_pitch,
    row_stride,
    slices_aligned,
)
from vector_database_tpu_torch.ops.exact import full_f32
from vector_database_tpu_torch.utils.profiling import COUNTERS

# An f32 product of int8-valued operands is exact while every partial sum
# stays within 2^24: 1024 * 128^2 = 2^24.
_EXACT_K = 1024
# bytes of k in a staged tile: one 128-byte swizzled row of the K-major
# pack (a chunk that runs past d_pad reads TMA's zero fill)
KC = 128


def i8_plan(rows: int, d_pad: int) -> ScanPlan:
    """The kernel's plan for ``rows`` query rows (``q_pad``) at ``d_pad``:
    as ``scan_plan``, with ``[64][128 B]`` int8 tiles and int8 queries (a
    query-tile row holds 128 columns). Raises ``ValueError`` for shapes
    the kernel cannot take."""
    if rows < 1:
        raise ValueError(f"i8_plan: rows must be >= 1; got {rows}")
    if d_pad < 16 or d_pad % 16:
        raise ValueError(
            f"the i8 kernel needs d_pad % 16 == 0; got d_pad={d_pad}")
    return fit_plan(rows, d_pad, (KC,), esize=1, qsize=1)


def _declare(lib):
    lib.bucket_scan_i8_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    lib.bucket_scan_i8_launch.restype = ctypes.c_int
    lib.bucket_scan_i8_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.bucket_scan_i8_smem_bytes.restype = ctypes.c_size_t


def _load():
    return cuda_build.load("bucket_scan_i8", _declare)


def _check(vn, vb, q, m):
    if vb.dim() != 3 or vn.shape != (vb.shape[0], 1, vb.shape[1]):
        raise ValueError(
            f"vb must be [nb, block, d_pad] and vn [nb, 1, block]; got "
            f"{tuple(vb.shape)} and {tuple(vn.shape)}"
        )
    if vb.dtype != torch.int8 or vn.dtype != torch.int32 or \
            q.dtype != torch.int8:
        raise TypeError("bucket_scan_i8 takes int8 vb and q, int32 vn")
    block, d_pad = vb.shape[1:]
    if q.dim() != 2 or q.shape[1] != d_pad:
        raise ValueError(f"q must be [q_pad, {d_pad}]; got {tuple(q.shape)}")
    if block % m:
        raise ValueError(f"block ({block}) must be a multiple of m ({m})")


def _int_dot(a, b):
    """Exact int32 ``a @ b`` of int8-valued f32 matrices: f32 products in
    contraction chunks of at most 1024 (exact, with TF32 off), summed in
    int32. The card has no general integer matmul; the CPU runs the same."""
    k = a.shape[1]
    out = None
    with full_f32():
        for k0 in range(0, k, _EXACT_K):
            part = (a[:, k0:k0 + _EXACT_K] @ b[k0:k0 + _EXACT_K]).to(
                torch.int32)
            out = part if out is None else out + part
    return out


def bucket_scan_i8_reference(vn, vb, q, *, m, uint8=False):
    """Plain torch version of the kernel: ``(scores, block_ids)``, both
    ``[q_pad, m]`` int32, from K-major int8 blocks ``vb [nb, block,
    d_pad]``, int32 norms ``vn [nb, 1, block]`` and int8 queries ``q
    [q_pad, d_pad]``; a score is ``vn + q . vb``, or ``vn - 2 q . vb``
    with ``uint8``."""
    _check(vn, vb, q, m)
    nb, block, _ = vb.shape
    w = block // m
    q_pad = q.shape[0]
    scores = torch.full((q_pad, m), 2 ** 31 - 1, dtype=torch.int32,
                        device=q.device)
    ids = torch.zeros((q_pad, m), dtype=torch.int32, device=q.device)
    qf = q.float()
    for b in range(nb):
        dot = _int_dot(qf, vb[b].float().T)
        s = vn[b] - 2 * dot if uint8 else dot + vn[b]
        mins = s.view(q_pad, w, m).amin(1)
        better = mins < scores
        scores = torch.where(better, mins, scores)
        ids = torch.where(better, b, ids)
    return scores, ids


def bucket_scan_i8(vn, vb, q, *, m, uint8=False):
    """The exact integer scan: ``(scores, block_ids)``, ``[q_pad, m]``
    int32 each. Arguments as ``bucket_scan_i8_reference``."""
    if q.device.type == "cpu":
        return bucket_scan_i8_reference(vn, vb, q, m=m, uint8=uint8)
    if q.device.type != "cuda":
        raise RuntimeError(f"bucket_scan_i8: no kernel for {q.device}")
    _check(vn, vb, q, m)
    if any(x.device != q.device for x in (vn, vb)) or not q.is_contiguous():
        raise ValueError("bucket_scan_i8: inputs must lie on one device, q "
                         "contiguous")
    nb, block, d_pad = vb.shape
    check_kernel_shape(d_pad, m)
    if not slices_aligned(m, block, 4):  # norms only: K-major rows are
        scores, ids = bucket_scan_i8(pad_slices(vn, m, 2),
                                     pad_slices(vb, m, 1), q, m=row_pitch(m),
                                     uint8=uint8)
        return scores[:, :m].contiguous(), ids[:, :m].contiguous()
    ld_vb, ld_vn = row_stride(vb), row_stride(vn)
    q_pad = q.shape[0]
    plan = i8_plan(q_pad, d_pad)
    scores = torch.empty((q_pad, m), dtype=torch.int32, device=q.device)
    ids = torch.empty((q_pad, m), dtype=torch.int32, device=q.device)
    err = _load().bucket_scan_i8_launch(
        vn.data_ptr(), vb.data_ptr(), q.data_ptr(), scores.data_ptr(),
        ids.data_ptr(), nb, d_pad, block, ld_vb, ld_vn, m, q_pad, plan.nq,
        plan.stages, int(uint8),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bucket_scan_i8 launch failed: CUDA error {err}")
    COUNTERS["scan.launches.uint8" if uint8 else "scan.launches.int8"] += 1
    return scores, ids
