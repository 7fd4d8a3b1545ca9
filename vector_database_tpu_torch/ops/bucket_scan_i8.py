"""The exact integer bucketed scan: wrapper, plain version, launch count.

``bucket_scan_i8`` computes what the TPU kernel ``_kernel_i8`` of
``vector_database_tpu/ops/pallas_knn.py`` (:344) computes over a pure-int8
pack: for every query row and bucket ``c < m`` the minimum over blocks of
``min_j(vn2[b, j*m+c] + qi . vb[b, :, j*m+c])`` in int32, and in a second
output the first block that reached it (ties keep the earlier block). The
CUDA source is ``csrc/bucket_scan_i8.cu`` (int8 tensor cores); its header
says what bounds it on an H100.

On a CUDA tensor the wrapper launches the kernel (building it with
``nvcc`` at first use) or raises. On a CPU tensor it runs
``bucket_scan_i8_reference``, the plain torch loop with the same
arguments. ``bucket_scan_i8.LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.ops.exact import full_f32

# An f32 product of int8-valued operands is exact while every partial sum
# stays below 2^24: 1024 * 127^2 < 2^24.
_EXACT_K = 1024


def _declare(lib):
    lib.bucket_scan_i8_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.bucket_scan_i8_launch.restype = ctypes.c_int
    lib.bucket_scan_i8_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bucket_scan_i8_smem_bytes.restype = ctypes.c_size_t


def _load():
    return cuda_build.load("bucket_scan_i8", _declare)


def _check(vn, vb, q, m):
    if vb.dim() != 3 or vn.shape != (vb.shape[0], 1, vb.shape[2]):
        raise ValueError(
            f"vb must be [nb, d_pad, block] and vn [nb, 1, block]; got "
            f"{tuple(vb.shape)} and {tuple(vn.shape)}"
        )
    if vb.dtype != torch.int8 or vn.dtype != torch.int32 or \
            q.dtype != torch.int8:
        raise TypeError("bucket_scan_i8 takes int8 vb and q, int32 vn")
    d_pad, block = vb.shape[1:]
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


def bucket_scan_i8_reference(vn, vb, q, *, m):
    """Plain torch version of the kernel: ``(scores, block_ids)``, both
    ``[q_pad, m]`` int32."""
    _check(vn, vb, q, m)
    nb, _, block = vb.shape
    w = block // m
    q_pad = q.shape[0]
    scores = torch.full((q_pad, m), 2 ** 31 - 1, dtype=torch.int32,
                        device=q.device)
    ids = torch.zeros((q_pad, m), dtype=torch.int32, device=q.device)
    qf = q.float()
    for b in range(nb):
        s = _int_dot(qf, vb[b].float()) + vn[b]
        mins = s.view(q_pad, w, m).amin(1)
        better = mins < scores
        scores = torch.where(better, mins, scores)
        ids = torch.where(better, b, ids)
    return scores, ids


def _pick_tile(q_pad: int, d_pad: int, m: int) -> tuple[int, int]:
    """The kernel's query tile ``qt`` (the largest of 64/32/16/8 dividing
    ``q_pad``) and its warp rows ``wm`` (the fewest of 1/2/4 covering qt
    whose CTA width 256/wm divides m), within shared memory."""
    lib = _load()
    for qt in (64, 32, 16, 8):
        if q_pad % qt:
            continue
        for wm in (1, 2, 4):
            if 16 * wm >= qt and m % (256 // wm) == 0 and \
                    lib.bucket_scan_i8_smem_bytes(wm, d_pad) <= \
                    cuda_build.SMEM_LIMIT:
                return qt, wm
    raise ValueError(
        f"no kernel tile for q_pad={q_pad}, d_pad={d_pad}, m={m} (q_pad "
        "must be a multiple of 8)"
    )


def bucket_scan_i8(vn, vb, q, *, m):
    """The exact integer scan: ``(scores, block_ids)``, ``[q_pad, m]``
    int32 each. Arguments as ``bucket_scan_i8_reference``."""
    if q.device.type == "cpu":
        return bucket_scan_i8_reference(vn, vb, q, m=m)
    if q.device.type != "cuda":
        raise RuntimeError(f"bucket_scan_i8: no kernel for {q.device}")
    _check(vn, vb, q, m)
    if any(x.device != q.device or not x.is_contiguous()
           for x in (vn, vb, q)):
        raise ValueError("bucket_scan_i8: inputs must be contiguous, one "
                         "device")
    nb, d_pad, block = vb.shape
    if d_pad % 32 or m % 64:
        raise ValueError(
            f"the CUDA kernel needs d_pad % 32 == 0 and m % 64 == 0; got "
            f"d_pad={d_pad}, m={m}"
        )
    q_pad = q.shape[0]
    qt, wm = _pick_tile(q_pad, d_pad, m)
    scores = torch.empty((q_pad, m), dtype=torch.int32, device=q.device)
    ids = torch.empty((q_pad, m), dtype=torch.int32, device=q.device)
    err = _load().bucket_scan_i8_launch(
        vn.data_ptr(), vb.data_ptr(), q.data_ptr(), scores.data_ptr(),
        ids.data_ptr(), nb, d_pad, block, m, q_pad, qt, wm,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bucket_scan_i8 launch failed: CUDA error {err}")
    bucket_scan_i8.LAUNCHES += 1
    return scores, ids


bucket_scan_i8.LAUNCHES = 0
