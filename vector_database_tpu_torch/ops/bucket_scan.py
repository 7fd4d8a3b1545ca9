"""The bucketed scan kernel: wrapper, plain version, launch counts.

``bucket_scan`` computes what the three float-scoring Pallas kernels of
``vector_database_tpu/ops/pallas_knn.py`` compute (``_kernel`` :130,
``_kernel_pruned`` :203, ``_kernel_pruned_rt`` :274): for every query row
and bucket ``c < m`` the minimum over the streamed blocks of
``enc(min_j(vn[b, j*m+c] + q . vb[b, :, j*m+c]), b)``, where ``enc``
replaces the score's low ``bits`` bits with the block id. ``vb`` is bf16
(bf16 packs) or int8 (int8f packs, widened to bf16 in the kernel). The
CUDA source is ``csrc/bucket_scan.cu``; its header says what bounds it on
an H100.

On a CUDA tensor the wrapper launches the kernel (building it with
``nvcc`` at first use) or raises. On a CPU tensor it runs
``bucket_scan_reference``, the plain torch loop with the same arguments.
``bucket_scan.LAUNCHES`` counts the kernel's launches on bf16 blocks,
``bucket_scan.LAUNCHES_INT8F`` those on int8 blocks.
"""

from __future__ import annotations

import ctypes

import torch

from vector_database_tpu_torch.ops import cuda_build

_MT = 128  # the kernel's bucket columns per CTA


def _declare(lib):
    lib.bucket_scan_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    )
    lib.bucket_scan_launch.restype = ctypes.c_int
    lib.bucket_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.bucket_scan_smem_bytes.restype = ctypes.c_size_t


def _load():
    return cuda_build.load("bucket_scan", _declare)


def _check(vn, vb, q, m, bmap, nprobe, q_tile):
    """Shapes, types and the block-map contract both versions share."""
    if vb.dim() != 3 or vn.shape != (vb.shape[0], 1, vb.shape[2]):
        raise ValueError(
            f"vb must be [nb, d_pad, block] and vn [nb, 1, block]; got "
            f"{tuple(vb.shape)} and {tuple(vn.shape)}"
        )
    nb, d_pad, block = vb.shape
    if vb.dtype not in (torch.bfloat16, torch.int8) or \
            vn.dtype != torch.float32 or q.dtype != torch.bfloat16:
        raise TypeError("bucket_scan takes bf16 or int8 vb, bf16 q, f32 vn")
    if q.dim() != 2 or q.shape[1] != d_pad:
        raise ValueError(f"q must be [q_pad, {d_pad}]; got {tuple(q.shape)}")
    if block % m:
        raise ValueError(f"block ({block}) must be a multiple of m ({m})")
    if bmap is None:
        return
    if bmap.dtype != torch.int32 or bmap.dim() != 2:
        raise TypeError("bmap must be a [tiles, pmax] int32 tensor")
    if q_tile is None or bmap.shape[0] * q_tile != q.shape[0]:
        raise ValueError("bmap needs q_tile with tiles * q_tile == q_pad")
    if not 1 <= nprobe <= bmap.shape[1]:
        raise ValueError(f"nprobe ({nprobe}) must be in [1, {bmap.shape[1]}]")


def bucket_scan_reference(vn, vb, q, *, m, bits, bmap=None, nprobe=None,
                          q_tile=None):
    """Plain torch version of the kernel: ``[q_pad, m]`` f32 accumulator.

    Full scan when ``bmap`` is None; otherwise query group ``t`` (rows
    ``t*q_tile`` on) streams blocks ``bmap[t, :nprobe]``."""
    if nprobe is None and bmap is not None:
        nprobe = bmap.shape[1]
    _check(vn, vb, q, m, bmap, nprobe, q_tile)
    nb, _, block = vb.shape
    w = block // m
    keep = ~((1 << bits) - 1)
    q_pad = q.shape[0]
    acc = torch.full((q_pad, m), 3.0e38, dtype=torch.float32, device=q.device)
    qf = q.float()
    if bmap is None:
        groups = [(0, q_pad, range(nb))]
    else:
        host = bmap[:, :nprobe].cpu().tolist()
        groups = [(t * q_tile, (t + 1) * q_tile, blocks)
                  for t, blocks in enumerate(host)]
    for lo, hi, blocks in groups:
        qg = qf[lo:hi]
        for b in blocks:
            s = qg @ vb[b].float() + vn[b]
            mins = s.view(hi - lo, w, m).amin(1)
            enc = ((mins.view(torch.int32) & keep) | b).view(torch.float32)
            acc[lo:hi] = torch.minimum(acc[lo:hi], enc)
    return acc


def bucket_scan(vn, vb, q, *, m, bits, bmap=None, nprobe=None, q_tile=None):
    """The bucketed scan: ``[q_pad, m]`` f32 accumulator, block ids in the
    low ``bits`` mantissa bits. Arguments as ``bucket_scan_reference``."""
    if q.device.type == "cpu":
        return bucket_scan_reference(
            vn, vb, q, m=m, bits=bits, bmap=bmap, nprobe=nprobe,
            q_tile=q_tile,
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"bucket_scan: no kernel for {q.device}")
    if nprobe is None and bmap is not None:
        nprobe = bmap.shape[1]
    _check(vn, vb, q, m, bmap, nprobe, q_tile)
    tensors = [vn, vb, q] + ([] if bmap is None else [bmap])
    if any(x.device != q.device or not x.is_contiguous() for x in tensors):
        raise ValueError("bucket_scan: inputs must be contiguous, one device")
    nb, d_pad, block = vb.shape
    if d_pad % 16 or m % _MT:
        raise ValueError(
            f"the CUDA kernel needs d_pad % 16 == 0 and m % {_MT} == 0; got "
            f"d_pad={d_pad}, m={m}"
        )
    q_pad = q.shape[0]
    vb_i8 = vb.dtype == torch.int8
    # the kernel's query tile divides q_pad, or q_tile for a pruned scan
    qt = cuda_build.pick_qt(
        q_pad if bmap is None else q_tile,
        lambda qt: _load().bucket_scan_smem_bytes(qt, d_pad, vb_i8),
    )
    out = torch.empty((q_pad, m), dtype=torch.float32, device=q.device)
    err = _load().bucket_scan_launch(
        vn.data_ptr(), vb.data_ptr(), q.data_ptr(),
        None if bmap is None else bmap.data_ptr(), out.data_ptr(),
        nb, d_pad, block, m, bits, q_pad, qt,
        q_tile or q_pad, 0 if bmap is None else bmap.shape[1],
        nprobe or 0, int(vb_i8),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bucket_scan launch failed: CUDA error {err}")
    if vb_i8:
        bucket_scan.LAUNCHES_INT8F += 1
    else:
        bucket_scan.LAUNCHES += 1
    return out


bucket_scan.LAUNCHES = 0
bucket_scan.LAUNCHES_INT8F = 0
