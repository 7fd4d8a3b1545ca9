"""The bucketed scan kernels: wrappers, plain version, launch counts.

``bucket_scan`` computes what the three float-scoring Pallas kernels of
``vector_database_tpu/ops/pallas_knn.py`` compute (``_kernel`` :130,
``_kernel_pruned`` :203, ``_kernel_pruned_rt`` :274): for every query row
and bucket ``c < m`` the minimum over the streamed blocks of
``enc(min_j(vn[b, j*m+c] + q . vb[b, :, j*m+c]), b)``, where ``enc``
replaces the score's low ``bits`` bits with the block id. ``vb`` is bf16
(bf16 packs) or int8 (int8f packs, widened to bf16 in the kernel).

On a CUDA tensor the wrapper launches a kernel (building it with ``nvcc``
at first use) or raises: bf16 blocks go to ``csrc/bucket_scan_sm90.cu``
(TMA ring, ``wgmma``, 256-row query tiles; its shapes come from
``scan_plan``), int8 blocks to ``csrc/bucket_scan.cu``. Each source's
header says what bounds it on an H100. On a CPU tensor the wrapper runs
``bucket_scan_reference``, the plain torch loop with the same arguments.
``bucket_scan.LAUNCHES`` counts the launches on bf16 blocks,
``bucket_scan.LAUNCHES_INT8F`` those on int8 blocks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from vector_database_tpu_torch.ops import cuda_build

_MT = 128  # the int8f kernel's bucket columns per CTA
MAX_STAGES = 8  # vb tiles in flight in the bf16 kernel's ring
MIN_STAGES = 4


class ScanPlan(NamedTuple):
    """The bf16 kernel's tiling: ``nq`` query rows per consumer warpgroup
    (the CTA holds ``rows = 2 * nq`` against each staged tile), ``kc``
    contraction rows per staged vb tile, ``stages`` tiles in the ring,
    ``smem`` bytes of shared memory a CTA claims."""

    nq: int
    kc: int
    stages: int
    smem: int

    @property
    def rows(self) -> int:
        return 2 * self.nq


def _smem_bytes(nq: int, d_pad: int, kc: int, stages: int) -> int:
    """``bucket_scan_sm90_smem_bytes`` of the CUDA source: 1024 bytes of
    alignment slack, the query tile in 64-column boxes of 128-byte rows,
    the ring of ``[kc, 64]`` bf16 tiles and their 64 f32 norms, and the
    ring's full/empty barriers plus the query tile's."""
    return (1024 + -(-d_pad // 64) * 2 * nq * 128 + stages * kc * 128
            + stages * 64 * 4 + (2 * stages + 1) * 8)


def scan_plan(rows: int, d_pad: int) -> ScanPlan:
    """The bf16 kernel's plan for query groups of ``rows`` rows (the
    block map's ``q_tile``, or ``q_pad`` for a full scan) at ``d_pad``.

    A CTA takes the fewest of 32/64/128/256 query rows that cover a group
    (256 at most: a staged tile then feeds 256 rows), fewer only where the
    query tile and a ring of at least ``MIN_STAGES`` tiles would not fit
    the block's shared memory; ``kc`` is the largest power of two from 16 to
    256 dividing ``d_pad`` that leaves room for that ring (a power of
    two: the kernel is compiled for each, so its wgmmas unroll). Raises
    ``ValueError`` for shapes the kernel cannot take."""
    if rows < 1:
        raise ValueError(f"scan_plan: rows must be >= 1; got {rows}")
    if d_pad < 16 or d_pad % 16:
        raise ValueError(
            f"the bf16 kernel needs d_pad % 16 == 0; got d_pad={d_pad}")
    nq = 16
    while nq < 128 and 2 * nq < rows:
        nq *= 2
    kcs = [kc for kc in (256, 128, 64, 32, 16) if d_pad % kc == 0]
    while nq >= 16:
        for kc in kcs:
            fixed = _smem_bytes(nq, d_pad, kc, 0)
            per = _smem_bytes(nq, d_pad, kc, 1) - fixed
            stages = min(MAX_STAGES, (cuda_build.SMEM_LIMIT - fixed) // per)
            if stages >= MIN_STAGES:
                return ScanPlan(nq, kc, stages,
                                _smem_bytes(nq, d_pad, kc, stages))
        nq //= 2
    raise ValueError(
        f"d_pad={d_pad} is too wide for the bf16 kernel: no query tile of "
        f">= 32 rows and a ring of {MIN_STAGES} tiles fit "
        f"{cuda_build.SMEM_LIMIT} bytes of shared memory"
    )


def _declare_sm90(lib):
    lib.bucket_scan_sm90_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    )
    lib.bucket_scan_sm90_launch.restype = ctypes.c_int
    lib.bucket_scan_sm90_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.bucket_scan_sm90_smem_bytes.restype = ctypes.c_size_t


def _declare_int8f(lib):
    lib.bucket_scan_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    lib.bucket_scan_launch.restype = ctypes.c_int
    lib.bucket_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.bucket_scan_smem_bytes.restype = ctypes.c_size_t


def _load_sm90():
    return cuda_build.load("bucket_scan_sm90", _declare_sm90)


def _load_int8f():
    return cuda_build.load("bucket_scan", _declare_int8f)


def _load():
    """Both libraries: ``(bucket_scan_sm90, bucket_scan)``."""
    return _load_sm90(), _load_int8f()


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
            f"the CUDA kernels need d_pad % 16 == 0 and m % {_MT} == 0; got "
            f"d_pad={d_pad}, m={m}"
        )
    q_pad = q.shape[0]
    out = torch.empty((q_pad, m), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (vn.data_ptr(), vb.data_ptr(), q.data_ptr(),
            None if bmap is None else bmap.data_ptr(), out.data_ptr())
    shape = (nb, d_pad, block, m, bits, q_pad, q_tile or q_pad,
             0 if bmap is None else bmap.shape[1], nprobe or 0)
    if vb.dtype == torch.bfloat16:
        plan = scan_plan(q_tile or q_pad, d_pad)
        err = _load_sm90().bucket_scan_sm90_launch(
            *ptrs, *shape, plan.nq, plan.kc, plan.stages, stream)
    else:
        # the int8f kernel's query tile divides q_pad, or q_tile
        lib = _load_int8f()
        qt = cuda_build.pick_qt(
            q_tile or q_pad, lambda qt: lib.bucket_scan_smem_bytes(qt, d_pad))
        err = lib.bucket_scan_launch(*ptrs, *shape[:6], qt, *shape[6:],
                                     stream)
    if err:
        raise RuntimeError(f"bucket_scan launch failed: CUDA error {err}")
    if vb.dtype == torch.bfloat16:
        bucket_scan.LAUNCHES += 1
    else:
        bucket_scan.LAUNCHES_INT8F += 1
    return out


bucket_scan.LAUNCHES = 0
bucket_scan.LAUNCHES_INT8F = 0
