"""The bucketed scan kernels: wrappers, plain version, launch counts.

``bucket_scan`` computes what the three float-scoring Pallas kernels of
``vector_database_tpu/ops/pallas_knn.py`` compute (``_kernel`` :130,
``_kernel_pruned`` :203, ``_kernel_pruned_rt`` :274): for every query row
and bucket ``c < m`` the minimum over the streamed blocks of
``enc(min_j(vn[b, j*m+c] + q . vb[b, :, j*m+c]), b)``, where ``enc``
replaces the score's low ``bits`` bits with the block id. ``vb`` is bf16
(bf16 packs) or int8 (int8f packs, widened to bf16 in the kernel).

On a CUDA tensor the wrapper launches ``csrc/bucket_scan_sm90.cu`` (TMA
ring, ``wgmma``, 256-row query tiles, on the skeleton of
``csrc/sm90.cuh``; one instantiation per element size), building it with
``nvcc`` at first use, or raises. Its shapes come from ``scan_plan``; the
source's header says what bounds it on an H100. It takes any ``m`` that
divides ``block`` (a tail CTA covers a partial 64-column tile) and blocks
whose rows start on 16-byte boundaries (``row_stride``; ``pad_rows`` and
``pack_database`` lay them out so). A TMA box must start on a 16-byte
boundary too, so where a block's slices do not (``slices_aligned``: m =
125 in blocks of 1000, say) the wrapper scans a copy laid out in slices
of ``row_pitch(m)`` columns (``pad_slices``). On a CPU tensor the wrapper runs
``bucket_scan_reference``, the plain torch loop with the same arguments.
``utils/profiling.COUNTERS`` counts the launches on bf16 blocks
(``scan.launches.bf16``) and on int8 blocks (``scan.launches.int8f``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.utils.profiling import COUNTERS

MAX_STAGES = 8  # vb tiles in flight in the kernel's ring
MIN_STAGES = 4
# the largest contraction chunk per element size: an int8 stage's A
# fragments live in registers, kc / 4 of them a thread (32 at 128)
_KC_MAX = {2: 256, 1: 128}
# elements a row stride is a multiple of, so that rows of 1-, 2- and
# 4-byte elements all start on the 16-byte boundaries TMA requires
_ROW_ALIGN = 16
_MAX_GRID_Y = 65535  # CTAs along the grid's bucket axis


class ScanPlan(NamedTuple):
    """The scan kernel's tiling: ``nq`` query rows per consumer warpgroup
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


def _smem_bytes(nq: int, d_pad: int, kc: int, stages: int, esize: int = 2,
                qn_tile: bool = False, qsize: int = 2) -> int:
    """``smem_bytes`` of ``csrc/sm90.cuh``: 1024 bytes of alignment slack,
    the query tile of ``qsize``-byte elements in boxes of 128-byte rows
    (64 bf16 or 128 int8 columns), the ring of ``kc x 64`` tiles of
    ``esize``-byte elements, the probe's ``[2 nq]`` f32 query norms
    (``qn_tile``), each stage's 64 4-byte norms, and the ring's full/empty
    barriers plus the query tile's."""
    rows = 2 * nq
    return (1024 + -(-d_pad // (128 // qsize)) * rows * 128
            + stages * kc * 64 * esize + (rows * 4 if qn_tile else 0)
            + stages * 64 * 4 + (2 * stages + 1) * 8)


def fit_plan(rows: int, d_pad: int, kcs, esize: int = 2,
             qn_tile: bool = False, qsize: int = 2) -> ScanPlan:
    """The skeleton's plan for query groups of ``rows`` rows: the fewest of
    32/64/128/256 query rows a CTA that cover a group (256 at most: a
    staged tile then feeds 256 rows), fewer only where the query tile and
    a ring of at least ``MIN_STAGES`` tiles would not fit the block's
    shared memory; the first chunk of ``kcs`` (largest first) that leaves
    room for that ring; as many stages as fit, up to ``MAX_STAGES``.
    Raises ``ValueError`` if nothing fits."""
    nq = 16
    while nq < 128 and 2 * nq < rows:
        nq *= 2
    while nq >= 16:
        for kc in kcs:
            fixed = _smem_bytes(nq, d_pad, kc, 0, esize, qn_tile, qsize)
            per = _smem_bytes(nq, d_pad, kc, 1, esize, qn_tile, qsize) - fixed
            stages = min(MAX_STAGES, (cuda_build.SMEM_LIMIT - fixed) // per)
            if stages >= MIN_STAGES:
                return ScanPlan(nq, kc, stages, _smem_bytes(
                    nq, d_pad, kc, stages, esize, qn_tile, qsize))
        nq //= 2
    raise ValueError(
        f"d_pad={d_pad} is too wide for the scan kernel: no query tile of "
        f">= 32 rows and a ring of {MIN_STAGES} tiles fit "
        f"{cuda_build.SMEM_LIMIT} bytes of shared memory"
    )


def scan_plan(rows: int, d_pad: int, esize: int = 2,
              qn_tile: bool = False) -> ScanPlan:
    """The kernel's plan for query groups of ``rows`` rows (the block
    map's ``q_tile``, or ``q_pad`` for a full scan) at ``d_pad``, for vb
    elements of ``esize`` bytes (2 bf16, 1 int8); ``qn_tile`` adds the A/B
    probe's query norms, which it keeps beside the query tile.

    A CTA takes the fewest of 32/64/128/256 query rows that cover a group
    (256 at most: a staged tile then feeds 256 rows), fewer only where the
    query tile and a ring of at least ``MIN_STAGES`` tiles would not fit
    the block's shared memory; ``kc`` is the largest power of two from 16 to
    256 (128 for int8) dividing ``d_pad`` that leaves room for that ring (a
    power of two: the kernel is compiled for each, so its wgmmas unroll).
    Raises ``ValueError`` for shapes the kernel cannot take."""
    if rows < 1:
        raise ValueError(f"scan_plan: rows must be >= 1; got {rows}")
    if d_pad < 16 or d_pad % 16:
        raise ValueError(
            f"the scan kernel needs d_pad % 16 == 0; got d_pad={d_pad}")
    kcs = [kc for kc in (256, 128, 64, 32, 16)
           if d_pad % kc == 0 and kc <= _KC_MAX[esize]]
    return fit_plan(rows, d_pad, kcs, esize, qn_tile)


def check_kernel_shape(d_pad: int, m: int) -> None:
    """The shapes the kernels on the sm90 skeleton take
    (``bucket_scan_sm90.cu``, ``bucket_scan_i8.cu`` and the A/B probe's
    ``probe_kernel_ab.cu``): whole 16-deep K steps, and any bucket count
    the grid's bucket axis holds (``ceil(m / 64)`` CTAs; a tail CTA
    covers a partial 64-column tile). Raises ``ValueError`` otherwise
    (the plain versions take any shape)."""
    if d_pad % 16:
        raise ValueError(
            f"the sm90 scan kernels need d_pad % 16 == 0; got d_pad={d_pad}")
    if not 1 <= -(-m // 64) <= _MAX_GRID_Y:
        raise ValueError(f"the sm90 scan kernels take 1 <= m <= "
                         f"{64 * _MAX_GRID_Y}; got m={m}")


def row_pitch(width: int) -> int:
    """The storage row length, in elements, that ``pad_rows`` gives rows
    of ``width`` elements."""
    return -(-width // _ROW_ALIGN) * _ROW_ALIGN


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (``[..., width]``) with rows the kernels' TMA maps read:
    ``x`` itself if it is contiguous with ``width`` a multiple of 16, else
    a copy in storage whose rows are ``row_pitch(width)`` elements long,
    as a view of the first ``width`` columns (the padding is never
    read)."""
    width = x.shape[-1]
    if row_pitch(width) == width and x.is_contiguous():
        return x
    out = torch.empty((*x.shape[:-1], row_pitch(width)), dtype=x.dtype,
                      device=x.device)
    out[..., :width] = x
    return out[..., :width]


def row_stride(x: torch.Tensor) -> int:
    """The stride, in elements, between the rows of ``x`` (``[nb, rows,
    width]``: a pack's blocks, or its norm rows with ``rows`` 1) as a
    kernel's TMA map reads them: each row contiguous, the rows of a block
    evenly spaced and the blocks ``rows`` row strides apart, with the
    start and every row on a 16-byte boundary (TMA's rule for all but the
    innermost stride). Raises ``ValueError`` otherwise: ``pad_rows`` gives
    any tensor such rows."""
    nb, rows, width = x.shape
    ld = x.stride(0) // rows
    if not ((x.stride(2) == 1 or width == 1)
            and (rows == 1 or x.stride(1) == ld)
            and x.stride(0) == rows * ld and ld >= width
            and ld * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0):
        raise ValueError(
            f"the kernels read rows that start on 16-byte boundaries; got a "
            f"{tuple(x.shape)} {x.dtype} tensor with strides {x.stride()} "
            f"(pad_rows lays it out so)")
    return ld


def slices_aligned(m: int, block: int, *esizes: int) -> bool:
    """Whether every slice of a block (``block // m`` of ``m`` columns)
    starts on a 16-byte boundary in rows of each of ``esizes``-byte
    elements laid along the block axis (the MN-major blocks, the 4-byte
    norms): the kernels' TMA boxes start at a slice's columns, and a box
    that starts off such a boundary faults on the card (an illegal
    instruction). A lone slice (``m == block``) starts at 0."""
    return m == block or all(m * e % 16 == 0 for e in esizes)


def pad_slices(x: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    """``x`` with its block axis ``axis`` (``w`` slices of ``m`` columns)
    re-laid as ``w`` slices of ``row_pitch(m)`` columns, the new columns
    zero: every slice then starts on a 16-byte boundary. A scan of the
    result at ``m = row_pitch(m)`` gives every bucket below ``m`` the
    values it has in ``x``, slice by slice, so its first ``m`` columns
    are the scan of ``x``."""
    w = x.shape[axis] // m
    pad = [0, 0] * (x.dim() - axis - 1) + [0, row_pitch(m) - m]
    return torch.nn.functional.pad(
        x.unflatten(axis, (w, m)), pad).flatten(axis, axis + 1)


def _declare(lib):
    lib.bucket_scan_sm90_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    )
    lib.bucket_scan_sm90_launch.restype = ctypes.c_int
    lib.bucket_scan_sm90_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.bucket_scan_sm90_smem_bytes.restype = ctypes.c_size_t


def _load():
    return cuda_build.load("bucket_scan_sm90", _declare)


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
    dense = [q] + ([] if bmap is None else [bmap])
    if any(x.device != q.device for x in [vn, vb, *dense]) or \
            not all(x.is_contiguous() for x in dense):
        raise ValueError("bucket_scan: inputs must lie on one device, q and "
                         "bmap contiguous")
    nb, d_pad, block = vb.shape
    check_kernel_shape(d_pad, m)
    esize = vb.element_size()
    if not slices_aligned(m, block, esize, 4):
        return bucket_scan(
            pad_slices(vn, m, 2), pad_slices(vb, m, 2), q, m=row_pitch(m),
            bits=bits, bmap=bmap, nprobe=nprobe, q_tile=q_tile,
        )[:, :m].contiguous()
    ld_vb, ld_vn = row_stride(vb), row_stride(vn)
    q_pad = q.shape[0]
    plan = scan_plan(q_tile or q_pad, d_pad, esize)
    out = torch.empty((q_pad, m), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (vn.data_ptr(), vb.data_ptr(), q.data_ptr(),
            None if bmap is None else bmap.data_ptr(), out.data_ptr())
    shape = (nb, d_pad, block, ld_vb, ld_vn, m, bits, q_pad, q_tile or q_pad,
             0 if bmap is None else bmap.shape[1], nprobe or 0)
    err = _load().bucket_scan_sm90_launch(
        *ptrs, *shape, plan.nq, plan.kc, plan.stages, esize, stream)
    if err:
        raise RuntimeError(f"bucket_scan launch failed: CUDA error {err}")
    COUNTERS["scan.launches.bf16" if esize == 2
             else "scan.launches.int8f"] += 1
    return out
