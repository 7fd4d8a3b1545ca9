"""Packed bucketed k-NN scan: the serving path (port of
``vector_database_tpu/ops/pallas_knn.py``).

A database is packed once (``pack_database``): rows are cut into blocks of
``block`` rows, each stored transposed and scaled as ``-2v`` in bf16
(``vb [nb, d_pad, block]``) beside its f32 norm row ``|v|^2``
(``vn [nb, 1, block]``) and per-cell pruning summaries. A serve call runs
the bucketed scan kernel (``ops/bucket_scan.py``): for each query and each
of ``m`` buckets (bucket = column mod m) it keeps the smallest score
``|v|^2 - 2 q.v`` over the streamed blocks, with the winning block's id in
the score's low mantissa bits. The ``k * oversample`` best buckets then
expand to their ``block / m`` candidate rows each, and an exact f32 rerank
of those rows gives the answer.

Two int8 packs halve the blocks' bytes (``dtype=``), with the symmetric
global scale ``sq = 127 / max|v|`` and blocks ``-v*sq`` in int8:
``"int8f"`` keeps the f32 norm row and the summaries and scores through the
same kernel (its int8 instantiation widens the blocks to bf16, queries are
pre-scaled by ``2/sq``); ``"int8"`` stores the integer norm row
``rint(|v|^2 sq^2/2)`` and scores in int32 with int8 queries
(``ops/bucket_scan_i8.py``), the block id in a second accumulator. Its
integer arithmetic is exact in the quantized values only: the scale keeps
255 levels of the range ``[-max|v|, max|v|]``, so rows that use half of it
(non-negative data) keep 128. The wider default shortlist (``oversample``
16) absorbs the quantization.

``"uint8"`` is the lossless int8 pack of rows that are integers in [0,
255] (SIFT-like descriptors): blocks ``v - 128`` over the whole int8
range, no scale and no clamp, beside the exact int32 norm row ``|v -
128|^2``, scored by the same integer kernel as ``vn2 - 2 q'.v'`` with
``q' = q - 128`` (queries rounded and clamped to [0, 255] first). L2
distance does not change under the translation, so its selection is exact
(the score is ``|v - q|^2 - |q'|^2``) and it takes bf16's shortlist of
``k * 4`` buckets. Both integer packs keep their blocks K-major, ``vb [nb,
block, d_pad]`` (the rows as they lie), the operand layout of the int8
tensor cores; the other packs keep the JAX package's ``[nb, d_pad,
block]``.

The block axis of ``vb`` (bf16, int8f) and of ``vn`` lies in rows padded
to a multiple of 16 elements when ``block`` is not one (``pad_rows``), so
that every row starts on the 16-byte boundary the kernels' TMA maps need;
the tensors are views of the first ``block`` columns.

A true neighbor is lost only when a closer true neighbor lands in the same
bucket (expected loss ~(k-1)/(2m) per neighbor) or when bf16 rounding
pushes its bucket below the shortlist cut, which oversampling absorbs.

``probes=`` is the pruned mode: queries are grouped so that each group of
``q_tile`` sorted queries shares one list of ``probes`` blocks, chosen by
cell-centroid distance, and only those blocks stream.

Tombstones: ``PackedDB.mask_rows(alive)`` gives dead rows the 3e38 norm
sentinel (the kernel's padding value), so they never win a bucket, and
``row_mask=`` on the serve call keeps a dead row that shares a winning
bucket out of the rerank. Together they serve an immutable pack with
rows removed, without repacking.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from vector_database_tpu_torch.ops.bucket_scan import (
    bucket_scan,
    pad_rows,
    row_pitch,
)
from vector_database_tpu_torch.ops.bucket_scan_i8 import bucket_scan_i8
from vector_database_tpu_torch.ops.exact import (
    as_f32,
    atleast_2d,
    full_f32,
    normalize_rows,
)
from vector_database_tpu_torch.utils.device import resolve_device
from vector_database_tpu_torch.utils.profiling import (
    COUNTERS,
    span,
    spanned,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# pack forms whose blocks hold one byte an element; those scored in int32
_BYTE_PACKS = ("int8", "int8f", "uint8")
_INTEGER_PACKS = ("int8", "uint8")
# the uint8 pack's offset: v - 128 maps [0, 255] onto int8's whole range
_U8_OFFSET = 128

# The TPU kernels' double-buffered VMEM windows may claim this much; kept
# so that the default block (and with it the bucket layout and results)
# is the same as the JAX package's for every dimensionality.
_VMEM_WINDOW_BUDGET = 40 * 1024 * 1024


def auto_block(
    d: int,
    *,
    d_align: int = 128,
    dtype: str = "bfloat16",
    buckets: int = 4096,
    start: int = 8192,
) -> int:
    """The ``block=None`` default of ``pack_database``: the largest
    power-of-two block (<= ``start``) whose two ``[d_pad, block]`` windows
    fit the TPU kernel's budget at dimensionality ``d`` (8192 up to
    d=640). The port keeps the rule so that default packs bucket alike."""
    itemsize = 1 if dtype in _BYTE_PACKS else 2
    if dtype in _BYTE_PACKS:
        d_align = max(d_align, 32)
    d_pad = _round_up(max(d, 1), d_align)
    block = start
    while block > 512 and 2 * block * (d_pad * itemsize + 4) > \
            _VMEM_WINDOW_BUDGET:
        block //= 2
    if block > buckets and block % buckets:
        block = buckets
    return block


def _to_tensor(x, device):
    """numpy (including ml_dtypes bfloat16) or tensor -> tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


@dataclasses.dataclass
class PackedDB:
    """Database packed for the serving kernel, built once per database.

    ``vectors`` is the original f32 matrix (referenced, not copied) for
    the exact rerank; ``cent``/``rad`` are the per-cell pruning summaries
    (radius -3e38 marks an all-padding cell; None on the integer packs).
    ``dtype`` is the form ``pack_database`` was given: ``"bfloat16"``,
    ``"int8f"``, ``"int8"`` or ``"uint8"``."""

    # [nb, d_pad, block] bf16 -2v (-v for ip) or int8f -v*sq; K-major
    # [nb, block, d_pad]: int8 -v*sq, uint8 v - 128
    vb: torch.Tensor
    # [nb, 1, block] f32 |v|^2 (3e38 pad); int32 (2^30 pad): int8
    # rint(|v|^2 sq^2/2), uint8 |v - 128|^2
    vn: torch.Tensor
    vectors: torch.Tensor  # [N, D] f32
    n: int
    block: int
    m: int
    bits: int
    sq: float = 0.0  # int8 query scale (0.0 on bf16 packs)
    metric: str = "l2"  # "l2" | "cosine" | "ip"
    cent: torch.Tensor | None = None  # [nb * cells, D] f32
    rad: torch.Tensor | None = None  # [nb * cells] f32
    dtype: str = "bfloat16"

    @property
    def device(self) -> torch.device:
        return self.vb.device

    @property
    def integer(self) -> bool:
        """Whether the pack is scored in int32 (``"int8"``, ``"uint8"``):
        K-major blocks, an int32 norm row, no pruning summaries."""
        return self.dtype in _INTEGER_PACKS

    @property
    def d_pad(self) -> int:
        """The padded dimensionality of the blocks."""
        return self.vb.shape[2 if self.integer else 1]

    def mask_rows(self, alive) -> "PackedDB":
        """A new ``PackedDB`` sharing every tensor except the norm row:
        rows where ``alive`` (``[n]`` bool) is False get the 3e38
        sentinel, so they can never win a bucket. Pass the same mask as
        ``row_mask=`` to the serve call. The pruning summaries are shared
        unchanged: dead rows still steer block selection a little until
        the next repack. The integer packs (``"int8"``, ``"uint8"``)
        raise."""
        if self.integer:
            raise ValueError(
                f"mask_rows requires dtype='bfloat16'/'int8f', not "
                f"{self.dtype!r} (an integer norm row has no masked "
                "encoding)"
            )
        alive = torch.as_tensor(alive, device=self.device).bool()
        return dataclasses.replace(self, vn=_mask_vn(self.vn, alive, self.n))

    @classmethod
    def from_numpy(cls, arrays, meta, *, device=None) -> "PackedDB":
        """Pack from numpy buffers ``arrays`` in the JAX package's layout
        (``vb [nb, d_pad, block]``, ``vn``, ``vectors``, optional
        ``cent``/``rad``; ``vb`` may be an ml_dtypes bfloat16 array or
        int8, ``vn`` f32 or int32) and ``meta`` (``n``, ``block``, ``m``,
        ``bits``, optional ``sq`` and ``metric``), on ``device`` (default:
        the card, ``cuda``). The arrays' types give the form (the JAX
        package has no uint8 pack); a pure-int8 pack (int32 ``vn``) is
        transposed once to its K-major ``[nb, block, d_pad]``."""
        device = resolve_device(device)
        opt = {key: _to_tensor(arrays[key], device)
               for key in ("cent", "rad") if arrays.get(key) is not None}
        vb = _to_tensor(arrays["vb"], device)
        vn = _to_tensor(arrays["vn"], device)
        if vn.dtype == torch.int32:
            vb = vb.transpose(1, 2).contiguous()
            form = "int8"
        else:
            vb = pad_rows(vb)
            form = "int8f" if vb.dtype == torch.int8 else "bfloat16"
        return cls(
            vb=vb,
            vn=pad_rows(vn),
            vectors=_to_tensor(arrays["vectors"], device),
            n=int(meta["n"]), block=int(meta["block"]), m=int(meta["m"]),
            bits=int(meta["bits"]), sq=float(meta.get("sq", 0.0)),
            metric=meta.get("metric", "l2"), dtype=form, **opt,
        )


def _mask_vn(vn, alive, n):
    """``vn`` with 3e38 wherever ``alive`` (``[n]``, padded False to the
    pack's rows) is False."""
    nb, _, block = vn.shape
    a = torch.zeros(nb * block, dtype=torch.bool, device=vn.device)
    a[:n] = alive
    return pad_rows(torch.where(a.view(nb, 1, block), vn, 3.0e38))


def _summary_cell(block: int) -> int:
    """Pruning summary granularity: 32 cells per block (cell >= 32 rows,
    clamped for tiny blocks; one cell per block if 32 does not divide)."""
    cell = min(block, max(32, block // 32))
    return block if block % cell else cell


def _cell_summary_body(vblk, rblk, *, cpb, cell):
    """Per-cell ``(centroid, radius)`` of blocks of zeroed rows:
    ``vblk [..., block, d]`` with non-real rows zeroed, ``rblk [...,
    block]`` the real-row mask. Empty cells get radius -3e38 (the
    never-select sentinel)."""
    d = vblk.shape[-1]
    lead = vblk.shape[:-2]
    vc = vblk.reshape(*lead, cpb, cell, d)
    rc = rblk.reshape(*lead, cpb, cell)
    cnt = rc.sum(dim=-1)
    cent = vc.sum(dim=-2) / torch.clamp(cnt, min=1)[..., None]
    diff = vc - cent[..., None, :]
    d2 = torch.where(rc, torch.sum(diff * diff, dim=-1), 0.0)
    rad = torch.sqrt(d2.amax(dim=-1))
    return cent, torch.where(cnt > 0, rad, -3.0e38)


def _bf16_body(blk, real, *, ip):
    """bf16 pack rows: ``-2v`` (``-v`` for ip) in bf16 and the f32 norm
    row, 3e38 at padded/sentinel rows (large finite: +inf would break the
    encode's integer bit operations)."""
    vnb = torch.zeros_like(blk[:, 0]) if ip else torch.sum(blk * blk, dim=1)
    scale = -1.0 if ip else -2.0
    return (scale * blk).to(torch.bfloat16), torch.where(real, vnb, 3.0e38)


def _int8_body(blk, real, *, sq, float_norms):
    """int8 pack rows: ``clip(rint(v * -sq), -127, 127)`` with the f32
    ``-sq`` (as ``jnp`` multiplies by a weakly typed scalar), and either
    the f32 norm row (int8f, 3e38 pad) or ``rint(|v|^2 * sq^2/2)`` in
    int32 (int8, 2^30 pad: above any real row, below the 2^31-1 init)."""
    f32 = dict(dtype=torch.float32, device=blk.device)
    vq = torch.clamp(torch.round(blk * torch.tensor(-sq, **f32)), -127, 127)
    vnb = torch.sum(blk * blk, dim=1)
    if float_norms:
        return vq.to(torch.int8), torch.where(real, vnb, 3.0e38)
    vn2 = torch.round(vnb * torch.tensor(sq * sq * 0.5, **f32))
    return vq.to(torch.int8), torch.where(real, vn2.to(torch.int32), 2 ** 30)


def _uint8_body(blk, real, *, d):
    """uint8 pack rows, from rows of integers in [0, 255]: ``v - 128`` in
    int8 (exact: no scale, no clamp) and the exact int32 norm row ``|v -
    128|^2``; padded rows and columns hold 0, so they add nothing to a
    product, and padded rows' norm is 2^30 (above any real score, below
    the 2^31-1 init)."""
    cols = torch.arange(blk.shape[1], device=blk.device) < d
    keep = real[:, None] & cols[None, :]
    vq = torch.where(keep, blk - _U8_OFFSET, 0.0).to(torch.int8)
    vi = vq.to(torch.int32)
    vn2 = torch.sum(vi * vi, dim=1, dtype=torch.int32)
    return vq, torch.where(real, vn2, 2 ** 30)


def _uint8_rows(vectors) -> bool:
    """Whether every element of ``vectors`` is an integer in [0, 255]
    (NaN and inf are not), read in chunks of rows with one host sync."""
    ok = torch.ones((), dtype=torch.bool, device=vectors.device)
    step = max(1, (1 << 24) // max(1, vectors.shape[1]))
    for r0 in range(0, vectors.shape[0], step):
        x = vectors[r0:r0 + step]
        ok &= torch.all((x >= 0) & (x <= 255) & (x == torch.round(x)))
    return bool(ok)


def _pack_blockwise(vectors, *, block, d_align, n_valid, cell, body,
                    kmajor=False):
    """Pack a chunk of blocks at a time, so no full-size f32 temporary
    lives beside the matrix: zero-pad and zero the rows past ``n_valid``
    (caller padding, possibly +inf), run ``body(rows, real) -> (vb rows,
    vn row)`` and store its rows transposed (as they lie if ``kmajor``),
    and (unless ``cell`` is None) the per-cell pruning summaries. The
    block axis is stored in rows of ``row_pitch(block)`` elements."""
    n, d = vectors.shape
    nv = n if n_valid is None else n_valid
    d_pad = _round_up(d, d_align)
    nb = _round_up(n, block) // block
    dev = vectors.device
    vb = vn = cent = rad = None
    if cell is not None:
        cpb = block // cell
        cent = torch.empty((nb, cpb, d), dtype=torch.float32, device=dev)
        rad = torch.empty((nb, cpb), dtype=torch.float32, device=dev)
    # ~256 MB of f32 temporaries per chunk
    chunk = max(1, (1 << 26) // (block * d_pad))
    for b0 in range(0, nb, chunk):
        b1 = min(nb, b0 + chunk)
        r0, r1 = b0 * block, min(n, b1 * block)
        nblk = b1 - b0
        blk = torch.zeros((nblk * block, d_pad), dtype=torch.float32,
                          device=dev)
        blk[: r1 - r0, :d] = vectors[r0:r1]
        real = torch.arange(r0, r0 + nblk * block, device=dev) < nv
        blk = torch.where(real[:, None], blk, 0.0)
        vbb, vnb = body(blk, real)
        if vb is None:  # the body decides the packed dtypes
            pitch = row_pitch(block)
            vb = torch.empty((nb, block, d_pad) if kmajor else
                             (nb, d_pad, pitch), dtype=vbb.dtype, device=dev)
            vb = vb if kmajor else vb[..., :block]
            vn = torch.empty((nb, 1, pitch), dtype=vnb.dtype,
                             device=dev)[..., :block]
        vn[b0:b1] = vnb.view(nblk, 1, block)
        rows = vbb.view(nblk, block, d_pad)
        vb[b0:b1] = rows if kmajor else rows.transpose(1, 2)
        if cell is not None:
            c, r = _cell_summary_body(
                blk.view(nblk, block, d_pad), real.view(nblk, block),
                cpb=cpb, cell=cell,
            )
            cent[b0:b1] = c[..., :d]
            rad[b0:b1] = r
        del blk
    if cell is None:
        return vb, vn, None, None
    return vb, vn, cent.reshape(nb * cpb, d), rad.reshape(nb * cpb)


@spanned("vdb_torch.pack")
def pack_database(
    vectors,
    *,
    block: int | None = None,
    buckets: int = 4096,
    dtype: str = "bfloat16",
    d_align: int = 128,
    metric: str = "l2",
    rows_valid: int | None = None,
    device=None,
) -> PackedDB:
    """Pack a database for ``pallas_scan_knn_packed``.

    ``buckets`` (m): shortlist buckets across the whole database; expected
    recall@k ~ 1 - (k-1)/(2m) minus bf16 rounding noise. ``block``: rows
    per streamed block, a multiple of ``buckets`` (``None``: ``auto_block``).
    ``d_align``: the packed D axis is padded to this multiple (the CUDA
    kernel takes any multiple of 16). ``metric``: ``"l2"``, ``"cosine"``
    (rows unit-normalized here, queries at serve time) or ``"ip"``
    (maximum inner product: ``-v`` blocks, zero norm row).
    ``rows_valid``: rows past this count are caller padding, excluded from
    bucket selection; they should hold +inf so the rerank never returns
    them. ``dtype``: ``"bfloat16"`` (default); ``"int8"`` (half the
    blocks' bytes, integer selection that is exact in the values
    quantized by one symmetric scale, not in the rows', no pruning);
    ``"int8f"`` (int8 blocks, bf16 scoring, pruning); or ``"uint8"``, for
    rows that are integers in [0, 255] (others raise ``ValueError``):
    ``v - 128`` in int8 blocks, selection exact in the rows themselves, no
    pruning, ``"l2"`` only. The byte packs take no ``rows_valid`` and pad
    D to a multiple of 32; the int8 pair takes ``"l2"``/``"cosine"``.
    """
    vectors = as_f32(vectors, device)
    if metric not in ("l2", "cosine", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    if dtype not in ("bfloat16", "bf16") + _BYTE_PACKS:
        raise ValueError(f"unknown pack dtype: {dtype}")
    dtype = "bfloat16" if dtype == "bf16" else dtype
    n, d = vectors.shape
    if block is None:
        block = auto_block(d, d_align=d_align, dtype=dtype, buckets=buckets)
    if n == 0:
        raise ValueError("pack_database: empty database (0 rows)")
    if rows_valid is None:
        rows_valid = n
    if metric == "cosine":
        if rows_valid < n:
            # normalize only the real rows; keep the +inf sentinels
            vectors = torch.cat(
                [normalize_rows(vectors[:rows_valid]), vectors[rows_valid:]]
            )
        else:
            vectors = normalize_rows(vectors)
    m = min(buckets, block)
    if block % m:
        raise ValueError("block must be a multiple of buckets")
    nb = _round_up(n, block) // block
    bits = max(1, (nb - 1).bit_length())
    if bits > 16:
        raise ValueError(
            "database too large for this block size: raise `block` so "
            "that the number of blocks stays <= 65536"
        )
    n_valid = None if rows_valid == n else rows_valid
    sq = 0.0
    if dtype in _BYTE_PACKS:
        if metric == "ip" or (dtype == "uint8" and metric != "l2"):
            raise ValueError(
                f"metric={metric!r} is not served by dtype={dtype!r}")
        if n_valid is not None:
            raise ValueError(
                f"rows_valid padding requires dtype='bfloat16', not "
                f"{dtype!r} (the sentinel rows have no byte encoding)"
            )
        d_align = max(d_align, 32)  # the int8 MMA's contraction step
    if dtype == "uint8":
        d_pad = _round_up(d, d_align)
        if 3 * _U8_OFFSET ** 2 * d_pad >= 2 ** 30:  # |score| < 2^30 pad
            raise ValueError(
                f"dtype='uint8' needs 3 * 128^2 * d_pad < 2^30; got d_pad "
                f"{d_pad}")
        if not _uint8_rows(vectors):
            raise ValueError(
                "dtype='uint8' requires rows whose every element is an "
                "integer in [0, 255]")
        body = functools.partial(_uint8_body, d=d)
    elif dtype in ("int8", "int8f"):
        sq = 127.0 / max(float(vectors.abs().max()), 1e-30)
        body = functools.partial(_int8_body, sq=sq,
                                 float_norms=dtype == "int8f")
    else:
        body = functools.partial(_bf16_body, ip=metric == "ip")
    # the integer scan has no pruned variant: no summaries; its blocks
    # are K-major
    integer = dtype in _INTEGER_PACKS
    vb, vn, cent, rad = _pack_blockwise(
        vectors, block=block, d_align=d_align, n_valid=n_valid,
        cell=None if integer else _summary_cell(block), body=body,
        kmajor=integer,
    )
    return PackedDB(
        vb=vb, vn=vn, vectors=vectors, n=n, block=block, m=m, bits=bits,
        sq=sq, metric=metric, cent=cent, rad=rad, dtype=dtype,
    )


@spanned("vdb_torch.knn.block_map")
def _block_map(pack: PackedDB, queries, *, q_tile: int, probes: int):
    """Pruned-mode block selection: ``(order, bmap)``. ``order`` sorts the
    queries so tile-mates want the same blocks; ``bmap [tiles, probes]``
    int32 lists each tile's blocks, best first.

    The key of a (query, block) pair is the query's distance to the
    block's nearest cell centroid, from a bf16-input, f32-accumulated dot
    (``|q|^2`` dropped). Every tile member's top-1 block is forced into
    its tile's list. All orderings are stable, so equal keys keep the
    lower index, as ``lax.top_k``/``argsort`` do in the JAX package: the
    first ``p`` entries of a wider map are then the ``probes=p`` map."""
    nb = pack.vb.shape[0]
    q = queries.shape[0]
    q_pad = _round_up(q, q_tile)
    tiles = q_pad // q_tile
    cent, rad = pack.cent, pack.rad
    cpb = cent.shape[0] // nb
    with full_f32():
        dots = queries.to(torch.bfloat16).float() @ \
            cent.to(torch.bfloat16).float().T  # [Q, nc]
    if pack.metric == "ip":
        key = -dots
    else:
        cc = torch.sum(cent * cent, dim=1)
        key = cc[None, :] - 2.0 * dots
    # all-padding cells (radius sentinel) are never selected
    key = torch.where(rad[None, :] < -1e38, float("inf"), key)
    key = key.view(q, nb, cpb).amin(dim=2)  # [Q, nb]
    top1 = torch.argmin(key, dim=1)
    order = torch.argsort(top1, stable=True)
    key_s = torch.full((q_pad, nb), float("inf"), device=key.device)
    key_s[:q] = key[order]  # pad queries never steer selection
    tile_key = key_s.view(tiles, q_tile, nb).amin(dim=1)
    forced = torch.zeros((q_pad, nb), dtype=torch.bool, device=key.device)
    forced[torch.arange(q, device=key.device), top1[order]] = True
    forced = forced.view(tiles, q_tile, nb).any(dim=1)
    tile_key = torch.where(forced, float("-inf"), tile_key)
    bmap = torch.sort(tile_key, dim=1, stable=True).indices[:, :probes]
    return order, bmap.to(torch.int32).contiguous()


def _scan_queries(pack: PackedDB, qp: torch.Tensor) -> torch.Tensor:
    """The scan kernel's query operand from padded f32 queries: bf16 for a
    bf16 pack; ``qp * (2/sq)`` in bf16 for int8f (the blocks hold
    ``-v*sq``, so the dot comes out as ``-2 q.v``); int8
    ``clip(rint(qp * sq), -127, 127)`` for pure int8; for uint8
    ``clip(rint(qp), 0, 255) - 128`` in int8 over the real columns and 0
    past them (on the card, with no host sync). Scales are f32, as ``jnp``
    rounds a weakly typed Python float."""
    if pack.dtype == "bfloat16":
        return qp.to(torch.bfloat16)
    if pack.dtype == "uint8":
        d = pack.vectors.shape[1]
        qi = torch.clamp(torch.round(qp[:, :d]), 0, 255) - _U8_OFFSET
        out = torch.zeros(qp.shape, dtype=torch.int8, device=qp.device)
        out[:, :d] = qi.to(torch.int8)
        return out
    f32 = dict(dtype=torch.float32, device=qp.device)
    if pack.dtype == "int8":
        qi = torch.round(qp * torch.tensor(pack.sq, **f32))
        return torch.clamp(qi, -127, 127).to(torch.int8)
    return (qp * torch.tensor(2.0 / pack.sq, **f32)).to(torch.bfloat16)


@spanned("vdb_torch.knn.shortlist")
def _shortlist_rows(
    pack: PackedDB,
    queries: torch.Tensor,  # [Q, D] float32, already metric-normalized
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
    probes_max: int | None = None,
):
    """Kernel scan + bucket top-k: the ``[Q, k_scan * block/m]`` candidate
    row ids (may include ids >= ``pack.n`` and sentinel rows; the caller's
    exact rerank masks them). Never touches ``pack.vectors``.

    ``probes``: stream only this many blocks per query tile (the pruned
    mode). ``probes_max``: build the map ``min(probes_max, nb)`` wide and
    clip ``probes`` into ``[1, width]`` (the runtime-probes form: the
    result equals the static ``probes`` call)."""
    block, m, bits = pack.block, pack.m, pack.bits
    nb, d_pad = pack.vb.shape[0], pack.d_pad
    q, d = queries.shape
    w = block // m
    if oversample is None:
        # int8 quantization noise is absorbed by a wider shortlist; the
        # uint8 pack selects exactly
        oversample = 16 if pack.dtype in ("int8", "int8f") else 4
    q_pad = _round_up(q, q_tile)
    qp = torch.zeros((q_pad, d_pad), dtype=torch.float32,
                     device=queries.device)
    qp[:q, :d] = queries

    nprobe = None
    if probes_max is not None:
        if probes is None:
            raise ValueError("probes_max requires probes")
        width = min(probes_max, nb)
        nprobe = min(max(int(probes), 1), width)
    elif probes is not None:
        if probes < 1:
            raise ValueError("probes must be >= 1")
        if probes < nb:
            width = nprobe = probes
    inv = bmap = None
    if nprobe is not None:
        if pack.integer:
            raise ValueError(
                f"probes= (block pruning) requires dtype='bfloat16' or "
                f"'int8f', not {pack.dtype!r}: the integer scan has no "
                "pruned variant"
            )
        if pack.cent is None:
            raise ValueError(
                "probes= needs block summaries; this pack was assembled "
                "without them (re-pack with pack_database)"
            )
        order, bmap = _block_map(pack, queries, q_tile=q_tile, probes=width)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(q, device=order.device)
        qp[:q] = qp[:q][order]
    # the k_scan best buckets, stable (lower bucket first on equal
    # scores, as lax.top_k); each carries w = block/m candidate rows
    k_scan = min(k * oversample, m)
    qs = _scan_queries(pack, qp)
    if pack.integer:
        # integer scores; the block ids come from their own output
        with span("vdb_torch.knn.scan"):
            scores, ids = bucket_scan_i8(pack.vn, pack.vb, qs, m=m,
                                         uint8=pack.dtype == "uint8")
        pos = torch.sort(scores[:q], dim=1, stable=True).indices[:, :k_scan]
        blk = ids[:q].gather(1, pos).to(torch.int64)
    else:
        with span("vdb_torch.knn.scan"):
            acc = bucket_scan(
                pack.vn, pack.vb, qs, m=m, bits=bits, bmap=bmap,
                nprobe=nprobe, q_tile=q_tile if bmap is not None else None,
            )
        vals, pos = torch.sort(acc[:q], dim=1, stable=True)
        vals, pos = vals[:, :k_scan], pos[:, :k_scan]
        # the winning block id rides the low mantissa bits of the score
        blk = (vals.view(torch.int32) & ((1 << bits) - 1)).to(torch.int64)
    slices = torch.arange(w, device=pos.device) * m
    rows = (blk[:, :, None] * block + slices[None, None, :]
            + pos[:, :, None]).reshape(q, k_scan * w)
    # pruned mode sorted the queries; undo that on the small row list
    return rows if inv is None else rows[inv]


@spanned("vdb_torch.knn.rerank")
def _rerank(pack: PackedDB, queries, short_rows, *, k: int, row_mask=None):
    """The exact f32 rerank of the shortlist ``short_rows`` ``[Q, S]``:
    ``(rows [Q, k], sq_dists [Q, k])`` as ``pallas_scan_knn_packed``
    returns them. Counts its queries and the shortlist rows it gathers
    (``knn.shortlist_queries``, ``knn.shortlist_rows``)."""
    n = pack.n
    safe = short_rows.clamp(0, n - 1)
    cand = pack.vectors[safe]  # [Q, S, D]
    COUNTERS["knn.shortlist_queries"] += short_rows.shape[0]
    COUNTERS["knn.shortlist_rows"] += short_rows.numel()
    if pack.metric == "ip":
        key = -torch.sum(cand * queries[:, None, :], dim=-1)
    else:
        diff = cand - queries[:, None, :]
        key = torch.sum(diff * diff, dim=-1)
    # exclude index pads and +inf sentinel rows (for ip a sentinel
    # scores -inf/NaN and would win: mask on finiteness)
    key = torch.where((short_rows < n) & torch.isfinite(key), key,
                      float("inf"))
    if row_mask is not None:
        # a dead row sharing a winning bucket must not take a result slot
        row_mask = torch.as_tensor(row_mask, device=pack.device).bool()
        key = torch.where(row_mask[safe], key, float("inf"))
    kk = min(k, short_rows.shape[1])
    out_key, fpos = torch.sort(key, dim=1, stable=True)
    out_key, fpos = out_key[:, :kk], fpos[:, :kk]
    rows = short_rows.gather(1, fpos)
    rows = torch.where(torch.isfinite(out_key), rows, -1)
    if k > kk:
        rows = torch.nn.functional.pad(rows, (0, k - kk), value=-1)
        out_key = torch.nn.functional.pad(out_key, (0, k - kk),
                                          value=float("inf"))
    if pack.metric == "ip":
        return rows, torch.where(torch.isfinite(out_key), -out_key,
                                 float("-inf"))
    return rows, out_key


def pallas_scan_knn_packed(
    pack: PackedDB,
    queries,
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
    probes_max: int | None = None,
    row_mask=None,
):
    """Exact-reranked k-NN over a packed database, full scan or pruned
    with ``probes`` (``probes >= num_blocks`` or None is the full scan):
    ``(rows [Q, k], sq_dists [Q, k])``; for ``metric="ip"`` packs the
    second output is exact dots, highest first. Returned distances are
    exact f32 for whatever rows come back; -1 / +inf pad. ``probes_max``
    (requires ``probes``) selects the runtime-probes form, as
    ``pallas_scan_knn_packed_rt``. ``row_mask``: optional ``[n]`` bool;
    rows where it is False score +inf in the rerank (pair it with
    ``PackedDB.mask_rows``)."""
    queries = atleast_2d(as_f32(queries, pack.device))
    if pack.metric == "cosine":
        queries = normalize_rows(queries)
    short_rows = _shortlist_rows(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes, probes_max=probes_max,
    )
    return _rerank(pack, queries, short_rows, k=k, row_mask=row_mask)


def pallas_scan_knn_packed_rt(
    pack: PackedDB,
    queries,
    probes: int,
    *,
    k: int,
    probes_max: int,
    q_tile: int = 256,
    oversample: int | None = None,
    row_mask=None,
):
    """Runtime-probes pruned serving: like ``pallas_scan_knn_packed(
    probes=p)`` with ``p`` clipped into ``[1, min(probes_max, nb)]``; the
    block map is built ``min(probes_max, nb)`` wide and the kernel walks
    its first ``p`` entries, so results equal the static call's bit for
    bit."""
    return pallas_scan_knn_packed(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes, probes_max=probes_max, row_mask=row_mask,
    )


def pallas_scan_knn_candidates(
    pack: PackedDB,
    queries,
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
):
    """Bucket-shortlist candidate row ids without the rerank:
    ``[Q, k_scan * block/m]``, possibly including ids >= ``pack.n`` and
    sentinel rows (the caller's rerank must mask both)."""
    queries = atleast_2d(as_f32(queries, pack.device))
    if pack.metric == "cosine":
        queries = normalize_rows(queries)
    return _shortlist_rows(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes,
    )


def calibrate_probes(
    pack: PackedDB,
    sample_queries,
    k: int,
    target_recall: float = 0.95,
    *,
    q_tile: int = 256,
    oversample: int | None = None,
    probes_max: int | None = None,
) -> int:
    """Smallest ``probes`` whose recall@k on ``sample_queries`` (against
    this pack's own full scan) meets ``target_recall``: a binary search
    over the block count through the runtime-probes path. ``probes_max``
    caps the search; if even the cap misses the target, the cap is
    returned."""
    q = atleast_2d(as_f32(sample_queries, pack.device))
    nb = pack.vb.shape[0]
    if nb <= 1 or target_recall <= 0:
        return nb
    pmax = nb if probes_max is None else min(probes_max, nb)
    full, _ = pallas_scan_knn_packed(
        pack, q, k=k, q_tile=q_tile, oversample=oversample
    )
    want = [set(r) - {-1} for r in full.cpu().tolist()]
    denom = max(1, sum(len(w) for w in want))
    seen: dict[int, float] = {}

    def recall_at(p: int) -> float:
        if p not in seen:
            rows, _ = pallas_scan_knn_packed_rt(
                pack, q, p, k=k, probes_max=pmax, q_tile=q_tile,
                oversample=oversample,
            )
            hits = sum(len(set(r) & w)
                       for r, w in zip(rows.cpu().tolist(), want))
            seen[p] = hits / denom
        return seen[p]

    lo, hi = 1, pmax  # recall_at(nb) == 1.0 by construction
    if pmax < nb and recall_at(pmax) < target_recall:
        return pmax
    while lo < hi:
        mid = (lo + hi) // 2
        if recall_at(mid) >= target_recall:
            hi = mid
        else:
            lo = mid + 1
    return lo


def pallas_scan_knn(
    vectors,
    queries,
    *,
    k: int,
    block: int | None = None,
    q_tile: int = 256,
    buckets: int = 4096,
    oversample: int | None = None,
    probes: int | None = None,
    dtype: str = "bfloat16",
    metric: str = "l2",
    device=None,
):
    """One-shot convenience: pack + serve. For steady-state serving call
    ``pack_database`` once and ``pallas_scan_knn_packed`` per batch."""
    pack = pack_database(
        vectors, block=block, buckets=buckets, dtype=dtype, metric=metric,
        device=device,
    )
    return pallas_scan_knn_packed(
        pack, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes,
    )
