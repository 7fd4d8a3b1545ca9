"""Sharded packed-scan serving (port of
``vector_database_tpu/parallel/scan.py``).

The database rows are cut into one contiguous block per rank of
``mesh[axis]``, and each rank packs its block once with the port's own
``pack_database`` (rows past its real ones are +inf padding, kept out of
bucket selection by ``rows_valid``). A query batch goes to every rank;
each runs the single-device serving path on its block (the scan kernel
``ops/bucket_scan.py``, bucket top-k, exact f32 rerank, local top-k), maps
its rows to global ids, and one all-gather top-k (``merge_topk``) gives
every rank the global answer: the only cross-rank traffic, ``P * Q * k``
entries.

Exactness matches the single-device path: every member of the global
top-k is in its own rank's top-k. With one rank the path is the
single-device path, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d
from vector_database_tpu_torch.ops.packed_knn import (
    PackedDB,
    _round_up,
    _to_tensor,
    pack_database,
    pallas_scan_knn_packed,
)
from vector_database_tpu_torch.parallel.forest import merge_topk
from vector_database_tpu_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    mesh_device,
    shard_bounds,
)


@dataclasses.dataclass
class ShardedPackedDB:
    """A database row-sharded over ``mesh[axis]``, packed per rank; the
    part one rank holds. ``vb``/``vn`` are this rank's blocks and norm
    rows (``PackedDB``'s layout), ``vectors`` its f32 rerank rows (+inf
    past its real rows), ``orig_row`` the global id of each local row (-1
    padding), ``cent``/``rad`` its pruning summaries. JAX stacks these
    into ``[P, ...]``; rank ``p`` holds row ``p``."""

    vb: torch.Tensor  # [nb_loc, d_pad, block] bf16
    vn: torch.Tensor  # [nb_loc, 1, block] f32
    vectors: torch.Tensor  # [n_loc, D] f32, +inf pad rows
    orig_row: torch.Tensor  # [n_loc] int32 global rows, -1 pad
    n: int  # global row count
    n_loc: int  # rows per rank (uniform)
    block: int
    m: int
    bits: int
    metric: str
    mesh: DeviceMesh
    axis: str
    cent: torch.Tensor | None = None  # [nc, D] f32
    rad: torch.Tensor | None = None  # [nc] f32

    @property
    def num_shards(self) -> int:
        return axis_size(self.mesh, self.axis)

    @property
    def device(self) -> torch.device:
        return self.vb.device

    @property
    def local(self) -> PackedDB:
        """This rank's block as a single-device pack (sharing tensors)."""
        return PackedDB(
            vb=self.vb, vn=self.vn, vectors=self.vectors, n=self.n_loc,
            block=self.block, m=self.m, bits=self.bits, sq=0.0,
            metric=self.metric, cent=self.cent, rad=self.rad,
        )

    @classmethod
    def from_numpy(cls, arrays, meta, mesh: DeviceMesh, *,
                   axis: str = "data") -> "ShardedPackedDB":
        """This rank's part of a JAX ``ShardedPackedDB`` from its ``[P,
        ...]`` arrays as numpy (``vb`` ml_dtypes bfloat16, ``vn``,
        ``vectors``, ``orig_row``, optional ``cent``/``rad``) and ``meta``
        (``n``, ``n_loc``, ``block``, ``m``, ``bits``, ``metric``): rank
        ``p`` takes shard ``p``, on the mesh's device."""
        p, shards = axis_rank(mesh, axis), axis_size(mesh, axis)
        if np.asarray(arrays["vn"]).shape[0] != shards:
            raise ValueError("the pack was sharded over another number of "
                             "devices")
        local = PackedDB.from_numpy(
            {key: np.asarray(arrays[key])[p]
             for key in ("vb", "vn", "vectors", "cent", "rad")
             if arrays.get(key) is not None},
            dict(meta, n=meta["n_loc"]), device=mesh_device(mesh))
        return cls(
            vb=local.vb, vn=local.vn, vectors=local.vectors,
            orig_row=_to_tensor(np.asarray(arrays["orig_row"])[p],
                                local.device),
            n=int(meta["n"]), n_loc=int(meta["n_loc"]), block=local.block,
            m=local.m, bits=local.bits, metric=local.metric, mesh=mesh,
            axis=axis, cent=local.cent, rad=local.rad,
        )


def pack_database_sharded(
    vectors,
    mesh: DeviceMesh,
    *,
    axis: str = "data",
    block: int = 8192,
    buckets: int = 4096,
    d_align: int = 128,
    metric: str = "l2",
    orig_rows=None,
    donate: bool = False,
) -> ShardedPackedDB:
    """Cut ``vectors`` into ``mesh[axis]`` contiguous blocks of
    ``ceil(n / P)`` rows and pack this rank's once; every rank calls it
    with the whole matrix (host or tensor) and reads only its rows.

    ``orig_rows`` maps input rows to external ids (default ``arange(n)``;
    a ``BSPIndex``'s ``orig_row`` when serving a leaf-major matrix).
    ``buckets``/``block``/``d_align``/``metric`` as in ``pack_database``;
    bf16 blocks only, as in JAX. A rank with no real rows (``n < P``)
    packs one block of padding. ``donate``: accepted for the JAX
    signature; the caller frees its matrix by dropping it.
    """
    del donate
    if metric not in ("l2", "cosine", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    n, d = vectors.shape
    if n == 0:
        raise ValueError("pack_database_sharded: empty database (0 rows)")
    m = min(buckets, block)
    if block % m:
        raise ValueError("block must be a multiple of buckets")
    shards = axis_size(mesh, axis)
    lo, hi, n_loc = shard_bounds(n, shards, axis_rank(mesh, axis))
    nb = _round_up(n_loc, block) // block
    if max(1, (nb - 1).bit_length()) > 16:
        raise ValueError(
            "shard too large for this block size: raise `block` so the "
            "per-shard block count stays <= 65536"
        )
    dev = mesh_device(mesh)
    if orig_rows is None:
        orig = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    else:
        orig = torch.as_tensor(
            orig_rows[lo:hi] if isinstance(orig_rows, torch.Tensor)
            else np.asarray(orig_rows, np.int32)[lo:hi],
            device=dev).to(torch.int32)
    rows = as_f32(vectors[lo:hi], dev)
    if hi - lo < n_loc:  # +inf padding past this rank's real rows
        orig = torch.cat([orig, torch.full((n_loc - (hi - lo),), -1,
                                           dtype=torch.int32, device=dev)])
        rows = torch.cat([rows, torch.full((n_loc - (hi - lo), d),
                                           float("inf"), device=dev)])
    pack = pack_database(rows, block=block, buckets=buckets,
                         d_align=d_align, metric=metric, rows_valid=hi - lo)
    return ShardedPackedDB(
        vb=pack.vb, vn=pack.vn, vectors=pack.vectors, orig_row=orig, n=n,
        n_loc=n_loc, block=block, m=pack.m, bits=pack.bits, metric=metric,
        mesh=mesh, axis=axis, cent=pack.cent, rad=pack.rad,
    )


def sharded_scan_knn(
    db: ShardedPackedDB,
    queries,
    *,
    k: int,
    q_tile: int = 256,
    oversample: int | None = None,
    probes: int | None = None,
    probes_max: int | None = None,
):
    """k-NN over the sharded pack: every rank scans its block against the
    whole batch, and one all-gather top-k merges the ``[Q, k]`` lists; a
    collective. Returns ``(rows [Q, k], sq_dists)`` with global ids on
    every rank (``metric="ip"``: exact dots, highest first).

    ``probes``: the pruned scan per rank, that many of its own blocks per
    query tile (``>=`` its block count is the full scan). ``probes_max``:
    ``probes`` becomes a runtime value in ``[1, probes_max]``, bitwise
    equal to the static call."""
    queries = atleast_2d(as_f32(queries, db.device))
    if probes_max is not None and probes is None:
        raise ValueError("probes_max requires probes")
    rows, key = pallas_scan_knn_packed(
        db.local, queries, k=k, q_tile=q_tile, oversample=oversample,
        probes=probes, probes_max=probes_max,
    )
    if db.metric == "ip":
        # merge ascending on -dot; padding -inf dots -> +inf keys
        key = torch.where(torch.isfinite(key), -key, float("inf"))
    grows = torch.where(
        rows >= 0, db.orig_row[rows.clamp(0, db.n_loc - 1)].to(rows.dtype),
        -1)
    rows, key = merge_topk(grows, key, k=k, mesh=db.mesh, axis=db.axis)
    if db.metric == "ip":
        return rows, torch.where(torch.isfinite(key), -key, float("-inf"))
    return rows, key


def calibrate_probes_sharded(
    db: ShardedPackedDB,
    sample_queries,
    k: int,
    target_recall: float = 0.95,
    *,
    q_tile: int = 256,
    oversample: int | None = None,
    probes_max: int | None = None,
) -> int:
    """Smallest per-rank ``probes`` whose recall@k on ``sample_queries``
    (against this sharded pack's own full scan) meets ``target_recall``:
    a binary search through the runtime-probes path; a collective. The
    merged results are the same on every rank, so every rank takes the
    same steps and returns the same value. ``probes_max`` caps the search
    (default: the rank's block count, as in JAX: the block map sorts all
    blocks whatever the cap, so a tighter default would save nothing)."""
    q = atleast_2d(as_f32(sample_queries, db.device))
    nb_loc = db.vb.shape[0]
    if nb_loc <= 1 or target_recall <= 0:
        return nb_loc
    pmax = nb_loc if probes_max is None else min(probes_max, nb_loc)
    full, _ = sharded_scan_knn(db, q, k=k, q_tile=q_tile,
                               oversample=oversample)
    want = [set(r) - {-1} for r in full.cpu().tolist()]
    denom = max(1, sum(len(w) for w in want))
    seen: dict[int, float] = {}

    def recall_at(p: int) -> float:
        if p not in seen:
            rows, _ = sharded_scan_knn(
                db, q, k=k, q_tile=q_tile, oversample=oversample,
                probes=p, probes_max=pmax,
            )
            seen[p] = sum(len(set(r) & w) for r, w in
                          zip(rows.cpu().tolist(), want)) / denom
        return seen[p]

    lo, hi = 1, pmax
    if pmax < nb_loc and recall_at(pmax) < target_recall:
        return pmax
    while lo < hi:
        mid = (lo + hi) // 2
        if recall_at(mid) >= target_recall:
            hi = mid
        else:
            lo = mid + 1
    return lo

