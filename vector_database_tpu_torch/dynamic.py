"""Mutable index: an immutable BSP main segment plus a delta (port of
``vector_database_tpu/dynamic.py``).

- The **main** segment is a ``BSPIndex`` with a tombstone mask: removals
  hide rows and never restructure the tree.
- **Adds** go to a delta of rows searched exactly and merged per batch.
- When the delta plus the tombstones pass ``rebuild_fraction`` of the
  main segment, ``compact()`` rebuilds the tree over the live rows.

Ids are stable integers assigned at insert. Host-facing methods take
numpy arrays or tensors and return numpy arrays, as the JAX class does;
every tensor lives on the index's ``device``.

Differences from the JAX class, none of which changes a result: the
delta is a list of row chunks (one per ``add``), not a list of rows, so a
10M-row constructor holds one chunk; and ``compact`` gathers the live
main rows on the device, where the JAX class pulled the main matrix to
the host once per compaction epoch. One difference changes ties only:
the delta merge runs on the device and keeps the earlier add on equal
distances, where the JAX class's host partial sort (numpy's introselect)
keeps arbitrary rows on a tie at the k-th distance and may list equal
distances out of add order.

On the card the delta's k best come from one hand-written kernel
(``csrc/delta_knn.cu``, ``delta_knn``): the exact f32 difference-form
distances and a tie-exact top-k, one pass a 128 places, with no
``[Q, R]`` matrix in device memory, for any ``k``. On the CPU the plain
version ``delta_knn_reference`` runs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from vector_database_tpu_torch.builder import build_index_fused
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.ops.exact import (
    as_f32,
    atleast_2d,
    exact_sq_dists,
    to_numpy,
)
from vector_database_tpu_torch.ops.packed_knn import (
    pack_database,
    pallas_scan_knn_packed,
)
from vector_database_tpu_torch.ops.scan_knn import _lowest_k, scan_knn
from vector_database_tpu_torch.search import search as bsp_search
from vector_database_tpu_torch.utils.device import resolve_device
from vector_database_tpu_torch.utils.profiling import COUNTERS, span, spanned


def exact_d2_blocked(queries, vectors: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[Q, N]`` on the vectors' device by the tree
    rerank's direct difference form, so exact fallbacks agree with the
    tree on boundary rows; in blocks of at least 1,024 rows, whose
    ``[Q, block, D]`` transient stays near 256 MB where ``Q`` allows."""
    q = atleast_2d(as_f32(queries, vectors.device))
    nq, d = q.shape
    n = vectors.shape[0]
    block = max(1024, (1 << 28) // max(1, nq * d * 4))
    if n <= block:
        return exact_sq_dists(q, vectors)
    return torch.cat([
        exact_sq_dists(q, vectors[s : s + block])
        for s in range(0, n, block)
    ], dim=1)


def delta_knn_reference(queries, delta, live, k: int):
    """Plain version of ``delta_knn``: ``exact_d2_blocked`` over every
    slot, +inf where ``live`` is False, then ``scan_knn._lowest_k``. Its
    places past the live rows hold +inf with the lowest dead slots."""
    mask = torch.as_tensor(live, device=delta.device)
    d2 = torch.where(mask, exact_d2_blocked(queries, delta), float("inf"))
    return _lowest_k(d2, min(k, delta.shape[0]))


def _declare_delta_knn(lib):
    lib.delta_knn_scratch.argtypes = [ctypes.c_int] * 3
    lib.delta_knn_scratch.restype = ctypes.c_longlong
    lib.delta_knn_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_void_p])
    lib.delta_knn_launch.restype = ctypes.c_int


def _load_delta_knn():
    return cuda_build.load("delta_knn", _declare_delta_knn)


def delta_knn(queries: torch.Tensor, delta: torch.Tensor, live, k: int):
    """The ``k`` nearest live rows of ``delta`` to each query: ``(d2
    [Q, kk], slots [Q, kk])``, kk = min(k, R), f32 squared distances and
    int64 rows of ``delta``, ascending by (distance, slot): equal
    distances keep the lower slot, also on a tie at the k-th place.

    ``queries`` [Q, D] and ``delta`` [R, D] are float32 on one device;
    ``live`` is an [R] bool mask on the host. Each distance is the f32
    difference form, a subtraction and a square added a dimension, in
    ascending order.

    On a CUDA device this launches ``csrc/delta_knn.cu`` (built with
    ``nvcc`` at first use), for any ``k``: places past the live rows hold
    (+inf, -1), and ``COUNTERS["dynamic.delta_knn.launches"]`` counts its
    kernels: two a pass of up to 128 places, the pass over the split rows
    and the join of the splits. On the CPU ``delta_knn_reference``
    runs."""
    if not (isinstance(queries, torch.Tensor)
            and isinstance(delta, torch.Tensor)):
        raise TypeError("delta_knn: queries and delta must be tensors")
    if queries.dim() != 2 or delta.dim() != 2 or \
            queries.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("delta_knn: queries [Q, D] and delta [R, D] must "
                         "be float32 matrices")
    if queries.shape[1] != delta.shape[1]:
        raise ValueError(f"delta_knn: queries have {queries.shape[1]} "
                         f"dimensions, the delta {delta.shape[1]}")
    if queries.device != delta.device:
        raise ValueError(f"delta_knn: queries on {queries.device}, the "
                         f"delta on {delta.device}")
    live = np.asarray(live)
    if live.dtype != np.bool_ or live.shape != (delta.shape[0],):
        raise ValueError(f"delta_knn: live must be a ({delta.shape[0]},) "
                         f"bool mask, got {live.dtype} {live.shape}")
    if k < 1:
        raise ValueError(f"delta_knn: k must be >= 1, got {k}")
    kk = min(k, delta.shape[0])
    dev = delta.device
    if dev.type != "cuda":
        return delta_knn_reference(queries, delta, live, kk)
    nq, d = queries.shape
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=dev)
    out_s = torch.empty((nq, kk), dtype=torch.int64, device=dev)
    if nq == 0:
        return out_d, out_s
    if d == 0:  # every distance 0, as over one zero column
        queries, delta = (queries.new_zeros((nq, 1)),
                          delta.new_zeros((delta.shape[0], 1)))
    queries, delta = queries.contiguous(), delta.contiguous()
    slots = torch.from_numpy(np.flatnonzero(live).astype(np.int32)).to(dev)
    lib = _load_delta_knn()
    with torch.cuda.device(dev):
        places = lib.delta_knn_scratch(nq, slots.shape[0], kk)
        if places < 0:
            raise RuntimeError(f"delta_knn: CUDA error {-places}")
        part_d = torch.empty(places, dtype=torch.float32, device=dev)
        part_s = torch.empty(places, dtype=torch.int32, device=dev)
        n = lib.delta_knn_launch(
            queries.data_ptr(), delta.data_ptr(), slots.data_ptr(), nq,
            queries.shape[1], slots.shape[0], kk, out_d.data_ptr(),
            out_s.data_ptr(), part_d.data_ptr(), part_s.data_ptr(), places,
            torch.cuda.current_stream(dev).cuda_stream)
    if n < 0:
        raise RuntimeError(f"delta_knn launch failed: CUDA error {-n}")
    COUNTERS["dynamic.delta_knn.launches"] += n
    return out_d, out_s


class DynamicIndex:
    """Mutable exact epsilon-ball / k-NN index with stable integer ids.

    ``device``: where the index's tensors live (default: the device of a
    ``vectors`` tensor, else the card, ``cuda``)."""

    def __init__(
        self,
        vectors=None,
        *,
        leaf_size: int = 8,
        rebuild_fraction: float = 0.25,
        device=None,
    ):
        self._device = resolve_device(device, vectors)
        self._leaf_size = leaf_size
        self._rebuild_fraction = rebuild_fraction
        self._next_id = 0
        self._index = None  # main BSPIndex
        self._main_ids = np.zeros((0,), np.int64)  # external id per input row
        self._main_alive = np.zeros((0,), bool)
        self._delta_vecs: list[torch.Tensor] = []  # row chunks on device
        self._delta_ids: list[np.ndarray] = []  # their ids
        self._dims: Optional[int] = None
        # serving caches: the main segment and the delta are served as
        # separate parts and merged per batch, so an add never touches
        # the main view or its pack
        self._serve = None  # (main matrix, aligned ids, alive mask|None)
        self._delta_cache = None  # (padded delta matrix|None, padded ids)
        self._packed = None  # (main-view identity, PackedDB, pack ids)
        self._packed_base = None  # (index identity, unmasked PackedDB)
        self._epoch = None  # (index identity, leaf-major ids, row of id)
        if vectors is not None:
            self.add(vectors)
            if self._delta_vecs:  # add's threshold may have compacted
                self.compact()

    def _delta_size(self) -> int:
        return sum(ids.size for ids in self._delta_ids)

    def _keep_delta(self, keep: np.ndarray) -> None:
        """Keep the delta rows where ``keep`` (over the concatenated
        delta) is True."""
        mat = torch.cat(self._delta_vecs)
        ids = np.concatenate(self._delta_ids)
        if keep.any():
            self._delta_vecs = [mat[torch.from_numpy(keep).to(mat.device)]]
            self._delta_ids = [ids[keep]]
        else:
            self._delta_vecs, self._delta_ids = [], []
        self._invalidate_delta()

    def _live_parts(self):
        """Live rows of main + delta for ``compact``: ``(device row
        blocks, id arrays)``, the live main rows in leaf-major order (the
        JAX class's order, so both build the same tree), then the delta
        chunks."""
        parts_v, parts_i = [], []
        if self._index is not None and self._main_alive.any():
            orig = to_numpy(self._index.orig_row)
            if self._main_alive.all():
                parts_v.append(self._index.vectors)
                parts_i.append(self._main_ids[orig])
            else:
                keep = self._main_alive[orig]
                parts_v.append(self._index.vectors[
                    torch.from_numpy(keep).to(self._device)])
                parts_i.append(self._main_ids[orig[keep]])
        parts_v.extend(self._delta_vecs)
        parts_i.extend(self._delta_ids)
        return parts_v, parts_i

    def _main_view(self):
        """Device view of the main segment: ``(matrix, aligned external
        ids, alive row mask | None)``. The matrix is the builder's
        leaf-major ``index.vectors`` itself, never a copy; tombstones
        ride along as an ``[N]`` bool mask folded into the scan. Cached
        until a mutation touches the main segment (remove/compact)."""
        if self._serve is None:
            COUNTERS["dynamic.main_views"] += 1
            with span("vdb_torch.dynamic.main_view"):
                self._serve = self._build_main_view()
        return self._serve

    def _build_main_view(self):
        if self._index is None or not self._main_alive.any():
            return (None, np.zeros((0,), np.int64), None)
        mask = (
            None if self._main_alive.all()
            else torch.from_numpy(self._main_alive).to(self._device)[
                self._index.orig_row]
        )
        return (self._index.vectors, self._epoch_maps()[1], mask)

    def _epoch_maps(self):
        """Per compaction epoch (keyed by the main index): the external id
        of each leaf-major row, and the main row of each external id (-1
        for an id not in the main segment), so that a removal costs a
        lookup of its ids and a new main view a gather of the alive mask on
        the device, not a pass over every main row on the host."""
        if self._epoch is None or self._epoch[0] is not self._index:
            ids = self._main_ids
            row_of = np.full(int(ids.max()) + 1 if ids.size else 0, -1,
                             np.int64)
            row_of[ids] = np.arange(ids.size)
            leaf_ids = (ids if self._index is None
                        else ids[to_numpy(self._index.orig_row)])
            self._epoch = (self._index, leaf_ids, row_of)
        return self._epoch

    def _delta_view(self):
        """Device view of the delta rows: ``(matrix | None, ids)``, the
        row count padded up to a power-of-two capacity (>= 64; padding
        rows carry id -1 and are masked after the distance pass), so the
        per-batch merge sees few distinct shapes as the delta grows."""
        if self._delta_cache is None:
            with span("vdb_torch.dynamic.delta_view"):
                self._delta_cache = self._build_delta_view()
        return self._delta_cache

    def _build_delta_view(self):
        nd = self._delta_size()
        if not nd:
            return (None, np.zeros((0,), np.int64))
        cap = 64
        while cap < nd:
            cap *= 2
        mat = torch.zeros((cap, self._dims), dtype=torch.float32,
                          device=self._device)
        mat[:nd] = torch.cat(self._delta_vecs)
        ids = np.full((cap,), -1, np.int64)
        ids[:nd] = np.concatenate(self._delta_ids)
        return (mat, ids)

    def _invalidate_main(self) -> None:
        """Drop the main view and its (possibly masked) pack."""
        self._serve = None
        self._packed = None

    def _invalidate_delta(self) -> None:
        self._delta_cache = None

    def _invalidate_serve(self) -> None:
        self._invalidate_main()
        self._invalidate_delta()

    # --- size ---------------------------------------------------------
    def __len__(self) -> int:
        return int(self._main_alive.sum()) + self._delta_size()

    @property
    def dims(self) -> Optional[int]:
        return self._dims

    # --- mutation -----------------------------------------------------
    @spanned("vdb_torch.dynamic.add")
    def add(self, vectors) -> np.ndarray:
        """Insert rows; returns their assigned external ids."""
        vectors = as_f32(vectors, self._device)
        if vectors.dim() <= 1 and vectors.numel() == 0:
            # [] must not become one zero-width row that fixes dims at 0
            return np.zeros((0,), np.int64)
        vectors = atleast_2d(vectors)
        if self._dims is None:
            self._dims = vectors.shape[1]
        elif vectors.shape[1] != self._dims:
            raise ValueError("invalid vector size")
        ids = np.arange(
            self._next_id, self._next_id + vectors.shape[0], dtype=np.int64
        )
        self._next_id += vectors.shape[0]
        if ids.size:
            # a copy: the caller may reuse its buffer for the next add
            self._delta_vecs.append(vectors.clone())
            self._delta_ids.append(ids)
            COUNTERS["dynamic.rows_added"] += ids.size
        # adds touch only the delta: the main view and its pack stay valid
        self._invalidate_delta()
        self._maybe_compact()
        return ids

    @spanned("vdb_torch.dynamic.remove")
    def remove(self, vector, radius: float) -> int:
        """Remove every row within ``radius`` of ``vector``; returns the
        number removed."""
        removed = 0
        r2 = np.float32(radius) ** 2
        if self._index is not None:
            res = bsp_search(self._index, vector, radius)
            if bool(res.overflow[0]):
                # the walk's candidate buffer capped out: a truncated
                # answer would leave in-radius rows alive, so scan exactly
                d2 = to_numpy(
                    exact_d2_blocked(vector, self._index.vectors))[0]
                rows = to_numpy(self._index.orig_row)[d2 <= r2]
            else:
                rows = to_numpy(res.rows[0])
                rows = rows[rows >= 0]
            hit = rows[self._main_alive[rows]]
            self._main_alive[hit] = False
            removed += hit.size
            if hit.size:
                self._invalidate_main()
        if self._delta_vecs:
            v = atleast_2d(as_f32(vector, self._device))
            mat = torch.cat(self._delta_vecs)
            # f32 radius square, like the compare on the main segment
            keep = to_numpy(torch.sum((mat - v) ** 2, dim=1)) > r2
            if not keep.all():
                removed += int((~keep).sum())
                self._keep_delta(keep)
        COUNTERS["dynamic.rows_removed"] += removed
        self._maybe_compact()
        return removed

    @spanned("vdb_torch.dynamic.remove")
    def remove_ids(self, ids) -> int:
        """Remove rows by external id; returns the number removed."""
        ids = np.unique(np.atleast_1d(to_numpy(ids)).astype(np.int64))
        row_of = self._epoch_maps()[2]
        rows = row_of[ids[(ids >= 0) & (ids < row_of.size)]]
        rows = rows[rows >= 0]
        hit = rows[self._main_alive[rows]]
        self._main_alive[hit] = False
        removed = int(hit.size)
        if removed:
            self._invalidate_main()
        if self._delta_vecs:
            keep = ~np.isin(np.concatenate(self._delta_ids), ids)
            if not keep.all():
                removed += int((~keep).sum())
                self._keep_delta(keep)
        COUNTERS["dynamic.rows_removed"] += removed
        self._maybe_compact()
        return removed

    # --- queries --------------------------------------------------------
    def search(self, queries, radius: float):
        """Exact epsilon-ball search: per query ``(ids, sq_dists)``."""
        queries = atleast_2d(as_f32(queries, self._device))
        nq = queries.shape[0]
        r2 = np.float32(radius) ** 2
        out = [([], []) for _ in range(nq)]
        if self._index is not None:
            res = bsp_search(self._index, queries, radius)
            ovf = to_numpy(res.overflow)
            res_rows, res_d2 = to_numpy(res.rows), to_numpy(res.sq_dists)
            # overflowed queries would silently lose matches: re-answer
            # those few with one exact scan over the main segment
            sub_pos = {}
            if ovf.any():
                sub = np.nonzero(ovf)[0]
                exact_d2 = to_numpy(exact_d2_blocked(
                    queries[torch.from_numpy(sub).to(self._device)],
                    self._index.vectors,
                ))
                orig = to_numpy(self._index.orig_row)
                sub_pos = {int(q): j for j, q in enumerate(sub)}
            for qi in range(nq):
                if qi in sub_pos:
                    d2 = exact_d2[sub_pos[qi]]
                    m = d2 <= r2
                    rows, d2 = orig[m], d2[m]
                else:
                    keep = res_rows[qi] >= 0
                    rows, d2 = res_rows[qi][keep], res_d2[qi][keep]
                alive = self._main_alive[rows]
                out[qi][0].extend(self._main_ids[rows[alive]].tolist())
                out[qi][1].extend(d2[alive].tolist())
        if self._delta_vecs:
            d2 = to_numpy(
                exact_d2_blocked(queries, torch.cat(self._delta_vecs)))
            dids = np.concatenate(self._delta_ids)
            for qi in range(nq):
                hit = d2[qi] <= r2
                out[qi][0].extend(dids[hit].tolist())
                out[qi][1].extend(d2[qi][hit].tolist())
        return [
            (np.asarray(i, np.int64), np.asarray(d, np.float32))
            for i, d in out
        ]

    @spanned("vdb_torch.dynamic.knn")
    def knn(self, queries, k: int, radius: Optional[float] = None,
            *, exact: Optional[bool] = None, allowed_ids=None,
            packed: bool = False, probes: Optional[int] = None,
            min_probe_batch: Optional[int] = None,
            q_tile: int = 256, oversample: Optional[int] = None):
        """k nearest neighbors (within ``radius`` if given): ``(ids
        [Q, k], sq_dists [Q, k])`` numpy arrays, -1 / +inf padding.

        The main segment is served by one streaming scan with the
        tombstones folded in; the delta rows are merged exactly on top
        (``merge_delta``). ``exact=True`` (default) is the precise scan;
        ``exact=False`` the bf16 bucketed scan with an exact rerank.
        ``allowed_ids``: restrict results to these ids (the mask rides
        the scan).

        ``packed=True`` serves the main segment through the packed scan
        kernel: the base pack is built once per compaction epoch, a
        removal epoch only rebuilds its norm row (``mask_rows``), and an
        add never invalidates it. ``probes=`` adds block pruning. Not
        combinable with ``allowed_ids`` or an explicit ``exact=True``
        (raises).

        Pruning is a batch mode: probes tuned at a large batch lose
        recall on small ones. ``min_probe_batch`` serves calls with fewer
        queries by the full packed scan. Its default is None, as in the
        JAX package and the port's ``PackedServer``: the right floor
        depends on the batch the probes were calibrated at, which only
        the caller knows."""
        q = atleast_2d(as_f32(queries, self._device))
        nq = q.shape[0]
        if min_probe_batch is not None and probes is None:
            raise ValueError(
                "min_probe_batch only applies to pruned serving; set "
                "probes= as well"
            )
        if (probes is not None and min_probe_batch is not None
                and nq < min_probe_batch):
            probes = None  # under-filled batch: serve the full scan
        if packed:
            if allowed_ids is not None:
                raise ValueError(
                    "packed=True has no filtered path; use the default "
                    "exact scan for allowed_ids= serving"
                )
            if exact:
                raise ValueError(
                    "packed=True serves the bf16 bucketed-scan accuracy "
                    "model and cannot honor exact=True; drop one of them"
                )
        view = self._main_view()
        mat, main_ids, alive_mask = view
        allowed = None if allowed_ids is None else to_numpy(allowed_ids)
        if mat is not None:
            if packed:
                if self._packed is None or self._packed[0] is not view:
                    with span("vdb_torch.dynamic.main_view"):
                        self._packed = self._pack_view(view)
                ids_map = self._packed[2]
                kk = min(k, ids_map.size)
                rows, d2 = pallas_scan_knn_packed(
                    self._packed[1], q, k=kk, q_tile=q_tile,
                    oversample=oversample, probes=probes,
                    row_mask=alive_mask,
                )
            else:
                ids_map = main_ids
                kk = min(k, ids_map.size)
                row_mask = alive_mask
                if allowed is not None:
                    amask = torch.from_numpy(
                        np.isin(main_ids, allowed)).to(self._device)
                    row_mask = amask if row_mask is None else row_mask & amask
                rows, d2 = scan_knn(
                    mat, q, k=kk, precise=True if exact is None else exact,
                    row_mask=row_mask,
                )
            rows, d2 = to_numpy(rows), to_numpy(d2)
            ids = np.where(rows >= 0, ids_map[np.clip(rows, 0, None)], -1)
            # masked rows score +inf; when k exceeds the live count they
            # can still fill slots, so never surface their ids
            ids = np.where(np.isfinite(d2), ids, -1)
            if kk < k:
                ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
                d2 = np.pad(d2, ((0, 0), (0, k - kk)),
                            constant_values=np.inf)
        else:
            ids = np.full((nq, k), -1, np.int64)
            d2 = np.full((nq, k), np.inf, np.float32)
        ids, d2 = self.merge_delta(q, ids, d2, k, allowed=allowed)
        if radius is not None:
            hit = d2 <= radius * radius
            ids = np.where(hit, ids, -1)
            d2 = np.where(hit, d2, np.inf).astype(np.float32)
        return ids, d2

    def _pack_view(self, view):
        """``(view, PackedDB, ids)`` of a main view. A new main view is a
        new epoch. The base pack is built once per compaction epoch and
        survives removals: a tombstone epoch only masks its norm row."""
        mat, main_ids, alive_mask = view
        if (self._packed_base is None
                or self._packed_base[0] is not self._index):
            self._packed_base = (self._index, pack_database(mat))
        base = self._packed_base[1]
        return (view, base if alive_mask is None
                else base.mask_rows(alive_mask), main_ids)

    @spanned("vdb_torch.dynamic.merge")
    def merge_delta(self, queries, ids, d2, k: int, *, allowed=None):
        """Merge the delta rows into a main-segment top-k ``(ids [Q, k],
        d2 [Q, k])``, on the index's device: the live delta rows' ``k``
        best by exact f32 distances (``delta_knn``; equal distances keep
        the earlier add), then one stable sort of main and delta
        together, so main rows lead delta rows on equal distances. Only
        the merged ``[Q, k]`` comes back to the host. Delta results are
        exact in every serving mode."""
        dmat, dids = self._delta_view()
        if dmat is None:
            return ids, d2
        dev = dmat.device
        live = dids >= 0
        if allowed is not None:
            live &= np.isin(dids, allowed)
        COUNTERS["dynamic.delta_rows"] += int(live.sum())
        COUNTERS["dynamic.delta_slots"] += dids.size
        dd2, pos = delta_knn(atleast_2d(as_f32(queries, dev)), dmat, live, k)
        cat_d = torch.cat([
            torch.as_tensor(d2, dtype=torch.float32, device=dev), dd2], 1)
        # the kernel's empty places (+inf) hold slot -1; +inf gives id -1
        cat_i = torch.cat([
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            torch.from_numpy(dids).to(dev)[pos.clamp(min=0)]], 1)
        d2, order = torch.sort(cat_d, dim=1, stable=True)
        d2 = d2[:, :k]
        ids = torch.where(torch.isfinite(d2), cat_i.gather(1, order[:, :k]),
                          -1)
        return to_numpy(ids), to_numpy(d2)

    # --- maintenance ----------------------------------------------------
    def _maybe_compact(self) -> None:
        main = max(1, self._main_ids.size)
        dead = main - int(self._main_alive.sum())
        churn = (self._delta_size() + dead) / main
        if churn > self._rebuild_fraction and len(self) > 0:
            self.compact()

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint in the JAX package's format: compacts, then writes
        ``state.npz`` and ``index.npz``."""
        self.compact()
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "state.npz"),
            main_ids=self._main_ids,
            next_id=np.int64(self._next_id),
            leaf_size=np.int64(self._leaf_size),
            rebuild_fraction=np.float64(self._rebuild_fraction),
            dims=np.int64(self._dims if self._dims is not None else -1),
            has_index=np.bool_(self._index is not None),
        )
        if self._index is not None:
            self._index.save(os.path.join(path, "index"))

    @classmethod
    def load(cls, path: str, *, device=None) -> "DynamicIndex":
        """Load a checkpoint written by either package's ``save``, onto
        ``device`` (default: the card, ``cuda``)."""
        with np.load(os.path.join(path, "state.npz")) as z:
            out = cls(
                leaf_size=int(z["leaf_size"]),
                rebuild_fraction=float(z["rebuild_fraction"]),
                device=device,
            )
            out._next_id = int(z["next_id"])
            dims = int(z["dims"])
            out._dims = dims if dims >= 0 else None
            out._main_ids = z["main_ids"]
            has_index = bool(z["has_index"])
        out._main_alive = np.ones(out._main_ids.size, bool)
        if has_index:
            out._index = BSPIndex.load(os.path.join(path, "index.npz"),
                                       device=out._device)
        return out

    @spanned("vdb_torch.dynamic.compact")
    def compact(self) -> None:
        """Rebuild the main tree over all live rows and clear the delta;
        a no-op when already compact (empty delta, no tombstones)."""
        if (
            not self._delta_vecs
            and self._index is not None
            and self._main_alive.all()
        ):
            return
        COUNTERS["dynamic.compactions"] += 1
        self._invalidate_serve()
        parts_v, parts_i = self._live_parts()
        self._delta_vecs, self._delta_ids = [], []
        if not parts_v:
            self._index = None
            self._main_ids = np.zeros((0,), np.int64)
            self._main_alive = np.zeros((0,), bool)
            return
        vecs = parts_v[0] if len(parts_v) == 1 else torch.cat(parts_v)
        ids = np.concatenate(parts_i)
        self._index = build_index_fused(vecs, leaf_size=self._leaf_size)
        self._packed_base = None  # the old matrix's pack
        # ids are indexed by input row, which search results return
        self._main_ids = ids
        self._main_alive = np.ones(ids.size, bool)
